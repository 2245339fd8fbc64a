"""PyTorch/CUDA port of the Minigrid framework with batched exact DP.

The JAX package ``minigrid_dynamicprogramming_tpu`` beside this one is the
reference; this package imports only ``torch`` and ``numpy`` (never JAX or
the JAX package) and keeps the reference's module layout so each part has
an obvious counterpart:

* ``core/``      integer codes, state records, the ``Environment`` record;
* ``ops/``       batched grid builders and the success reward;
* ``envs/``      layout generators (DoorKey);
* ``parallel/lanes.py``  the batch-last step, observation and rollout;
* ``dp/``        exact value iteration, with hand-written CUDA kernels in
  ``dp/cuda_vi.py`` (sources under ``csrc/``);
* ``bridge.py``  numpy-dict converters to and from the JAX state pytrees.

Entry points that make tensors from a seed (``lane_rollout``, an env's
``generate``, ``dp.tabular.solve``) default to ``device="cuda"`` and raise
when CUDA is absent unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"

from minigrid_dynamicprogramming_tpu_torch.registry import make, registered_ids

__all__ = ["make", "registered_ids", "__version__"]
