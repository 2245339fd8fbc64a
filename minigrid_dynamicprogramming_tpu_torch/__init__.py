"""PyTorch/CUDA port of the Minigrid framework with batched exact DP.

The JAX package ``minigrid_dynamicprogramming_tpu`` beside this one is the
reference; this package imports only ``torch`` and ``numpy`` (never JAX or
the JAX package) and keeps the reference's module layout so each part has
an obvious counterpart:

* ``core/``      integer codes, state records, missions, and the
  ``Environment`` record with its batch-first ``reset``/``step``/
  ``observation``;
* ``ops/``       batched grid and RoomGrid builders, the lane-major hook
  toolkit, the view helpers of batch-first states (``ops/obs.py``);
* ``envs/``      the layout generators and step hooks of every MiniGrid
  family, and the BabyAI levels and verifier (``envs/babyai/``);
* ``registry.py`` all 171 ids;
* ``parallel/lanes.py``  the batch-last step, observation and rollout;
* ``dp/``        exact value iteration, with hand-written CUDA kernels in
  ``dp/cuda_vi.py`` (sources under ``csrc/``);
* ``models/``    the actor-critic network and the PPO learner;
* ``render/``    RGB frames and agent views from a tile table, on the
  state's device;
* ``wrappers/``  the 15 observation, action and reward wrappers;
* ``parallel/sharding.py``, ``distributed.py``, ``scaling.py``  a
  ``torch.distributed`` process group over devices, each rank a slice of
  the env axis, and the scaling harness;
* ``utils/``     the BabyAI bot, the ASCII printer and state digest,
  checkpoints, guards, generator telemetry, tracing;
* ``benchmark.py``  the micro-benchmark CLI (reset ms, render FPS,
  agent-view FPS, batched env-steps/s, ``--dp`` value iteration);
* ``manual_control.py``, ``docs_gen.py``  keyboard control of one env, and
  the environment pages and GIFs;
* ``bridge.py``  numpy-dict converters to and from the JAX state pytrees,
  and the actor-critic's flax parameters.

Entry points that make tensors from a seed (``lane_rollout``, an env's
``generate`` and ``reset``, a wrapper's ``reset``, ``dp.tabular.solve``,
``models.PPO``, ``benchmark.benchmark`` and ``benchmark_dp``,
``parallel.scaling.measure_scaling``, ``utils.telemetry.
generation_acceptance``, ``manual_control``, ``docs_gen``) default to
``device="cuda"`` and raise when CUDA is absent unless the caller asks
for ``"cpu"``; ``parallel.distributed.global_env_group`` puts a rank on
``cuda:{local rank}`` unless asked otherwise; the renderer and the
wrappers' steps follow the device of the state they are given.
"""

__version__ = "0.1.0"

from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvParams, EnvState
from minigrid_dynamicprogramming_tpu_torch.registry import make, register, registered_ids

__all__ = [
    "Environment",
    "EnvParams",
    "EnvState",
    "make",
    "register",
    "registered_ids",
    "__version__",
]
