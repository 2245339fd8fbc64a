"""What a CUDA graph capture refuses, checked on the CPU.

On a CUDA device the port captures a step (the rollout's ``_Scan.step``,
PPO's collector and minibatch steps) as a CUDA graph and replays it; a
capture refuses a step that reads a value back to the host, makes a
tensor of data-dependent shape, or copies host data onto the device.
Here there is no card, so the tests run such a step under
:class:`NoHostReads`, a dispatch mode that raises on each of those
operators: ``data_dependent_output`` and ``dynamic_output_shape`` tags,
boolean-mask indexing, ``lift_fresh`` (a tensor made from Python
data), and ``multinomial``, whose one-sample path on a CUDA device reads
a check of its input back to the host.  It sees each operator whole, so
it cannot see another host read inside one operator's own implementation
on the card.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_ATEN = torch.ops.aten
_HOST_DATA = {_ATEN.lift_fresh.default, _ATEN.lift_fresh_copy.default}
_MASK_INDEX = {_ATEN.index.Tensor, _ATEN.index_put.default, _ATEN.index_put_.default}
_READS_ON_CARD = {_ATEN.multinomial.default}


class NoHostReads(TorchDispatchMode):
    """Raises on an operator that a CUDA graph capture would refuse,
    except inside :meth:`unchecked`."""

    def __init__(self):
        super().__init__()
        self._unchecked = 0

    @contextmanager
    def unchecked(self):
        """Operators here pass unchecked: a part that runs another way
        on the card than on the CPU."""
        self._unchecked += 1
        try:
            yield
        finally:
            self._unchecked -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        tags = set(func.tags)
        bad = not self._unchecked and (
            torch.Tag.data_dependent_output in tags
            or torch.Tag.dynamic_output_shape in tags
            or func in _HOST_DATA
            or func in _READS_ON_CARD
            or (
                func in _MASK_INDEX
                and any(
                    i is not None and i.dtype == torch.bool for i in args[1]
                )
            )
        )
        if bad:
            raise AssertionError(f"the step calls {func}")
        return func(*args, **(kwargs or {}))
