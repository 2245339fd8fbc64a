"""Carry state, layouts and network weights across from the JAX package,
as numpy dicts.

The JAX side turns its pytrees into plain dicts of numpy arrays
(``{name: np.asarray(leaf)}``), so this module never touches JAX.
``from_numpy`` builds any of the port's records from such a dict:

* a batch-first :class:`~.core.state.EnvState` (leading batch axis);
* a lane-major :class:`~.parallel.lanes.LaneState`, or a pool of them with
  a leading rounds axis;
* a :class:`~.dp.tabular.TabularLayout` or
  :class:`~.dp.tabular_key.KeyTabularLayout` (leading batch axis).

Unsigned dtypes that PyTorch cannot compute with on the CPU are widened on
the way in (uint16 -> int32, uint32 -> int64) and ``to_numpy`` narrows the
marks planes back to uint16 on the way out.  The JAX states' per-env
``rng`` key has no counterpart in the port and is dropped.

``actor_critic_from_flax`` turns the flax ``ActorCritic``'s parameter tree
(nested dicts of numpy arrays) into a ``state_dict`` of the port's
:class:`~.models.nets.ActorCritic`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Type, TypeVar

import numpy as np
import torch

T = TypeVar("T")

# Fields of the JAX records that the port leaves out.
DROPPED = frozenset({"rng"})
# Port fields stored widened, with their JAX dtype.
_NARROW = {
    "marks": np.uint16,
    "vmarks": np.uint16,
    "carrying_marks": np.uint16,
}
_WIDEN = {np.dtype(np.uint16): np.int32, np.dtype(np.uint32): np.int64}


def from_numpy(cls: Type[T], arrays: Mapping[str, np.ndarray], device) -> T:
    """Build the port record ``cls`` from a dict of numpy arrays on
    ``device``.  Every field of ``cls`` must be present; keys that are not
    fields of ``cls`` may only be the dropped ones (``rng``)."""
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(arrays)
    extra = set(arrays) - set(names) - DROPPED
    if missing or extra:
        raise ValueError(
            f"{cls.__name__}: missing fields {sorted(missing)}, "
            f"unknown fields {sorted(extra)}"
        )
    out = {}
    for name in names:
        a = np.asarray(arrays[name])
        a = np.array(a, dtype=_WIDEN.get(a.dtype, a.dtype))  # a writable copy
        out[name] = torch.from_numpy(a).to(device)
    return cls(**out)


def to_numpy(record) -> dict:
    """The port record as a dict of numpy arrays in the JAX dtypes."""
    out = {}
    for f in dataclasses.fields(record):
        a = getattr(record, f.name).detach().cpu().numpy()
        if f.name in _NARROW:
            a = a.astype(_NARROW[f.name])
        out[f.name] = a
    return out


def actor_critic_from_flax(params: Mapping) -> dict:
    """The flax ``ActorCritic``'s parameters (the variables dict, or its
    ``"params"`` entry, leaves numpy arrays) as the port's ``state_dict``:
    conv kernels HWIO -> OIHW, dense kernels ``(in, out)`` -> ``(out, in)``,
    embedding tables and ``code_pos`` as they are."""
    params = params.get("params", params)
    enc = params["ObsEncoder_0"]

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {}

    def dense(name: str, p: Mapping) -> None:
        out[f"{name}.weight"] = t(p["kernel"]).T.contiguous()
        out[f"{name}.bias"] = t(p["bias"])

    for name in ("plane_embed_0", "plane_embed_1", "plane_embed_2", "dir_embed", "code_embed"):
        out[f"encoder.{name}.weight"] = t(enc[name]["embedding"])
    i = 0
    while f"conv_{i}" in enc:
        out[f"encoder.convs.{i}.weight"] = t(enc[f"conv_{i}"]["kernel"]).permute(3, 2, 0, 1).contiguous()
        out[f"encoder.convs.{i}.bias"] = t(enc[f"conv_{i}"]["bias"])
        i += 1
    out["encoder.code_pos"] = t(enc["code_pos"])
    dense("encoder.trunk", enc["trunk"])
    dense("policy_head", params["policy_head"])
    dense("value_head", params["value_head"])
    return out
