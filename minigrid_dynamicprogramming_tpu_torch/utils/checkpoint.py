"""Checkpoint and resume.

Counterpart of ``minigrid_dynamicprogramming_tpu/utils/checkpoint.py``,
where every part of a run is a pytree of arrays and one orbax save holds
it.  Here a run's state holds objects as well: a PPO ``TrainState`` has a
module, an optimizer and ``torch.Generator``s beside its tensors.
:func:`save` writes a tree of them as plain data (tensors on the CPU,
state dicts, generator states, dicts and lists, numbers) through
``torch.save``; :func:`restore` loads it with ``weights_only=True`` (no
pickled code) into the structure of a target of the same kind, each
tensor on its target's device, each module, optimizer and generator
loaded in place.  A ``TrainState`` so keeps its model, optimizer, env
state, pool and both generator states.

With ``env_state``, :func:`save` also writes the ``state_hash`` digests of
its first slots to ``framework_meta.json``; :func:`restore` recomputes
them from the restored tree and raises on a mismatch.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Optional

import torch

from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.utils.debug import state_hash

DATA = "checkpoint.pt"
META = "framework_meta.json"


def _digests(env_state: EnvState, n: int = 4) -> list:
    """State digests of the first ``n`` env slots of a batch."""
    return [state_hash(env_state, i) for i in range(min(n, env_state.agent_dir.shape[0]))]


def _is_record(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_plain(tree):
    """``tree`` as data ``torch.load(weights_only=True)`` reads back."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (torch.nn.Module, torch.optim.Optimizer)):
        return to_plain(tree.state_dict())
    if isinstance(tree, torch.Generator):
        return tree.get_state()
    if isinstance(tree, dict):
        return {k: to_plain(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: to_plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if _is_record(tree):
        return {k: to_plain(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, (list, tuple)):
        return [to_plain(v) for v in tree]
    return tree


def from_plain(target, data):
    """``data`` (from :func:`to_plain`) in the structure of ``target``."""
    if isinstance(target, torch.Tensor):
        if data.shape != target.shape or data.dtype != target.dtype:
            raise ValueError(
                f"checkpoint tensor {data.dtype} {tuple(data.shape)} does not fit "
                f"{target.dtype} {tuple(target.shape)}"
            )
        return data.to(target.device)
    if isinstance(target, (torch.nn.Module, torch.optim.Optimizer)):
        # An optimizer moves its state to its parameters' devices.
        target.load_state_dict(data)
        return target
    if isinstance(target, torch.Generator):
        target.set_state(data)
        return target
    if isinstance(target, dict):
        return {k: from_plain(v, data[k]) for k, v in target.items()}
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return type(target)(
            **{f.name: from_plain(getattr(target, f.name), data[f.name]) for f in dataclasses.fields(target)}
        )
    if _is_record(target):
        return type(target)(*(from_plain(v, data[k]) for k, v in zip(target._fields, target)))
    if isinstance(target, (list, tuple)):
        return type(target)(from_plain(v, d) for v, d in zip(target, data))
    return data


def save(path: str, tree: Any, env_state: Optional[EnvState] = None) -> dict:
    """Write ``tree`` to the directory ``path``; returns the metadata
    written beside it (the digests of ``env_state``'s first slots)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    meta = {}
    if env_state is not None:
        meta["env_digests"] = _digests(env_state)
    torch.save(to_plain(tree), os.path.join(path, DATA))
    if meta:
        with open(os.path.join(path, META), "w") as f:
            json.dump(meta, f)
    return meta


def restore(
    path: str,
    target: Any,
    env_state_of: Optional[Callable[[Any], EnvState]] = None,
    verify: bool = True,
):
    """The checkpoint at ``path`` in the structure of ``target`` (whose
    modules, optimizers and generators are loaded in place).  With
    ``verify``, the digests of ``env_state_of(restored)`` must equal the
    saved ones, or this raises ``ValueError``."""
    path = os.path.abspath(path)
    restored = from_plain(target, torch.load(os.path.join(path, DATA), weights_only=True))
    meta_path = os.path.join(path, META)
    if verify and env_state_of is not None and os.path.exists(meta_path):
        with open(meta_path) as f:
            want = json.load(f).get("env_digests", [])
        got = _digests(env_state_of(restored))
        if want and got != want:
            raise ValueError(f"checkpoint integrity check failed: digests {got} != {want}")
    return restored
