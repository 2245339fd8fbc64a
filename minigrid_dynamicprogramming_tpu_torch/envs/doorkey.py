"""DoorKey: a random vertical wall with a locked yellow door; the yellow key
and the agent start left of the wall, the goal sits bottom-right.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/doorkey.py`` with the
same draw ranges, generated for a whole batch at once.

On a CUDA device :func:`generate` makes the plain generator's five draws,
in its order, and turns them into the batch's layouts with one launch of
``csrc/doorkey_gen.cu`` (:func:`layouts_kernel`); on any other device it
is :func:`generate_plain`, the kernel's plain twin.  Both give the same
layouts, bit for bit, from the same generator state, and leave the
generator in the same state.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from minigrid_dynamicprogramming_tpu_torch import _kernels
from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREEN,
    COLOR_GREY,
    COLOR_YELLOW,
    OBJ_DOOR,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_WALL,
    STATE_LOCKED,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    AUX_SLOTS,
    MISSION_SLOTS,
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

MISSION = "use the key to open the door and then get to the goal"


def generate_plain(
    generator: torch.Generator,
    p: EnvParams,
    batch_size: int,
    device="cuda",
) -> EnvState:
    """The generator in plain PyTorch over ``ops/grid.py``, on any device."""
    dev = resolve_device(device)
    b, w, h = batch_size, p.width, p.height
    state = new_state(b, h, w, dev)
    state = G.wall_rect(state, 0, 0, w, h)
    state = G.put_obj(state, w - 2, h - 2, OBJ_GOAL, COLOR_GREEN)

    # Vertical splitting wall at split_idx in [2, width-2).
    split_idx = torch.randint(
        2, w - 2, (b,), generator=generator, device=dev, dtype=torch.int32
    )
    state = G.paint(
        state,
        G.vert_wall_mask(h, w, split_idx, 0, h, dev),
        OBJ_WALL,
        COLOR_GREY,
    )

    # Agent uniform left of the wall, direction in [0, 4).
    _, xs = G.coord_grids(h, w, dev)
    left_of_wall = xs < split_idx.reshape(-1, 1, 1)
    state, _ = G.place_agent(generator, state, reject_mask=~left_of_wall)

    # Locked yellow door at (split_idx, door_idx), door_idx in [1, W-2):
    # the reference draws the row bound from the width.
    door_idx = torch.randint(
        1, w - 2, (b,), generator=generator, device=dev, dtype=torch.int32
    )
    state = G.put_obj(
        state, split_idx, door_idx, OBJ_DOOR, COLOR_YELLOW, STATE_LOCKED
    )

    # Yellow key left of the wall, on a free cell.
    state, _, _ = G.place_obj(
        generator, state, OBJ_KEY, COLOR_YELLOW, reject_mask=~left_of_wall
    )
    return state


def generate(
    generator: torch.Generator,
    p: EnvParams,
    batch_size: int,
    device="cuda",
) -> EnvState:
    """``batch_size`` DoorKey layouts drawn from ``generator``: on a CUDA
    device the five draws of :func:`generate_plain`, with its calls and in
    its order (the split, the agent's rank, its direction, the door's row,
    the key's rank), then one launch of :func:`layouts_kernel`; elsewhere
    :func:`generate_plain`."""
    dev = resolve_device(device)
    if device_path(dev) == "plain":
        return generate_plain(generator, p, batch_size, dev)
    b, w = batch_size, p.width

    def randint(low, high):
        return torch.randint(low, high, (b,), generator=generator, device=dev, dtype=torch.int32)

    split_idx = randint(2, w - 2)
    agent_u = torch.rand(b, generator=generator, device=dev)  # place_agent's rank
    agent_dir = randint(0, 4)
    door_idx = randint(1, w - 2)
    key_u = torch.rand(b, generator=generator, device=dev)  # place_obj's rank
    return layouts_kernel(p, split_idx, agent_u, agent_dir, door_idx, key_u)


def device_path(device) -> str:
    """The path :func:`generate` takes on ``device``, from the device
    alone: ``"kernel"`` (``csrc/doorkey_gen.cu``) on a CUDA device, else
    ``"plain"`` (:func:`generate_plain`)."""
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def generate_path(env: Environment, device) -> str:
    """The path ``env.generate`` takes on ``device``: :func:`device_path`
    for a DoorKey record, ``"plain"`` for any other."""
    return device_path(device) if env.generate is generate else "plain"


# (name, dtype) of the five draws, in csrc/doorkey_gen.cu's GenArgs order.
_DRAWS = (("split", torch.int32), ("agent_u", torch.float32), ("dir", torch.int32),
          ("door", torch.int32), ("key_u", torch.float32))
_ALIGN = 256  # bytes: each field's offset in the call's buffer; the kernel needs 16


class _GenArgs(ctypes.Structure):
    """``csrc/doorkey_gen.cu``'s ``GenArgs``, field for field."""

    _fields_ = [
        *((f.name, ctypes.c_void_p) for f in dataclasses.fields(EnvState)),
        *((name, ctypes.c_void_p) for name, _ in _DRAWS),
        *((name, ctypes.c_int32) for name in ("B", "H", "W", "n_aux", "n_mission")),
    ]


def layouts_kernel(
    p: EnvParams,
    split: torch.Tensor,
    agent_u: torch.Tensor,
    agent_dir: torch.Tensor,
    door: torch.Tensor,
    key_u: torch.Tensor,
) -> EnvState:
    """The batch-first layouts of :func:`generate_plain` from its five
    draws, (B,) each on one CUDA device (int32 split column, float32 rank
    of the agent, int32 direction, int32 door row, float32 rank of the
    key), as one launch of ``csrc/doorkey_gen.cu`` on the current stream.

    The fields are views of one fresh buffer a call, each on a span of its
    own at an ``_ALIGN``-byte offset: one allocation, where a tensor a
    field would be 19 (a rollout's capture empties the allocator's cache
    every call, so each is a device allocation and a free a call).  A
    field kept alone keeps the whole buffer.

    It checks every tensor it passes (device, dtype, shape, contiguity)
    and raises on any other input; there is no fallback.  Counter
    ``generator.kernel.launches``."""
    dev = split.device
    if dev.type != "cuda":
        raise ValueError(f"layouts_kernel: the draws are on {dev}, not a CUDA device")
    b, h, w = split.shape[0], p.height, p.width
    draws = dict(zip((name for name, _ in _DRAWS), (split, agent_u, agent_dir, door, key_u)))
    _kernels.check("layouts_kernel", dev,
                   {name: (draws[name], dtype, (b,)) for name, dtype in _DRAWS})
    spans, nbytes = _spans(b, h, w)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = {name: buf[at:at + size].view(dtype).view(shape) for name, shape, dtype, at, size in spans}
    args = _GenArgs(*(x.data_ptr() for x in (*out.values(), *draws.values())),
                    b, h, w, AUX_SLOTS, MISSION_SLOTS)
    _kernels.launch(dev, _gen_launch(), ctypes.byref(args))
    profiling.count("generator.kernel.launches")
    return EnvState(**out)


@functools.lru_cache(maxsize=64)
def _spans(b: int, h: int, w: int):
    """``(name, shape, dtype, offset, bytes)`` of each field of ``b``
    layouts of ``h`` x ``w`` in a call's buffer, in ``EnvState``'s order,
    and the buffer's bytes: ``new_state``'s shapes and dtypes, each field
    at an ``_ALIGN``-byte offset."""
    blank = new_state(b, h, w, torch.device("meta"))
    spans, nbytes = [], 0
    for f in dataclasses.fields(EnvState):
        x = getattr(blank, f.name)
        size = x.numel() * x.element_size()
        spans.append((f.name, tuple(x.shape), x.dtype, nbytes, size))
        nbytes += -(-size // _ALIGN) * _ALIGN
    return tuple(spans), nbytes


@functools.cache
def _gen_launch():
    """``csrc/doorkey_gen.cu``'s entry point, built and loaded at its first
    call; raises if its ``GenArgs`` is not the size of :class:`_GenArgs`."""
    lib = _kernels.library("doorkey_gen")
    if lib.gen_args_bytes() != ctypes.sizeof(_GenArgs):
        raise RuntimeError(
            f"csrc/doorkey_gen.cu's GenArgs is {lib.gen_args_bytes()} bytes, its mirror "
            f"{ctypes.sizeof(_GenArgs)}"
        )
    return _kernels.entry("doorkey_gen", "doorkey_gen_launch", [ctypes.c_void_p, ctypes.c_void_p])


def make_doorkey(
    env_id: str, size: int = 8, max_steps: Optional[int] = None
) -> Environment:
    params = EnvParams(
        width=size,
        height=size,
        max_steps=10 * size * size if max_steps is None else max_steps,
        see_through_walls=False,
    )
    return Environment(env_id, params, generate, mission_text=lambda codes: MISSION)
