"""Which path DoorKey's generator takes, checked on the CPU.

On a CUDA device DoorKey's ``generate`` makes the plain generator's five
draws and writes the layouts with one hand-written kernel
(``csrc/doorkey_gen.cu``); on any other device it is the plain generator
(``envs/doorkey.py:generate_plain``), the kernel's twin.  The choice
reads the env record and the device alone, so it is held here for every
registered id.  The kernel itself runs only on a card
(``tests/test_torch_on_card.py``, ``-k doorkey_gen``); here its wrapper
refuses the CPU before it loads anything, its argument record keeps the
layout of the kernel's ``GenArgs``, and its output buffer holds every field of
``new_state`` on a span of its own.  That a CPU ``generate`` launches
nothing, and keeps its layouts, is held for every id with the digests of
``tests/test_torch_generate_graph.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch import registry
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState, new_state
from minigrid_dynamicprogramming_tpu_torch.envs import doorkey
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

DOORKEY_IDS = [f"MiniGrid-DoorKey-{n}x{n}-v0" for n in (5, 6, 8, 16)]


@pytest.mark.parametrize("env_id", port.registered_ids())
def test_generate_path_from_the_env_record(env_id):
    """The kernel for the DoorKey ids on a card, and for no other id; the
    plain generator for every id on the CPU."""
    env = port.make(env_id)
    kernel = registry.family(env_id) == "doorkey"
    assert kernel == (env_id in DOORKEY_IDS)
    for card in (torch.device("cuda"), torch.device("cuda", 0), "cuda"):
        assert doorkey.generate_path(env, card) == ("kernel" if kernel else "plain")
        assert doorkey.device_path(card) == "kernel"
    assert doorkey.generate_path(env, torch.device("cpu")) == "plain"
    assert doorkey.device_path("cpu") == "plain"


def test_kernel_wrapper_refuses_the_cpu(monkeypatch):
    """The kernel's wrapper raises on draws that are not on a card, before
    any build or launch."""

    def load():
        raise AssertionError("the kernel's library was loaded")

    monkeypatch.setattr(doorkey, "_gen_launch", load)
    env = port.make("MiniGrid-DoorKey-8x8-v0")
    b = 4
    draws = (torch.full((b,), 3, dtype=torch.int32), torch.rand(b),
             torch.zeros(b, dtype=torch.int32), torch.ones(b, dtype=torch.int32), torch.rand(b))
    launches = profiling.counter("generator.kernel.launches")
    with pytest.raises(ValueError, match="not a CUDA device"):
        doorkey.layouts_kernel(env.params, *draws)
    assert profiling.counter("generator.kernel.launches") == launches


def test_gen_args_mirror_the_kernels_record():
    """``_GenArgs`` lays out ``csrc/doorkey_gen.cu``'s ``GenArgs``: a pointer
    a field of ``EnvState``, in its order, then the five draws' pointers and
    five 32-bit ints (216 bytes on a 64-bit host; the kernel's library
    reports its own size, which the loader checks)."""
    names = [name for name, _ in doorkey._GenArgs._fields_]
    assert names == [f.name for f in dataclasses.fields(EnvState)] + [
        "split", "agent_u", "dir", "door", "key_u", "B", "H", "W", "n_aux", "n_mission"]
    assert ctypes.sizeof(doorkey._GenArgs) == (19 + 5) * 8 + 5 * 4 + 4


@pytest.mark.parametrize("b", [0, 1, 127, 4097])
def test_buffer_spans_follow_new_state(b):
    """The kernel's output buffer holds each field of ``new_state`` with its
    shape and dtype, on a span of its own at a 16-byte-aligned offset, in
    ``EnvState``'s order."""
    spans, nbytes = doorkey._spans(b, 8, 8)
    blank = new_state(b, 8, 8, torch.device("cpu"))
    assert [name for name, *_ in spans] == [f.name for f in dataclasses.fields(EnvState)]
    end = 0
    for name, shape, dtype, at, size in spans:
        want = getattr(blank, name)
        assert (shape, dtype) == (tuple(want.shape), want.dtype), name
        assert at % 16 == 0 and at >= end and size == want.numel() * want.element_size(), name
        end = at + size
    assert end <= nbytes
