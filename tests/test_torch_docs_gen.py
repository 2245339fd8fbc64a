"""The port's docs and GIF generators against the JAX package's (JAX's
``tests/test_docs_gen.py``): the same family slugs; env pages equal to
JAX's text but for the two lines that name the package and show a drawn
example mission (each package draws its own); GIFs written."""

from __future__ import annotations

import glob

import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.docs_gen import gen_env_docs as jax_gen_env_docs
from minigrid_dynamicprogramming_tpu.registry import family as jax_family

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.docs_gen import gen_env_docs, gen_gifs
from minigrid_dynamicprogramming_tpu_torch.registry import family

torch.set_num_threads(1)

IDS = ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0", "BabyAI-GoToRedBallGrey-v0"]


def test_family_slugs_equal_jax():
    assert family("MiniGrid-DoorKey-8x8-v0") == "doorkey"
    assert family("MiniGrid-DoorKey-16x16-v0") == "doorkey"
    assert family("BabyAI-GoToDoor-v0") != "misc"
    assert sorted(port.registered_ids()) == sorted(mgtpu.registered_ids())
    for env_id in port.registered_ids():
        assert family(env_id) == jax_family(env_id), env_id


def _masked(text: str) -> list:
    return [
        line for line in text.splitlines()
        if not line.startswith(("Example mission:", "| Creation |"))
    ]


def test_gen_env_docs_equal_jax(tmp_path):
    pages = gen_env_docs(str(tmp_path / "port"), ids=IDS, device="cpu")
    want = jax_gen_env_docs(str(tmp_path / "jax"), ids=IDS)
    assert len(pages) == len(want) == 3
    assert glob.glob(str(tmp_path / "port" / "environments" / "minigrid" / "*.md"))
    assert glob.glob(str(tmp_path / "port" / "environments" / "babyai" / "*.md"))
    for got_path, want_path in zip(pages, want):
        got, ref = open(got_path).read(), open(want_path).read()
        assert _masked(got) == _masked(ref), got_path
        assert 'minigrid_dynamicprogramming_tpu_torch.make("' in got
        mission = [line for line in got.splitlines() if line.startswith("Example mission:")]
        assert len(mission) == 1 and len(mission[0]) > len("Example mission: **"), mission
    text = (tmp_path / "port" / "environments" / "minigrid" / "doorkey.md").read_text()
    assert "MiniGrid-DoorKey-16x16-v0" in text  # the sibling list
    assert "Example mission: *use the key to open the door and then get to the goal*" in text


def test_gen_gifs(tmp_path):
    from PIL import Image

    written = gen_gifs(str(tmp_path), length=6, tile_size=8, ids=["MiniGrid-Empty-5x5-v0"], device="cpu")
    assert len(written) == 1
    with Image.open(written[0]) as im:
        # PIL merges equal consecutive frames (no-op actions), so there are
        # at most ``length`` frames, but the GIF must still animate.
        assert 2 <= im.n_frames <= 6
        assert im.size == (5 * 8, 5 * 8)
