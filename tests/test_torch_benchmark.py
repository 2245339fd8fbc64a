"""The port's micro-benchmark CLI runs on the CPU at a tiny size and
reports every metric of the JAX package's ``benchmark``: its headline
``batched_env_steps_per_s`` from the "regen" rollout, as JAX's, and
``lane_env_steps_per_s`` from the "pool" one; without a card it refuses
the default device."""

from __future__ import annotations

import pytest
import torch

from minigrid_dynamicprogramming_tpu_torch import benchmark as B

torch.set_num_threads(1)


@pytest.mark.parametrize("env_id", ["MiniGrid-LavaGapS7-v0", "MiniGrid-Dynamic-Obstacles-5x5-v0"])
def test_benchmark_smoke(env_id, capsys):
    out = B.benchmark(env_id, num_resets=2, num_frames=3, tile_size=8, batch=8, horizon=4, device="cpu")
    for key in ("reset_ms", "render_fps", "agent_view_fps", "batched_env_steps_per_s"):
        assert out[key] > 0, key
    assert out["device"] == "cpu" and out["batch"] == 8
    assert out["pov_shape"] == (56, 56, 3)
    printed = capsys.readouterr().out
    assert f"env_id: {env_id}" in printed and "render_fps:" in printed


def test_headline_comes_from_the_regen_rollout(monkeypatch):
    modes = []
    rollout = B.lane_rollout

    def recording(env, generator, batch, horizon, autoreset, *args, **kwargs):
        modes.append(autoreset)
        return rollout(env, generator, batch, horizon, autoreset, *args, **kwargs)

    monkeypatch.setattr(B, "lane_rollout", recording)
    out = B.benchmark(num_resets=1, num_frames=1, tile_size=8, batch=4, horizon=3, device="cpu")
    # A warm-up and a timed run of each, the headline's first.
    assert modes == ["regen", "regen", "pool", "pool"]
    assert out["env_id"] == "MiniGrid-LavaGapS7-v0"
    assert out["batched_env_steps_per_s"] > 0 and out["lane_env_steps_per_s"] > 0


def test_cli(capsys):
    B.main(["--env-id", "MiniGrid-Empty-5x5-v0", "--num-resets", "1", "--num-frames", "1",
            "--tile-size", "8", "--batch", "4", "--horizon", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "frame_shape: (40, 40, 3)" in printed


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.benchmark(num_resets=1, num_frames=1)
