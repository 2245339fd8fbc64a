"""The port's stepping wrappers against the JAX package's: the visit-count
bonuses, ``NoDeath``, the mission-text wrappers, a nested stack; and the
two random wrappers by their invariants.

As in ``test_torch_wrappers.py``: JAX-generated states, the same action
script on both sides, observations and count tables equal bit for bit,
rewards within 1e-6, ``terminated`` and ``truncated`` exactly.  JAX's
mission-text wrappers are host-side and run one env at a time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigrid_dynamicprogramming_tpu import wrappers as JW

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch import wrappers as TW
from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_LAVA

from .test_torch_wrappers import (
    BATCH,
    actions,
    assert_equal,
    assert_flags,
    make_pair,
    start_states,
)

torch.set_num_threads(1)

STEPS = 24


def run_parity(jw, tw, jstate, tstate, steps: int = STEPS, data=None) -> list:
    """Step JAX's wrapper under ``vmap`` and the port's on the same
    actions; ``data`` gives the bonus wrappers' zero tables ``(JAX, port)``.
    Returns JAX's per-step outputs."""
    if data is not None:
        jstate = JW.WrapperState(inner=jstate, data=data[0])
        tstate = TW.WrapperState(inner=tstate, data=data[1])
    jstep = jax.jit(jax.vmap(jw.step))
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    outs = []
    for t, act in enumerate(actions(steps=steps)):
        j_out = jstep(keys, jstate, jnp.asarray(act))
        t_out = tw.step(tstate, torch.from_numpy(act))
        jstate, tstate = j_out[1], t_out[1]
        assert_equal(t_out[0], j_out[0], f"obs t={t}")
        assert_flags(t_out, j_out, f"t={t}")
        j_core, t_core = JW.core_state(jstate), TW.core_state(tstate)
        assert_equal(t_core.terminated, j_core.terminated, f"state.terminated t={t}")
        assert_equal(t_core.agent_pos, j_core.agent_pos, f"state.agent_pos t={t}")
        if data is not None:
            assert_equal(tstate.data, jstate.data, f"counts t={t}")
        outs.append(j_out)
    return outs


@pytest.mark.parametrize("kind", ["action", "position"])
@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-5x5-v0", "MiniGrid-DoorKey-6x6-v0"])
def test_bonus_equals_jax(kind, env_id):
    jenv, tenv = make_pair(env_id, max_steps=100)
    p = jenv.params
    shape = (BATCH, p.width, p.height) + ((4, 7) if kind == "action" else ())
    cls = "ActionBonus" if kind == "action" else "PositionBonus"
    jstate, tstate = start_states(jenv)
    outs = run_parity(
        getattr(JW, cls)(jenv), getattr(TW, cls)(tenv), jstate, tstate,
        data=(jnp.zeros(shape, jnp.int32), torch.zeros(shape, dtype=torch.int32)),
    )
    # Revisits happened: some bonus below 1.
    assert min(float(np.asarray(o[2]).min()) for o in outs) < 1.0


def test_bonus_keeps_the_old_table():
    env = TW.PositionBonus(port.make("MiniGrid-Empty-5x5-v0"))
    obs, ws = env.reset(torch.Generator().manual_seed(0), 4, device="cpu")
    assert tuple(ws.data.shape) == (4, 5, 5)
    _, ws2, r, *_ = env.step(ws, 0)
    assert int(ws.data.sum()) == 0 and int(ws2.data.sum()) == 4
    np.testing.assert_array_equal(r.numpy(), np.ones(4, np.float32))


@pytest.mark.parametrize("env_id", ["MiniGrid-LavaCrossingS9N1-v0", "MiniGrid-DistShift1-v0"])
def test_no_death_equals_jax(env_id):
    jenv, tenv = make_pair(env_id, max_steps=100)
    jstate, tstate = start_states(jenv)
    outs = run_parity(
        JW.NoDeath(jenv, no_death_types=("lava",), death_cost=-1.0),
        TW.NoDeath(tenv, no_death_types=("lava",), death_cost=-1.0),
        jstate, tstate,
    )
    assert sum(_on_lava(o[1]) for o in outs) > 0  # deaths cancelled


def test_nested_stacks_equal_jax():
    """ImgObs(OneHot(ViewSize(5))) (``tests/test_wrappers.py:258-275``) and
    NoDeath over PositionBonus, whose cancellation goes through a nested
    WrapperState."""
    jenv, tenv = make_pair("MiniGrid-Empty-8x8-v0")
    jstate, tstate = start_states(jenv)

    def stack(W, env):
        return W.ImgObsWrapper(W.OneHotPartialObsWrapper(W.ViewSizeWrapper(env, 5)))

    run_parity(stack(JW, jenv), stack(TW, tenv), jstate, tstate, steps=16)

    jenv, tenv = make_pair("MiniGrid-LavaCrossingS9N1-v0", max_steps=100)
    jstate, tstate = start_states(jenv)
    shape = (BATCH, jenv.params.width, jenv.params.height)

    def bonus_no_death(W, env):
        return W.NoDeath(W.PositionBonus(env), no_death_types=("lava",), death_cost=-1.0)

    outs = run_parity(
        bonus_no_death(JW, jenv), bonus_no_death(TW, tenv), jstate, tstate, steps=16,
        data=(jnp.zeros(shape, jnp.int32), torch.zeros(shape, dtype=torch.int32)),
    )
    assert sum(_on_lava(o[1]) for o in outs) > 0  # deaths cancelled


def _on_lava(jstate) -> int:
    core = JW.core_state(jstate)
    obj, pos = np.asarray(core.grid_obj), np.asarray(core.agent_pos)
    return int((obj[np.arange(len(pos)), pos[:, 1], pos[:, 0]] == OBJ_LAVA).sum())


@pytest.mark.parametrize(
    "env_id", ["MiniGrid-LavaCrossingS9N1-v0", "MiniGrid-Fetch-5x5-N2-v0"]  # fixed, per-episode
)
def test_mission_text_wrappers_equal_jax(env_id):
    """DictObservationSpaceWrapper and FlatObsWrapper; JAX's run one env at
    a time on the host."""
    jenv, tenv = make_pair(env_id)
    flat = TW.FlatObsWrapper(tenv)
    assert (flat._static_chars is None) == (env_id == "MiniGrid-Fetch-5x5-N2-v0")
    tw = {"dict": TW.DictObservationSpaceWrapper(tenv), "flat": flat}
    jw = {"dict": JW.DictObservationSpaceWrapper(jenv), "flat": JW.FlatObsWrapper(jenv)}
    jstate, tstate = start_states(jenv)
    tstates = {k: tstate for k in tw}
    jstep = jax.jit(jax.vmap(jenv.step))
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    for t, act in enumerate(actions(steps=4)):
        j_out = jstep(keys, jstate, jnp.asarray(act))
        jstate = j_out[1]
        for name, w in tw.items():
            t_out = w.step(tstates[name], torch.from_numpy(act))
            tstates[name] = t_out[1]
            assert_flags(t_out, j_out, f"{name} t={t}")
            for i in range(BATCH):
                one = {k: np.asarray(v[i]) for k, v in j_out[0].items()}
                want = jw[name].observation(one, None)
                if name == "dict":
                    assert t_out[0]["mission"][i].tolist() == want["mission"], (t, i)
                    assert_equal(t_out[0]["image"][i], want["image"], f"dict image t={t}")
                else:
                    assert_equal(t_out[0][i], want, f"flat t={t} env {i}")
    missions = tstates["dict"].mission
    assert (len({tuple(m) for m in missions.tolist()}) > 1) == (env_id == "MiniGrid-Fetch-5x5-N2-v0")


class _Record(TW.Wrapper):
    """Remembers the action its inner env was stepped with."""

    def step(self, state, action, generator=None):
        self.seen = action
        return self.env.step(state, action, generator)


def test_stochastic_action_invariants():
    env = port.make("MiniGrid-Empty-8x8-v0")
    g = torch.Generator().manual_seed(0)
    obs, state = env.reset(g, 4096, device="cpu")
    # prob=1.0 keeps every action: the bare step.
    act = torch.from_numpy(np.random.default_rng(0).integers(0, 7, 4096))
    with pytest.raises(ValueError, match="pass a generator"):
        TW.StochasticActionWrapper(env, prob=1.0).step(state, act)
    got = TW.StochasticActionWrapper(env, prob=1.0).step(state, act, g)
    want = env.step(state, act)
    assert_equal(got[0], {k: v.numpy() for k, v in want[0].items()}, "prob=1.0")
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    # prob=0.5: done (6) is replaced by a uniform draw over 0..5 in half
    # the envs, within 4 sigma.
    rec = _Record(env)
    w = TW.StochasticActionWrapper(rec, prob=0.5)
    w.step(state, 6, g)
    seen = rec.seen.numpy()
    share = float((seen != 6).mean())
    assert abs(share - 0.5) <= 4 * np.sqrt(0.25 / 4096), share
    assert set(np.unique(seen[seen != 6])) == set(range(6))
    # A fixed replacement.
    TW.StochasticActionWrapper(rec, prob=0.0, random_action=2).step(state, 6, g)
    assert (rec.seen == 2).all()


def test_reseed_cycles():
    env = TW.ReseedWrapper(port.make("MiniGrid-DoorKey-8x8-v0"), seeds=[7, 9])
    (o1, s1), (o2, s2), (o3, s3) = [env.reset(batch_size=8, device="cpu") for _ in range(3)]
    assert torch.equal(s1.grid_obj, s3.grid_obj) and torch.equal(s1.agent_pos, s3.agent_pos)
    assert torch.equal(o1["image"], o3["image"])
    assert not torch.equal(s1.grid_obj, s2.grid_obj)
    assert env.seed_idx == 1


def test_wrappers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = port.make("MiniGrid-Empty-5x5-v0")
    for w in (TW.ActionBonus(env), TW.ImgObsWrapper(env)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            w.reset(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TW.ReseedWrapper(env, seeds=[1]).reset()
