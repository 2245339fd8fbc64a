"""Faults planted on one side of the BossLevel cells' comparison
(``drivers/babyai_rollout.py`` against ``reference/babyai_levelgen.py``)
make it fail, on the CPU.  In the program, each through the harness at
the small size of ``test_portbench_bosslevel.py``: a toggled box left in
place, the locked room's key put inside the locked room, every episode's
step limit that of one navigation.  In the reference, against one
program rollout of many lanes and few steps (the verifier's progress
differs on a few lanes a thousand): Before verified as And, location
descriptors read at the agent's current pose instead of its pose at
reset."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.drivers import babyai_rollout as driver
from portbench.reference import babyai_levelgen as ref

POOL = "bosslevel.rollout-pool"
SMALL = dict(batch=64, horizon=48, pool_rounds=4, check_within=1)
# The reference's faults show only where the verifier has moved on: lanes
# enough that a few dozen have, steps few enough that the CPU replays
# them quickly.
WIDE = dict(batch=2048, horizon=16)


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def _box_stays(monkeypatch):
    """The program's step leaves a toggled box where it stood."""
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes

    real = lanes.step_lanes

    def step(params, ls, action):
        dx, dy = lanes._dir_vec(ls.agent_dir)
        idx = ((ls.agent_y + dy) * params.width + ls.agent_x + dx).long()
        box = (action.to(torch.int32) == ref.dk.TOGGLE) & (lanes._read(ls.grid_obj, idx) == ref.dk.BOX)
        new, reward, term = real(params, ls, action)
        keep = {}
        for name in ("grid_obj", "grid_color", "marks"):
            old = lanes._read(getattr(ls, name), idx)
            keep[name] = lanes._write(getattr(new, name), idx,
                                      torch.where(box, old, lanes._read(getattr(new, name), idx)))
        return new.replace(**keep), reward, term

    monkeypatch.setattr(lanes, "step_lanes", step)


def _key_inside(monkeypatch):
    """The program's generator puts the locked room's key inside the
    locked room."""
    from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B

    real = B.init_instr

    def init_instr(params, state, codes):
        obj, color, st = state.grid_obj.clone(), state.grid_color.clone(), state.grid_state
        for b in range(obj.shape[0]):
            locked = ((obj[b] == ref.dk.DOOR) & (st[b] == ref.dk.LOCKED)).nonzero()
            if not len(locked):
                continue
            y, x = locked[0].tolist()
            # The locked room: of the two rooms beside its door, the one whose
            # interior has no other door on its walls.
            sides = [(y, x - 1), (y, x + 1)] if x % ref.PITCH == 0 else [(y - 1, x), (y + 1, x)]
            for cy, cx in sides:
                y0, x0 = cy // ref.PITCH * ref.PITCH, cx // ref.PITCH * ref.PITCH
                walls = torch.zeros_like(obj[b], dtype=torch.bool)
                walls[y0, x0:x0 + ref.ROOM] = walls[y0 + ref.PITCH, x0:x0 + ref.ROOM] = True
                walls[y0:y0 + ref.ROOM, x0] = walls[y0:y0 + ref.ROOM, x0 + ref.PITCH] = True
                if int(((obj[b] == ref.dk.DOOR) & walls).sum()) == 1:
                    break
            room = torch.zeros_like(obj[b], dtype=torch.bool)
            room[y0:y0 + ref.ROOM, x0:x0 + ref.ROOM] = True
            keys = ((obj[b] == ref.dk.KEY) & (color[b] == color[b, y, x]) & ~room).nonzero().tolist()
            inside = (obj[b, y0 + 1:y0 + ref.PITCH, x0 + 1:x0 + ref.PITCH] == ref.dk.EMPTY).nonzero().tolist()
            ky, kx = keys[0]
            iy, ix = inside[0]
            obj[b, ky, kx], color[b, ky, kx] = ref.dk.EMPTY, 0
            obj[b, y0 + 1 + iy, x0 + 1 + ix], color[b, y0 + 1 + iy, x0 + 1 + ix] = ref.dk.KEY, color[b, y, x]
        return real(params, state.replace(grid_obj=obj, grid_color=color), codes)

    monkeypatch.setattr(B, "init_instr", init_instr)


def _one_nav(monkeypatch):
    """The program gives every episode the step limit of one navigation."""
    from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B

    real = B.init_instr

    def init_instr(params, state, codes):
        state = real(params, state, codes)
        aux = state.aux.clone()
        aux[:, B.AUX_MAX_STEPS] = ref.NAV_STEPS
        return state.replace(aux=aux)

    monkeypatch.setattr(B, "init_instr", init_instr)


def _before_as_and(monkeypatch):
    """The reference verifies Before(A, B) as And(A, B): both clauses
    every step until each has succeeded."""
    real = ref._seq

    def seq(v, action, mask, first, second):
        if first != 0:
            return real(v, action, mask, first, second)
        done = v["seq_done"]
        r = [ref._clause(v, action, c, mask & ~done[:, c]) for c in range(2)]
        now = torch.stack([done[:, c] | (mask & ~done[:, c] & (r[c] == ref.SUCCESS)) for c in range(2)], 1)
        v["seq_done"] = torch.where(mask[:, None], now, done)
        return torch.where(now.all(1), ref.SUCCESS, ref.CONTINUE)

    monkeypatch.setattr(ref, "_seq", seq)


def _location_now(monkeypatch):
    """The reference reads a location descriptor's objects at the agent's
    current pose on every step, not at its pose at reset."""
    real = ref.verify

    def verify(v, action):
        v = dict(v)
        b, h, w = v["obj"].shape
        dset, dposs = v["dset"].clone(), v["dposs"].clone()
        for k in range(ref.DESCS):
            located = v["codes"][:, ref.desc_at(k) + 2] != ref.LOC_NONE
            m = ref.matches(v, k, v["ax"], v["ay"], v["adir"]).reshape(b, -1)
            ids = torch.zeros(b, h * w + 1, dtype=torch.bool).scatter(1, v["oid"].reshape(b, -1), m)
            ids[:, 0] = False
            dset[:, k] = torch.where(located[:, None], ids, dset[:, k])
            dposs[:, k] = torch.where(located[:, None], m, dposs[:, k])
        v["dset"], v["dposs"] = dset, dposs
        return real(v, action)

    monkeypatch.setattr(ref, "verify", verify)


PROGRAM_FAULTS = {"box_stays": _box_stays, "key_inside": _key_inside, "one_nav": _one_nav}
REFERENCE_FAULTS = {"before_as_and": _before_as_and, "location_now": _location_now}


@pytest.mark.parametrize("fault", list(PROGRAM_FAULTS))
def test_program_faults_fail(bench, monkeypatch, fault):
    PROGRAM_FAULTS[fault](monkeypatch)
    line = harness.run_cell(bench, POOL, 20260419, 0.0, False, "cpu", time.time(), overrides=SMALL)
    assert not line["correct"], (fault, line["checks"])


@pytest.fixture(scope="module")
def wide_rollout():
    """One program rollout of ``WIDE``'s lanes from one batch of layouts
    (every reset takes its lane's first layout again), its answer, and the
    reference's first episodes and actions."""
    import minigrid_dynamicprogramming_tpu_torch as port
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes

    env = port.make("BabyAI-BossLevel-v0")
    b, horizon = WIDE["batch"], WIDE["horizon"]
    flat = env.generate(torch.Generator().manual_seed(2026), env.params, b, "cpu")
    acts = torch.randint(0, env.action_dim, (horizon, b), generator=torch.Generator().manual_seed(7),
                         dtype=torch.int32)
    res = lanes._lane_scan(env, None, lanes.stack_rounds(flat, b, 1), b, horizon, "pool", 1, acts)
    return driver._program_answer(env, res), ref.start(driver.ref_layout(env, flat)), acts


def _replay(wide_rollout) -> dict:
    got, first, acts = wide_rollout
    want = ref.rollout(first, acts, lambda t, resets: first)
    return driver._compare(got, want)


def test_wide_rollout_agrees(wide_rollout):
    numbers = _replay(wide_rollout)
    assert all(v == 0 for k, v in numbers.items() if k != "reward_gap"), numbers
    assert numbers["reward_gap"] <= 2e-4


@pytest.mark.parametrize("fault", list(REFERENCE_FAULTS))
def test_reference_faults_fail(wide_rollout, monkeypatch, fault):
    REFERENCE_FAULTS[fault](monkeypatch)
    numbers = _replay(wide_rollout)
    assert any(v > 0 for k, v in numbers.items() if k != "reward_gap") or numbers["reward_gap"] > 2e-4, numbers
