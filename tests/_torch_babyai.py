"""Helpers of the port's BabyAI tests: batches of twin layouts as states of
both packages.

The JAX package's numpy twin of the reference's generation
(``utils/twin_babyai.py``) builds a BabyAI layout, its mission codes and
its mark planes for a seed without compiling a JAX generator.
``twin_batch`` stacks such layouts into a batch-first dict of numpy arrays
in the JAX ``EnvState``'s fields and dtypes, which either package takes
(``bridge.from_numpy`` for the port).
"""

from __future__ import annotations

import numpy as np

from minigrid_dynamicprogramming_tpu.core.constants import OBJ_EMPTY
from minigrid_dynamicprogramming_tpu.core.state import AUX_SLOTS, MISSION_SLOTS
from minigrid_dynamicprogramming_tpu.envs.babyai import core as JB
from minigrid_dynamicprogramming_tpu.utils.parity_twin import twin_layout
from minigrid_dynamicprogramming_tpu.utils.twin_babyai import encode_instrs


def layout_arrays(layout) -> dict:
    """One twin BabyAI layout as a dict of the JAX ``EnvState``'s fields
    (``twin_reset``'s construction, without JAX)."""
    mission, marks, carrying_marks = encode_instrs(layout, MISSION_SLOTS)
    aux = np.zeros(AUX_SLOTS, np.int32)
    aux[JB.AUX_PC_NONE:JB.AUX_PC_NONE + 4] = 1
    aux[JB.AUX_MAX_STEPS] = layout.extra["max_steps"]
    carrying_obj, carrying_color = OBJ_EMPTY, 0
    carry = layout.extra.get("carry")
    if carry is not None:  # PutNext start_carrying
        carrying_obj, carrying_color, _ = carry.encode()
    return dict(
        grid_obj=layout.grid_obj, grid_color=layout.grid_color, grid_state=layout.grid_state,
        contains_obj=layout.contains_obj, contains_color=layout.contains_color,
        marks=marks, vmarks=marks.copy(), carrying_marks=np.uint16(carrying_marks),
        agent_pos=np.asarray(layout.agent_pos, np.int32), agent_dir=np.int32(layout.agent_dir),
        carrying_obj=np.uint8(carrying_obj), carrying_color=np.uint8(carrying_color),
        carrying_contains_obj=np.uint8(OBJ_EMPTY), carrying_contains_color=np.uint8(0),
        step_count=np.int32(0), terminated=np.bool_(False), truncated=np.bool_(False),
        aux=aux, mission=mission.astype(np.int32),
    )


def stack(layouts) -> dict:
    """Twin layouts as one batch-first dict (no ``rng`` field)."""
    each = [layout_arrays(lay) for lay in layouts]
    return {k: np.stack([np.asarray(e[k]) for e in each]) for k in each[0]}


def twin_batch(env_id: str, seeds) -> dict:
    """The twin layouts of ``env_id`` at ``seeds``, batch-first."""
    return stack([twin_layout(env_id, int(s)) for s in seeds])


# -- set-ups that put a verifier event within reach of a random walk ---------

_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))


def _empty(obj, x, y) -> bool:
    h, w = obj.shape
    return 0 <= x < w and 0 <= y < h and obj[y, x] == OBJ_EMPTY


def _face(s, b, tx, ty) -> bool:
    """Put lane b's agent on an empty neighbour of (tx, ty), facing it."""
    for k, (dx, dy) in enumerate(_DIRS):
        if _empty(s["grid_obj"][b], tx - dx, ty - dy):
            s["agent_pos"][b], s["agent_dir"][b] = (tx - dx, ty - dy), k
            return True
    return False


def _cells(plane, bit):
    return [(x, y) for y, x in np.argwhere(plane & bit)]


def face_target(s: dict, leaf=(0, 0)) -> dict:
    """In every other lane, the agent faces an object of the leaf's first
    descriptor; in every fourth lane that of clause B's first leaf instead,
    where it has one (so a strict sequence fails)."""
    s = {k: v.copy() for k, v in s.items()}
    for b in range(0, len(s["grid_obj"]), 2):
        c, l = (1, 0) if b % 4 == 2 and (s["marks"][b] & JB.desc_bit(1, 0, 0)).any() else leaf
        for x, y in _cells(s["marks"][b], JB.desc_bit(c, l, 0)):
            if _face(s, b, x, y):
                break
    return s


def carry_to_fixed(s: dict) -> dict:
    """In every other lane, the agent carries an object of leaf (0, 0)'s
    moved descriptor (lifted off the grid, as PutNext's start_carrying
    does, unless it already carries one) and faces an empty cell next to
    an object of the fixed descriptor, so a drop puts it next to it."""
    s = {k: v.copy() for k, v in s.items()}
    move, fixed = JB.desc_bit(0, 0, 0), JB.desc_bit(0, 0, 1)
    for b in range(0, len(s["grid_obj"]), 2):
        obj = s["grid_obj"][b]
        if s["carrying_obj"][b] == OBJ_EMPTY:
            movers = _cells(s["marks"][b], move)
            if not movers:
                continue
            x, y = movers[0]
            s["carrying_obj"][b], s["carrying_color"][b] = obj[y, x], s["grid_color"][b, y, x]
            s["carrying_marks"][b] = s["marks"][b, y, x]
            obj[y, x], s["grid_color"][b, y, x], s["marks"][b, y, x] = OBJ_EMPTY, 0, 0
        placed = False
        for fx, fy in _cells(s["vmarks"][b], fixed):
            for dx, dy in _DIRS:
                if not placed and _empty(obj, fx + dx, fy + dy):
                    placed = _face(s, b, fx + dx, fy + dy)
    return s


# -- the verifier's step against JAX's ----------------------------------------

# left, right, forward, pickup, drop, toggle, done: weighted towards the
# verifier's actions.
ACTION_P = np.array([0.1, 0.1, 0.15, 0.2, 0.2, 0.2, 0.05])
U16 = 1 << 16


def _count(kind, rew, term, aux) -> int:
    if kind == "success":
        return int((term & (rew > 0)).sum())
    if kind == "failure":
        return int((term & (rew == 0)).sum())
    assert kind == "partial"  # a clause or leaf done, the mission not yet
    return int(((aux[JB.AUX_A_DONE:JB.AUX_LEAF_DONE + 4] == 1).any(axis=0) & ~term).sum())


_OBS = {}


def _jax_obs(params):
    """JAX's observation of a lane-major state, through its batch-first
    encoder (``ops/obs.py:gen_obs_image``), which compiles in seconds at
    22x22 where the lane-major one takes tens; the two are equal (JAX's own
    tests).  One compile per grid size and view."""
    import jax

    from minigrid_dynamicprogramming_tpu.ops.obs import gen_obs_image
    from minigrid_dynamicprogramming_tpu.parallel import lanes as jlanes

    p = params.replace(max_steps=0, extra=())
    if p not in _OBS:
        _OBS[p] = jax.jit(
            lambda ls: jax.vmap(lambda s: gen_obs_image(p, s))(jlanes.from_lanes(p, ls))
        )
    return _OBS[p]


def verifier_parity(env_id: str, events, prep=None, batch: int = 48, steps: int = 40) -> dict:
    """The port's lane-major step with the verifier hook, and its
    observation, against the JAX package's on ``batch`` twin layouts of
    ``env_id``: every field bit for bit at every step (the mark planes
    also within 16 bits), the reward within 1e-6.  Each of ``events`` must
    happen.  Returns the event counts."""
    import jax
    import torch

    import minigrid_dynamicprogramming_tpu as mgtpu
    from minigrid_dynamicprogramming_tpu.core.state import EnvState as JState
    from minigrid_dynamicprogramming_tpu.parallel import lanes as jlanes

    import minigrid_dynamicprogramming_tpu_torch as port
    from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

    from ._torch_families import _np

    jenv, tenv = mgtpu.make(env_id), port.make(env_id)
    assert tenv.params.extra == jenv.params.extra, env_id
    arrays = twin_batch(env_id, range(batch))
    if prep is not None:
        arrays = prep(arrays)
    arrays["rng"] = np.zeros((batch, 2), np.uint32)
    jls = jlanes.to_lanes(JState(**{k: jax.numpy.asarray(v) for k, v in arrays.items()}))
    tls = from_numpy(tlanes.LaneState, _np(jls), "cpu")
    jstep = jax.jit(lambda s, a: jlanes.step_lanes_env(jenv, None, s, a))
    jobs = _jax_obs(jenv.params)

    rng = np.random.default_rng(1)
    seen = dict.fromkeys(events, 0)
    for t in range(steps):
        act = rng.choice(7, size=batch, p=ACTION_P).astype(np.int32)
        jls, j_rew, j_term = jstep(jls, jax.numpy.asarray(act))
        tls, t_rew, t_term = tlanes.step_lanes_env(tenv, tls, torch.from_numpy(act))

        got, want = to_numpy(tls), _np(jls)
        for name in got:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{env_id} t={t} {name}")
        for name in ("marks", "vmarks", "carrying_marks"):
            plane = getattr(tls, name)
            assert bool(((plane >= 0) & (plane < U16)).all()), (env_id, t, name)
        np.testing.assert_array_equal(t_term.numpy(), np.asarray(j_term))
        np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            tlanes.obs_image_lanes(tenv.params, tls).numpy(), np.asarray(jobs(jls))
        )
        for kind in events:
            seen[kind] += _count(kind, np.asarray(j_rew), np.asarray(j_term), want["aux"])
    assert all(n > 0 for n in seen.values()), (env_id, seen)
    return seen
