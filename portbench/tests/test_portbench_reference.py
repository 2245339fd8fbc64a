"""The plain reference of DoorKey against upstream's rules transcribed one
environment at a time: the layout maker and the rule check, the step, and
the view (``Grid.slice``, ``rotate_left``, ``process_vis``, the carried
object, ``encode``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import doorkey as ref


@pytest.mark.parametrize("size", [5, 6, 8, 16])
def test_maker_draws_valid_layouts_covering_every_door(size):
    raw = ref.make_layouts(np.random.default_rng(size), 3000, size)
    s = _state(raw)
    assert not ref.invalid_layouts(s).any()
    assert ref.unseen_pairs(ref.split_door_pairs(s), size) == 0


def _state(raw) -> ref.State:
    t = {k: torch.from_numpy(v) for k, v in raw.items()}
    return ref.start_state(t["obj"], t["color"], t["state"], t["agent_pos"][:, 0],
                           t["agent_pos"][:, 1], t["agent_dir"])


@pytest.mark.parametrize("breakage", ["goal", "door", "second_key", "agent_on_wall", "carrying",
                                      "unlocked", "wall_color", "stepped"])
def test_rule_check_finds_broken_layouts(breakage):
    raw = ref.make_layouts(np.random.default_rng(1), 4, 8)
    s = _state(raw)
    b = 2
    if breakage == "goal":
        s["obj"][b, 6, 6] = ref.EMPTY
    elif breakage == "door":
        s["obj"][b][s["obj"][b] == ref.DOOR] = ref.WALL
    elif breakage == "second_key":
        s["obj"][b, 6, 1] = ref.KEY
        s["color"][b, 6, 1] = ref.YELLOW
    elif breakage == "agent_on_wall":
        s["ax"][b] = 0
    elif breakage == "carrying":
        s["carry_obj"][b] = ref.KEY
    elif breakage == "unlocked":
        s["state"][b][s["obj"][b] == ref.DOOR] = ref.CLOSED
    elif breakage == "wall_color":
        s["color"][b, 0, 0] = ref.GREEN
    else:
        s["steps"][b] = 1
    assert ref.invalid_layouts(s).tolist() == [i == b for i in range(4)]


# --- upstream's rules, one environment at a time ----------------------------

def _upstream_view(grid, ax, ay, adir, carrying):
    """``MiniGridEnv.gen_obs_grid`` and ``Grid.encode(vis_mask)`` over a grid
    of (obj, color, state) tuples indexed [x][y], None for empty."""
    v = ref.VIEW
    if adir == 0:
        top_x, top_y = ax, ay - v // 2
    elif adir == 1:
        top_x, top_y = ax - v // 2, ay
    elif adir == 2:
        top_x, top_y = ax - v + 1, ay - v // 2
    else:
        top_x, top_y = ax - v // 2, ay - v + 1
    w, h = len(grid), len(grid[0])
    view = [[(ref.WALL, ref.GREY, 0) if not (0 <= top_x + i < w and 0 <= top_y + j < h)
             else grid[top_x + i][top_y + j] for j in range(v)] for i in range(v)]
    for _ in range(adir + 1):  # rotate_left
        view = [[view[v - 1 - j][i] for j in range(v)] for i in range(v)]
    mask = [[False] * v for _ in range(v)]
    mask[v // 2][v - 1] = True

    def see_behind(cell):
        if cell is None:
            return True
        if cell[0] == ref.WALL:
            return False
        if cell[0] == ref.DOOR:
            return cell[2] == ref.OPEN
        return True

    for j in reversed(range(v)):
        for i in range(v - 1):
            if not mask[i][j] or not see_behind(view[i][j]):
                continue
            mask[i + 1][j] = True
            if j > 0:
                mask[i + 1][j - 1] = True
                mask[i][j - 1] = True
        for i in reversed(range(1, v)):
            if not mask[i][j] or not see_behind(view[i][j]):
                continue
            mask[i - 1][j] = True
            if j > 0:
                mask[i - 1][j - 1] = True
                mask[i][j - 1] = True
    view[v // 2][v - 1] = carrying
    out = np.zeros((v, v, 3), np.int64)
    for i in range(v):
        for j in range(v):
            if mask[i][j]:
                cell = view[i][j]
                out[i, j] = (ref.EMPTY, 0, 0) if cell is None else (
                    cell[0], cell[1], cell[2] if cell[0] == ref.DOOR else 0)
    return out, np.array(mask)


def _upstream_step(grid, ax, ay, adir, carrying, steps, action, max_steps):
    """``MiniGridEnv.step`` over the same grid (changed in place)."""
    steps += 1
    reward, terminated = 0.0, False
    dx, dy = ref.DIR_VEC[adir]
    fx, fy = ax + dx, ay + dy
    fwd = grid[fx][fy]
    if action == ref.LEFT:
        adir = (adir - 1) % 4
    elif action == ref.RIGHT:
        adir = (adir + 1) % 4
    elif action == ref.FORWARD:
        if fwd is None or fwd[0] in (ref.GOAL, ref.LAVA, ref.FLOOR) or (
                fwd[0] == ref.DOOR and fwd[2] == ref.OPEN):
            ax, ay = fx, fy
        if fwd is not None and fwd[0] == ref.GOAL:
            terminated, reward = True, 1 - 0.9 * (steps / max_steps)
        if fwd is not None and fwd[0] == ref.LAVA:
            terminated = True
    elif action == ref.PICKUP:
        if fwd is not None and fwd[0] in (ref.KEY, ref.BALL, ref.BOX) and carrying is None:
            carrying = (fwd[0], fwd[1], 0)
            grid[fx][fy] = None
    elif action == ref.DROP:
        if fwd is None and carrying is not None:
            grid[fx][fy] = carrying
            carrying = None
    elif action == ref.TOGGLE:
        if fwd is not None and fwd[0] == ref.DOOR:
            if fwd[2] == ref.LOCKED:
                if carrying is not None and carrying[0] == ref.KEY and carrying[1] == fwd[1]:
                    grid[fx][fy] = (ref.DOOR, fwd[1], ref.OPEN)
            else:
                grid[fx][fy] = (ref.DOOR, fwd[1], ref.CLOSED if fwd[2] == ref.OPEN else ref.OPEN)
    return ax, ay, adir, carrying, steps, reward, terminated, steps >= max_steps


def _grid(s, b):
    h, w = s["obj"].shape[1:]
    return [[None if int(s["obj"][b, y, x]) == ref.EMPTY else
             (int(s["obj"][b, y, x]), int(s["color"][b, y, x]), int(s["state"][b, y, x]))
             for y in range(h)] for x in range(w)]


def test_step_and_view_follow_upstream():
    """Random actions, with extra pickups and toggles, from DoorKey-6x6
    layouts: the reference's states, rewards and views equal upstream's
    rules applied one environment at a time."""
    n, size, max_steps = 24, 6, 360
    raw = ref.make_layouts(np.random.default_rng(5), n, size)
    s = _state(raw)
    gen = np.random.default_rng(6)
    grids = [_grid(s, b) for b in range(n)]
    agents = [(int(s["ax"][b]), int(s["ay"][b]), int(s["adir"][b]), None, 0) for b in range(n)]
    for _ in range(300):
        actions = gen.choice(7, n, p=[0.2, 0.2, 0.3, 0.1, 0.05, 0.1, 0.05])
        s, reward, term = ref.step(s, torch.from_numpy(actions), max_steps)
        obj, color, state, vis = ref.observe(s)
        for b in range(n):
            ax, ay, adir, carrying, steps = agents[b]
            ax, ay, adir, carrying, steps, r, t, trunc = _upstream_step(
                grids[b], ax, ay, adir, carrying, steps, int(actions[b]), max_steps)
            agents[b] = (ax, ay, adir, carrying, steps)
            assert (int(s["ax"][b]), int(s["ay"][b]), int(s["adir"][b]), int(s["steps"][b])) == \
                (ax, ay, adir, steps)
            assert (bool(term[b]), bool(s["truncated"][b])) == (t, trunc)
            assert float(reward[b]) == pytest.approx(r, abs=0)
            assert _grid(s, b) == grids[b]
            held = (int(s["carry_obj"][b]), int(s["carry_color"][b]), 0)
            assert (None if held[0] == ref.EMPTY else held) == carrying
            want, want_vis = _upstream_view(grids[b], ax, ay, adir, carrying)
            got = torch.stack([obj[b], color[b], state[b]], -1) * vis[b, :, :, None]
            assert np.array_equal(got.numpy(), want) and np.array_equal(vis[b].numpy(), want_vis)
