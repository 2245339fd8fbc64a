"""Oracle bot that solves BabyAI levels, driven through the port's
batch-first ``reset`` and ``step``.

Own copy of ``minigrid_dynamicprogramming_tpu/utils/babyai_bot.py`` (NumPy;
the port keeps its own so that it imports nothing of the JAX package).  The
planner is the same; what differs is how it reads a state:

* the port's states are batch-first, so :class:`BabyAIBot` plans for env
  ``index`` of a batch;
* :func:`host_snapshot` pulls the fields the bot reads, for all B envs of a
  batch, to the host in one transfer, and every bot of the batch plans
  from that snapshot (:func:`run_bots` drives B bots over one batch-first
  ``step``, which is how the card is used);
* ``marks`` are int32 here (uint16 in JAX); the bot widens them to int64
  either way.

It is a re-derivation of the reference ``BabyAIBot`` (minigrid
``utils/baby_ai_bot.py:549-1026``).  The reference bot plans over a
stateful ``gym.Env`` holding ``WorldObj`` instances and tracks target
objects by Python identity (``ObjDesc.obj_set``).  Here the bot plans over
a NumPy snapshot of the state, and object identity is the mark bit planes
the verifier maintains (``state.marks`` bit k = descriptor slot k, see
``envs/babyai/core.py``), so the bot and the verifier agree on which
objects the mission refers to by construction.

The planner semantics match the reference:

* a stack of subgoals (Close/Open/Drop/Pickup/GoNextTo/Explore) compiled from
  the instruction (baby_ai_bot.py:975-1014),
* a persistent partial-knowledge visibility mask grown from each
  observation's shadow-cast view (:742-739),
* direction-biased breadth-first search with a fall-back that tolerates
  blocking objects (:764-863),
* the drop-position heuristic that avoids disconnecting free space
  (:865-973),
* replan-after-external-action support so the bot can advise a suboptimal
  agent (DAgger oracle mode, :90-148, :602-648).

The planning itself is one env's NumPy on the host; a demonstration
generator runs one bot per env of a batch.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_DONE,
    ACT_DROP,
    ACT_FORWARD,
    ACT_LEFT,
    ACT_PICKUP,
    ACT_RIGHT,
    ACT_TOGGLE,
    DIR_TO_VEC,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_KEY,
    OBJ_WALL,
    STATE_LOCKED,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as bcore


class DisappearedBoxError(Exception):
    """Raised when a box is toggled away — the bot assumes the mission can no
    longer be completed (baby_ai_bot.py:18-28)."""


class PlanThrashingError(Exception):
    """Raised when the planner restructures its subgoal stack hundreds of
    times without producing an action (fetch-key <-> explore livelock).  The
    reference planner has no such valve and simply hangs on these seeds;
    surfacing it lets callers count the seed as a planning *failure* in
    solve-rate measurements instead of masking it."""


def _manhattan(a, b) -> int:
    return abs(int(a[0]) - int(b[0])) + abs(int(a[1]) - int(b[1]))


class Desc:
    """A resolvable object description.

    ``bit`` names a verifier descriptor slot whose identity set lives in the
    mark planes; synthesized descriptions (e.g. "the key for this locked
    door", baby_ai_bot.py:196-197) have ``bit=None`` and match by
    (type, color) over the current grid."""

    __slots__ = ("bit", "type", "color")

    def __init__(self, bit: Optional[int], type_: int, color: int):
        self.bit = bit
        self.type = type_
        self.color = color

    def positions(self, world: "_World") -> list:
        """Current grid positions of matching objects (carried one excluded —
        its mark bit lives in ``carrying_marks``, not on the grid)."""
        if self.bit is not None:
            mask = (world.marks >> self.bit) & 1
        else:
            mask = (world.obj == self.type).astype(np.uint8)
            if self.color != bcore.COLOR_ANY:
                mask &= world.color == self.color
        ys, xs = np.nonzero(mask)
        return [(int(x), int(y)) for x, y in zip(xs, ys)]

    def __repr__(self):
        return f"Desc(bit={self.bit}, type={self.type}, color={self.color})"


@dataclass
class HostState:
    """The fields of a batch-first state that the bot reads, on the host:
    planes ``(B, H, W)``, ``agent_pos (B, 2)``, ``mission (B, 48)``, the
    others ``(B,)``; ``reward`` is the step's reward, or None."""

    grid_obj: np.ndarray
    grid_color: np.ndarray
    grid_state: np.ndarray
    marks: np.ndarray
    agent_pos: np.ndarray
    agent_dir: np.ndarray
    carrying_obj: np.ndarray
    carrying_color: np.ndarray
    carrying_marks: np.ndarray
    terminated: np.ndarray
    truncated: np.ndarray
    mission: np.ndarray
    reward: Optional[np.ndarray] = None


_PLANES = ("grid_obj", "grid_color", "grid_state", "marks")
_VECTORS = ("agent_pos", "mission")
_SCALARS = ("agent_dir", "carrying_obj", "carrying_color", "carrying_marks",
            "terminated", "truncated")


def host_snapshot(state, reward: Optional[torch.Tensor] = None) -> HostState:
    """The bot's view of every env of a batch-first ``EnvState`` (and the
    step's ``reward``), pulled to the host in one transfer: the fields are
    packed into one int32 tensor on their device first."""
    b, h, w = state.grid_obj.shape
    parts = [getattr(state, n).reshape(b, -1).to(torch.int32) for n in _PLANES + _VECTORS]
    parts += [getattr(state, n).reshape(b, 1).to(torch.int32) for n in _SCALARS]
    if reward is not None:
        parts.append(reward.to(torch.float32).reshape(b, 1).view(torch.int32))
    flat = torch.cat(parts, dim=1).cpu().numpy()
    out, col = {}, 0
    for name, width in ([(n, h * w) for n in _PLANES]
                        + [(n, getattr(state, n).shape[1]) for n in _VECTORS]
                        + [(n, 1) for n in _SCALARS]):
        out[name] = flat[:, col:col + width]
        col += width
    for n in _PLANES:
        out[n] = out[n].reshape(b, h, w)
    for n in _SCALARS:
        out[n] = out[n][:, 0]
    out["terminated"] = out["terminated"].astype(bool)
    out["truncated"] = out["truncated"].astype(bool)
    if reward is not None:
        out["reward"] = np.ascontiguousarray(flat[:, col]).view(np.float32)
    return HostState(**out)


class _World:
    """NumPy snapshot of env ``index`` of a batch-first state (an
    ``EnvState``, or a :class:`HostState` already on the host) with cell
    helpers.

    Planes are indexed ``[y, x]``; positions are ``(x, y)`` tuples like the
    reference's ``agent_pos``."""

    def __init__(self, state, index: int = 0):
        if not isinstance(state, HostState):
            state = host_snapshot(state)
        self.obj = state.grid_obj[index]
        self.color = state.grid_color[index]
        self.st = state.grid_state[index]
        self.marks = state.marks[index].astype(np.int64)
        self.agent_pos = (int(state.agent_pos[index, 0]), int(state.agent_pos[index, 1]))
        self.agent_dir = int(state.agent_dir[index])
        self.carrying = int(state.carrying_obj[index])
        self.carrying_color = int(state.carrying_color[index])
        self.carrying_marks = int(state.carrying_marks[index])
        self.mission = state.mission[index]
        self.height, self.width = self.obj.shape

    # -- cell predicates ------------------------------------------------
    def in_bounds(self, pos) -> bool:
        x, y = pos
        return 0 <= x < self.width and 0 <= y < self.height

    def cell(self, pos) -> Tuple[int, int, int]:
        """(type, color, state) at pos; walls outside the grid."""
        if not self.in_bounds(pos):
            return OBJ_WALL, 0, 0
        x, y = pos
        return int(self.obj[y, x]), int(self.color[y, x]), int(self.st[y, x])

    def is_empty(self, pos) -> bool:
        return self.cell(pos)[0] == OBJ_EMPTY

    def is_open_door(self, pos) -> bool:
        t, _, s = self.cell(pos)
        return t == OBJ_DOOR and s == STATE_OPEN

    def is_locked_door(self, pos) -> bool:
        t, _, s = self.cell(pos)
        return t == OBJ_DOOR and s == STATE_LOCKED

    def steppable(self, pos) -> bool:
        """Empty or open door (GoNextToSubgoal's ``steppable``,
        baby_ai_bot.py:354-355)."""
        return self.is_empty(pos) or self.is_open_door(pos)

    # -- agent frame ------------------------------------------------------
    @property
    def dir_vec(self):
        return (int(DIR_TO_VEC[self.agent_dir][0]), int(DIR_TO_VEC[self.agent_dir][1]))

    @property
    def right_vec(self):
        dx, dy = self.dir_vec
        return (-dy, dx)

    @property
    def fwd_pos(self):
        d = self.dir_vec
        return (self.agent_pos[0] + d[0], self.agent_pos[1] + d[1])


# ---------------------------------------------------------------------------
# Subgoals (baby_ai_bot.py:35-546).  Each returns a suggested action from
# ``plan()`` or None after restructuring the stack.
# ---------------------------------------------------------------------------


class _Subgoal:
    def __init__(self, bot: "BabyAIBot", datum=None, reason=None):
        self.bot = bot
        self.datum = datum
        self.reason = reason

    @property
    def world(self) -> _World:
        return self.bot.world

    def plan(self):  # replan_before_action
        raise NotImplementedError

    def adjust(self, action_taken):  # replan_after_action
        pass

    def exploratory(self) -> bool:
        return False

    def __repr__(self):
        r = type(self).__name__
        if self.datum is not None:
            r += f"[{self.datum}]"
        if self.reason is not None:
            r += f"({self.reason})"
        return r

    # Undo support for advising mode (baby_ai_bot.py:110-148): when the agent
    # took an action the plan did not call for, schedule its reversal.
    def _undo(self, action_taken):
        bot, w = self.bot, self.world
        if action_taken == ACT_FORWARD:
            if bot.prev_agent_pos != w.agent_pos:
                bot.stack.append(_GoNextTo(bot, ("pos", bot.prev_agent_pos)))
        elif action_taken == ACT_LEFT:
            r = w.right_vec
            bot.stack.append(
                _GoNextTo(bot, ("pos", (w.agent_pos[0] + r[0], w.agent_pos[1] + r[1])))
            )
        elif action_taken == ACT_RIGHT:
            r = w.right_vec
            bot.stack.append(
                _GoNextTo(bot, ("pos", (w.agent_pos[0] - r[0], w.agent_pos[1] - r[1])))
            )
        elif action_taken == ACT_DROP and bot.prev_carrying != w.carrying:
            bot.stack.append(_Pickup(bot))
        elif action_taken == ACT_PICKUP and bot.prev_carrying != w.carrying:
            bot.stack.append(_Drop(bot))
        elif action_taken == ACT_TOGGLE:
            t, _, s = w.cell(w.fwd_pos)
            if t == OBJ_DOOR and bot.fwd_door_was_open != (s == STATE_OPEN):
                bot.stack.append(
                    _Close(bot) if s == STATE_OPEN else _Open(bot)
                )


class _Close(_Subgoal):
    def plan(self):
        t, _, s = self.world.cell(self.world.fwd_pos)
        assert t == OBJ_DOOR and s == STATE_OPEN, "expected an open door ahead"
        return ACT_TOGGLE

    def adjust(self, action_taken):
        if action_taken is None or action_taken == ACT_TOGGLE:
            self.bot.stack.pop()
        elif action_taken in (ACT_FORWARD, ACT_LEFT, ACT_RIGHT):
            self._undo(action_taken)


class _Open(_Subgoal):
    """Open the door ahead; if locked, plan fetching its key first
    (baby_ai_bot.py:169-262).  ``reason`` is None, "Unlock" (drop the key
    afterwards) or "KeepKey"."""

    def plan(self):
        bot, w = self.bot, self.world
        fwd = w.fwd_pos
        t, door_color, s = w.cell(fwd)
        assert t == OBJ_DOOR, "expected a door ahead"

        have_key = w.carrying == OBJ_KEY and w.carrying_color == door_color
        if s == STATE_LOCKED and not have_key:
            key_desc = Desc(None, OBJ_KEY, door_color)
            if w.carrying != OBJ_EMPTY:
                bot.stack.pop()
                park = bot._find_drop_pos()
                bot.stack.append(_Pickup(bot))
                bot.stack.append(_GoNextTo(bot, ("pos", park)))
                bot.stack.append(_Open(bot))
                bot.stack.append(_GoNextTo(bot, ("pos", fwd)))
                bot.stack.append(_Pickup(bot))
                bot.stack.append(_GoNextTo(bot, ("desc", key_desc)))
                bot.stack.append(_Drop(bot))
                bot.stack.append(_GoNextTo(bot, ("pos", park)))
            else:
                bot.stack.pop()
                bot.stack.append(_Open(bot))
                bot.stack.append(_GoNextTo(bot, ("pos", fwd)))
                bot.stack.append(_Pickup(bot))
                bot.stack.append(_GoNextTo(bot, ("desc", key_desc)))
            return None

        if s == STATE_OPEN:
            bot.stack.append(_Close(bot))
            return None

        if s == STATE_LOCKED and self.reason is None:
            bot.stack.pop()
            bot.stack.append(_Open(bot, reason="Unlock"))
            return None

        return ACT_TOGGLE

    def adjust(self, action_taken):
        if action_taken is None or action_taken == ACT_TOGGLE:
            self.bot.stack.pop()
            if self.reason == "Unlock":
                # The drop spot is chosen only now: a spot picked earlier
                # could be occupied by the time the key lands there
                # (baby_ai_bot.py:253-260).
                spot = self.bot._find_drop_pos()
                self.bot.stack.append(_Drop(self.bot))
                self.bot.stack.append(_GoNextTo(self.bot, ("pos", spot)))
        else:
            self._undo(action_taken)


class _Drop(_Subgoal):
    def plan(self):
        assert self.world.carrying != OBJ_EMPTY, "nothing to drop"
        assert self.world.is_empty(self.world.fwd_pos), "drop cell occupied"
        return ACT_DROP

    def adjust(self, action_taken):
        if action_taken is None or action_taken == ACT_DROP:
            self.bot.stack.pop()
        elif action_taken in (ACT_FORWARD, ACT_LEFT, ACT_RIGHT):
            self._undo(action_taken)


class _Pickup(_Subgoal):
    def plan(self):
        assert self.world.carrying == OBJ_EMPTY, "hands already full"
        return ACT_PICKUP

    def adjust(self, action_taken):
        if action_taken is None or action_taken == ACT_PICKUP:
            self.bot.stack.pop()
        elif action_taken in (ACT_LEFT, ACT_RIGHT):
            self._undo(action_taken)


class _GoNextTo(_Subgoal):
    """Navigate until the agent faces the target (baby_ai_bot.py:294-487).

    ``datum`` is ``("pos", (x, y))``, ``("door", (x, y))`` (a door whose lock
    state must be re-read each replan) or ``("desc", Desc)``.  ``reason`` is
    None, "Open", "PutNext" or "Explore"."""

    def plan(self):
        bot, w = self.bot, self.world
        kind, payload = self.datum
        target_is_door = False
        if kind == "desc":
            target_pos = bot._find_obj_pos(payload, self.reason == "PutNext")
            if target_pos is None:
                bot.stack.append(_Explore(bot))
                return None
            target_is_door = w.cell(target_pos)[0] == OBJ_DOOR
        else:
            target_pos = tuple(payload)
            target_is_door = kind == "door" or w.cell(target_pos)[0] == OBJ_DOOR

        # Walking toward a locked door to open it while empty-handed: commit
        # to fetching the key first (baby_ai_bot.py:330-346).
        if (
            self.reason == "Open"
            and target_is_door
            and w.is_locked_door(target_pos)
            and w.carrying == OBJ_EMPTY
        ):
            door_color = w.cell(target_pos)[1]
            bot.stack.pop()
            bot.stack.append(_GoNextTo(bot, ("door", target_pos), reason="Open"))
            bot.stack.append(_Pickup(bot))
            bot.stack.append(_GoNextTo(bot, ("desc", Desc(None, OBJ_KEY, door_color))))
            return None

        # Standing on (or, for PutNext, right beside) the target: step off it
        # (baby_ai_bot.py:348-368).
        if _manhattan(target_pos, w.agent_pos) == (1 if self.reason == "PutNext" else 0):
            r = w.right_vec
            if w.steppable(w.fwd_pos):
                return ACT_FORWARD
            if w.steppable((w.agent_pos[0] + r[0], w.agent_pos[1] + r[1])):
                return ACT_RIGHT
            if w.steppable((w.agent_pos[0] - r[0], w.agent_pos[1] - r[1])):
                return ACT_LEFT
            return ACT_LEFT  # spin in place and hope

        # Facing the goal cell: done (baby_ai_bot.py:370-388).
        if self.reason == "PutNext":
            if _manhattan(target_pos, w.fwd_pos) == 1:
                if w.is_empty(w.fwd_pos):
                    bot.stack.pop()
                    return None
                if w.is_open_door(w.fwd_pos):
                    # Can't put an object in a doorway; shove the mover two
                    # cells past the door instead (baby_ai_bot.py:377-384).
                    d = w.dir_vec
                    beyond = (w.fwd_pos[0] + 2 * d[0], w.fwd_pos[1] + 2 * d[1])
                    bot.stack.append(_GoNextTo(bot, ("pos", beyond)))
                    return None
        elif target_pos == w.fwd_pos:
            bot.stack.pop()
            return None

        # Path-find, preferring blocker-free routes (baby_ai_bot.py:390-408).
        path, _, _ = bot._shortest_path(lambda p: p == target_pos)
        if not path:
            path, _, _ = bot._shortest_path(
                lambda p: p == target_pos, with_blockers=True
            )
        if not path:
            bot.stack.append(_Explore(bot))
            return None

        next_cell = path[0]
        if next_cell == w.fwd_pos:
            t, _, s = w.cell(next_cell)
            if t != OBJ_EMPTY:
                if t == OBJ_DOOR:
                    assert s != STATE_LOCKED
                    if s != STATE_OPEN:
                        bot.stack.append(_Open(bot))
                        return None
                    return ACT_FORWARD
                # A blocker sits on the path: relocate it
                # (baby_ai_bot.py:425-447).
                if w.carrying != OBJ_EMPTY:
                    park = bot._find_drop_pos()
                    stash = bot._find_drop_pos(park)
                    bot.stack.append(_Pickup(bot))
                    bot.stack.append(_GoNextTo(bot, ("pos", park)))
                    bot.stack.append(_Drop(bot))
                    bot.stack.append(_GoNextTo(bot, ("pos", stash)))
                    bot.stack.append(_Pickup(bot))
                    bot.stack.append(_GoNextTo(bot, ("pos", w.fwd_pos)))
                    bot.stack.append(_Drop(bot))
                    bot.stack.append(_GoNextTo(bot, ("pos", park)))
                else:
                    stash = bot._find_drop_pos()
                    bot.stack.append(_Drop(bot))
                    bot.stack.append(_GoNextTo(bot, ("pos", stash)))
                    bot.stack.append(_Pickup(bot))
                return None
            return ACT_FORWARD

        # Turn toward the next path cell (baby_ai_bot.py:451-476).
        r = w.right_vec
        delta = (next_cell[0] - w.agent_pos[0], next_cell[1] - w.agent_pos[1])
        if delta == r:
            return ACT_RIGHT
        if delta == (-r[0], -r[1]):
            return ACT_LEFT
        # The cell is behind us: turn toward the side with more open space.
        dist_right = bot._free_run(w.agent_pos, r)
        dist_left = bot._free_run(w.agent_pos, (-r[0], -r[1]))
        return ACT_LEFT if dist_left > dist_right else ACT_RIGHT

    def adjust(self, action_taken):
        if action_taken in (ACT_PICKUP, ACT_DROP, ACT_TOGGLE):
            self._undo(action_taken)

    def exploratory(self):
        return self.reason == "Explore"


class _Explore(_Subgoal):
    def plan(self):
        bot, w = self.bot, self.world

        # Head for the closest cell never yet observed (baby_ai_bot.py:491-501).
        _, frontier, _ = bot._shortest_path(
            lambda p: not bot.vis[p[1], p[0]], with_blockers=True
        )
        if frontier is not None:
            bot.stack.append(_GoNextTo(bot, ("pos", frontier), reason="Explore"))
            return None

        # Everything observed: open the nearest closed door, trying unlocked
        # doors before locked ones so unlocking can't recurse forever
        # (baby_ai_bot.py:503-524).  Beyond the reference, locked doors whose
        # matching key has never been observed rank last — the reference can
        # livelock committing to a door it cannot unlock yet (e.g.
        # UnlockToUnlock when the first explored door is the second lock).
        def key_obtainable(p):
            color = w.cell(p)[1]
            have = w.carrying == OBJ_KEY and w.carrying_color == color
            return have or any(
                self.bot.vis[y, x]
                for (x, y) in Desc(None, OBJ_KEY, color).positions(w)
            )

        def closed_unlocked(p):
            t, _, s = w.cell(p)
            return t == OBJ_DOOR and s != STATE_OPEN and s != STATE_LOCKED

        def unlockable(p):
            t, _, s = w.cell(p)
            return t == OBJ_DOOR and s == STATE_LOCKED and key_obtainable(p)

        def closed(p):
            t, _, s = w.cell(p)
            return t == OBJ_DOOR and s != STATE_OPEN

        door_pos = None
        for probe in (closed_unlocked, unlockable, closed):
            _, door_pos, _ = bot._shortest_path(probe, with_blockers=True)
            if door_pos is not None:
                break

        if door_pos is not None:
            _, door_color, s = w.cell(door_pos)
            have_key = (
                w.carrying == OBJ_KEY and w.carrying_color == door_color
            )
            reason = "KeepKey" if s == STATE_LOCKED and have_key else None
            bot.stack.pop()
            bot.stack.append(_Open(bot, reason=reason))
            bot.stack.append(_GoNextTo(bot, ("door", door_pos), reason="Open"))
            return None

        raise AssertionError("nothing left to explore")

    def exploratory(self):
        return True


# ---------------------------------------------------------------------------
# The bot
# ---------------------------------------------------------------------------


class BabyAIBot:
    """Plans optimal-ish actions for any BabyAI level of this framework.

    Usage (batch-first env loop; one bot per env of the batch, all
    planning from one host snapshot per step)::

        env = port.make("BabyAI-GoToLocal-v0")
        obs, state = env.reset(generator, B, device="cuda")
        snap = host_snapshot(state)
        bots = [BabyAIBot(env, snap, i) for i in range(B)]
        while True:
            actions = [bot.replan(snap, last[i]) for i, bot in enumerate(bots)]
            obs, state, r, term, trunc, _ = env.step(state, torch.tensor(actions))
            snap = host_snapshot(state, r)

    (:func:`run_bots` is that loop.)  Mirrors the reference bot's knowledge
    model: it only path-plans through cells it has visually observed
    (tracked in ``self.vis``), even though the full state is available —
    otherwise it could not generate realistic demonstrations for partially
    observed levels.

    Known-unsolvable levels match the reference
    (baby_ai_bot.py:564-570): PutNext*Carrying (starts carrying the mover,
    which the plan cannot represent) and KeyInBox (opening the box destroys
    it, raising :class:`DisappearedBoxError`).
    """

    def __init__(self, env, state, index: int = 0):
        self.env = env
        self.params = env.params
        self.index = index
        self.world = _World(state, index)
        self.vis = np.zeros((self.params.height, self.params.width), dtype=bool)
        self.stack: list = []
        self._compile_mission(self.world.mission)
        self.bfs_counter = 0
        self.bfs_step_counter = 0
        self.prev_agent_pos = None
        self.prev_carrying = None
        self.prev_fwd_type = None
        self.fwd_door_was_open = None

    # -- public API -------------------------------------------------------
    def replan(self, state, action_taken=None) -> int:
        """Advance the plan one step and return the suggested action.

        ``state`` is the batch (or its :class:`HostState`) holding this
        bot's env at ``index``; ``action_taken`` is the action the agent
        actually took since the last call (None means "the suggestion was
        followed")."""
        self.world = _World(state, self.index)
        self._absorb_view()

        if (
            action_taken == ACT_TOGGLE
            and self.prev_fwd_type == OBJ_BOX
        ):
            raise DisappearedBoxError("a box was opened; mission may be lost")

        if self.stack:
            self.stack[-1].adjust(action_taken)
        while self.stack and self.stack[-1].exploratory():
            self.stack.pop()

        suggested = None
        restructures = 0
        while self.stack:
            suggested = self.stack[-1].plan()
            if suggested is not None:
                break
            restructures += 1
            # The reference planner can livelock restructuring the stack
            # (fetch-key <-> explore cycles); surface that as a planning
            # failure instead of hanging.
            if restructures >= 500:
                raise PlanThrashingError(f"plan thrashing: {self.stack[-6:]}")
        if not self.stack:
            suggested = ACT_DONE

        self._remember()
        return int(suggested)

    # -- mission compilation (baby_ai_bot.py:975-1014) ---------------------
    def _compile_mission(self, codes: np.ndarray) -> None:
        comb = int(codes[0])
        if comb == bcore.COMB_BEFORE:
            order = [1, 0]  # push B first so A runs first
        elif comb == bcore.COMB_AFTER:
            order = [0, 1]  # push A first so B runs first
        else:
            order = [0]
        for c in order:
            if int(codes[bcore.CLAUSE_OFF[c]]) == 1:  # and-pair
                self._compile_leaf(codes, c, 1)
                self._compile_leaf(codes, c, 0)
            else:
                self._compile_leaf(codes, c, 0)

    def _compile_leaf(self, codes: np.ndarray, c: int, l: int) -> None:
        base = bcore.CLAUSE_OFF[c] + bcore.LEAF_OFF[l]
        kind = int(codes[base])
        if kind == bcore.KIND_NONE:
            return

        def desc(d: int) -> Desc:
            off = base + 2 + d * 4
            return Desc(
                (c * 2 + l) * 2 + d, int(codes[off]), int(codes[off + 1])
            )

        if kind == bcore.KIND_GOTO:
            self.stack.append(_GoNextTo(self, ("desc", desc(0))))
        elif kind == bcore.KIND_OPEN:
            self.stack.append(_Open(self))
            self.stack.append(_GoNextTo(self, ("desc", desc(0)), reason="Open"))
        elif kind == bcore.KIND_PICKUP:
            # Pick up then drop again, freeing the hands for later legs of
            # the mission (baby_ai_bot.py:989-995); the verifier fires at the
            # pickup moment.
            self.stack.append(_Drop(self))
            self.stack.append(_Pickup(self))
            self.stack.append(_GoNextTo(self, ("desc", desc(0))))
        elif kind == bcore.KIND_PUTNEXT:
            self.stack.append(_Drop(self))
            self.stack.append(_GoNextTo(self, ("desc", desc(1)), reason="PutNext"))
            self.stack.append(_Pickup(self))
            self.stack.append(_GoNextTo(self, ("desc", desc(0))))
        else:
            # A decoding fault, not a planner outcome: run_bots lets it out.
            raise ValueError(f"unknown instruction kind {kind}")

    # -- perception --------------------------------------------------------
    def _absorb_view(self) -> None:
        """Grow the persistent visibility mask by the agent's current
        shadow-cast egocentric view (baby_ai_bot.py:711-739)."""
        w = self.world
        view = self.params.agent_view_size
        hs = view // 2
        d = np.asarray(w.dir_vec)
        r = np.asarray(w.right_vec)

        vy = np.arange(view)[:, None]
        vx = np.arange(view)[None, :]
        wx = w.agent_pos[0] + d[0] * (view - 1 - vy) + r[0] * (vx - hs)
        wy = w.agent_pos[1] + d[1] * (view - 1 - vy) + r[1] * (vx - hs)
        inb = (wx >= 0) & (wx < w.width) & (wy >= 0) & (wy < w.height)

        if self.params.see_through_walls:
            seen = np.ones((view, view), dtype=bool)
        else:
            cx = np.clip(wx, 0, w.width - 1)
            cy = np.clip(wy, 0, w.height - 1)
            obj = np.where(inb, w.obj[cy, cx], OBJ_WALL)
            st = np.where(inb, w.st[cy, cx], 0)
            opaque = (obj == OBJ_WALL) | ((obj == OBJ_DOOR) & (st != STATE_OPEN))
            seen = _sweep_visibility(~opaque)

        m = seen & inb
        self.vis[wy[m], wx[m]] = True

    def _remember(self) -> None:
        w = self.world
        self.prev_agent_pos = w.agent_pos
        self.prev_carrying = w.carrying
        t, _, s = w.cell(w.fwd_pos)
        self.prev_fwd_type = t if t != OBJ_EMPTY else None
        if t == OBJ_DOOR:
            self.fwd_door_was_open = s == STATE_OPEN

    # -- search ------------------------------------------------------------
    def _bfs(self, seeds, accept, through_blockers):
        """Direction-biased BFS over observed cells (baby_ai_bot.py:764-824).

        ``seeds`` are (x, y, dx, dy) states; straight-ahead neighbors enqueue
        first so paths prefer not to turn.  Returns (path goal→seed exclusive
        of nothing, goal, parents)."""
        self.bfs_counter += 1
        w = self.world
        parents: dict = {}
        queue = deque((s, None) for s in seeds)
        while queue:
            (x, y, dx, dy), prev = queue.popleft()
            if (x, y) in parents:
                continue
            self.bfs_step_counter += 1
            parents[(x, y)] = prev
            if accept((x, y)):
                path = []
                cur = (x, y)
                while cur is not None:
                    path.append(cur)
                    cur = parents[cur]
                return path, (x, y), parents
            if not self.vis[y, x]:
                continue  # never expand through unobserved cells
            t, _, s = w.cell((x, y))
            if t != OBJ_EMPTY:
                if t == OBJ_WALL:
                    continue
                if t == OBJ_DOOR:
                    if s != STATE_OPEN:
                        continue
                elif not through_blockers:
                    continue
            for k, l in ((dx, dy), (dy, dx), (-dy, -dx), (-dx, -dy)):
                queue.append(((x + k, y + l, k, l), (x, y)))
        return None, None, parents

    def _shortest_path(self, accept, with_blockers=False):
        """Path to the nearest accepted cell, avoiding blockers for as long
        as possible (baby_ai_bot.py:826-863).  Returns
        (path agent-exclusive → goal, goal, used_blockers)."""
        w = self.world
        seeds = [(*w.agent_pos, *w.dir_vec)]
        used_blockers = False
        path, goal, parents = self._bfs(seeds, accept, through_blockers=False)
        if path is None and with_blockers:
            used_blockers = True
            path, goal, _ = self._bfs(
                [(x, y, 1, 0) for (x, y) in parents], accept, through_blockers=True
            )
            if path is not None:
                # Splice the blocker-free prefix back on: path currently ends
                # at a cell the first search already reached.
                cur = parents[path[-1]]
                while cur is not None:
                    path.append(cur)
                    cur = parents[cur]
        if path is not None:
            path = path[::-1][1:]
        return path, goal, used_blockers

    def _find_obj_pos(self, desc: Desc, adjacent: bool = False):
        """Position of the closest observed object matching ``desc``
        (baby_ai_bot.py:650-709), with the blocked-path and standing-on-it
        distance penalties."""
        w = self.world
        best_pos = None
        best_dist = 999
        for pos in desc.positions(w):
            if not self.vis[pos[1], pos[0]]:
                continue
            path, _, blocked = self._shortest_path(
                lambda p: p == pos, with_blockers=True
            )
            if path is None:
                continue
            dist = len(path)
            if blocked:
                # Lower bound on the unblocking detour: pick/turn/drop/turn
                # (4), or 7 with full hands (baby_ai_bot.py:674-685).
                dist += 7 if w.carrying != OBJ_EMPTY else 4
            if dist == 0:
                dist = 3 if adjacent else 2
            if adjacent and dist == 1:
                dist = 3
            if dist < best_dist:
                best_dist = dist
                best_pos = pos
        return best_pos

    def _free_run(self, pos, direction) -> int:
        """Distance to the nearest in-view wall or door along ``direction``
        (baby_ai_bot.py:751-762)."""
        w = self.world
        dist = 1
        while True:
            probe = (pos[0] + dist * direction[0], pos[1] + dist * direction[1])
            if not self._in_view(probe):
                return dist - 1
            t = w.cell(probe)[0]
            if t in (OBJ_WALL, OBJ_DOOR):
                return dist
            dist += 1

    def _in_view(self, pos) -> bool:
        """Whether ``pos`` lies inside the current egocentric view rectangle
        (MiniGridEnv.in_view, minigrid_env.py:495-501)."""
        w = self.world
        view = self.params.agent_view_size
        hs = view // 2
        rel = (pos[0] - w.agent_pos[0], pos[1] - w.agent_pos[1])
        d, r = w.dir_vec, w.right_vec
        along = rel[0] * d[0] + rel[1] * d[1]
        across = rel[0] * r[0] + rel[1] * r[1]
        return 0 <= view - 1 - along < view and 0 <= across + hs < view

    def _find_drop_pos(self, except_pos=None):
        """A reachable empty cell to park an object, preferring spots whose
        8-neighborhood stays connected after the drop (baby_ai_bot.py:865-973)."""
        w = self.world
        agent = w.agent_pos

        def basic_ok(pos):
            if pos == agent or (except_pos is not None and pos == except_pos):
                return False
            if not w.in_bounds(pos) or not self.vis[pos[1], pos[0]]:
                return False
            return w.is_empty(pos)

        ring = ((-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0))

        def tidy_ok(pos):
            if not basic_ok(pos):
                return False
            # Classify the 8 neighbors: 0 = free, 1 = wall, 2 = object /
            # unknown (may hold an object, incl. except_pos).
            classes = []
            for k, l in ring:
                nb = (pos[0] + k, pos[1] + l)
                t, _, s = w.cell(nb)
                seen = w.in_bounds(nb) and self.vis[nb[1], nb[0]]
                if seen and t == OBJ_WALL:
                    classes.append(1)
                elif (
                    seen
                    and nb != except_pos
                    and (t == OBJ_EMPTY or (t == OBJ_DOOR and s == STATE_OPEN) or nb == agent)
                ):
                    classes.append(0)
                else:
                    classes.append(2)
            # Free cells around the candidate must stay one connected arc...
            changes = sum(
                bool(classes[(i + 1) % 8]) != bool(classes[i]) for i in range(8)
            )
            if changes > 2:
                return False
            # ...and every adjacent object must keep a free cell beside it.
            for i in range(8):
                if (
                    classes[i] == 2
                    and classes[(i + 1) % 8] != 0
                    and classes[(i + 7) % 8] != 0
                ):
                    return False
            return True

        for accept, blockers in (
            (tidy_ok, False),
            (basic_ok, False),
            (tidy_ok, True),
            (basic_ok, True),
        ):
            _, spot, _ = self._shortest_path(accept, with_blockers=blockers)
            if spot is not None:
                return spot
        return None


# What ends one bot's run in run_bots: the two errors above, and the
# AssertionError of the planner's own checks ("nothing to drop"), which
# JAX's bot raises on the same states after the same actions
# (tests/test_torch_babyai_bot.py holds it on PickupDist layouts).  Any other
# error, a mission that does not decode among them, leaves run_bots.
PLANNER_ERRORS = (DisappearedBoxError, PlanThrashingError, AssertionError)


@dataclass
class BotRun:
    """Outcome of :func:`run_bots`, per env of the batch."""

    solved: np.ndarray  # (B,) bool: terminated with a positive reward
    steps: np.ndarray  # (B,) int: steps taken until the episode ended
    reward: np.ndarray  # (B,) f32: the reward of the last step taken
    errors: list  # (B,) "Name: message" of the planner error that ended the run, or None
    actions: np.ndarray  # (T, B) i32: the action each env took, -1 once it ended


def run_bots(env, state, max_steps: int = 240) -> BotRun:
    """One :class:`BabyAIBot` per env of the batch-first ``state``, all
    stepped together by ``env.step`` until every episode has ended (it
    terminated, truncated, or its bot raised one of ``PLANNER_ERRORS``) or
    ``max_steps`` steps.  Each step moves
    one host snapshot to the host and one action vector to the device.
    ``actions`` holds the demonstrations.  Envs whose episode ended are
    stepped on with action 0 (turn left), and what they do is ignored."""
    b = state.agent_dir.shape[0]
    dev = state.agent_dir.device
    snap = host_snapshot(state)
    bots = [BabyAIBot(env, snap, i) for i in range(b)]
    active = np.ones(b, dtype=bool)
    solved = np.zeros(b, dtype=bool)
    steps = np.zeros(b, dtype=np.int64)
    reward = np.zeros(b, dtype=np.float32)
    errors = [None] * b
    last = [None] * b
    taken = []
    for _ in range(max_steps):
        actions = np.zeros(b, dtype=np.int32)
        for i in np.flatnonzero(active):
            try:
                actions[i] = bots[i].replan(snap, last[i])
            except PLANNER_ERRORS as e:
                active[i] = False
                errors[i] = f"{type(e).__name__}: {e}"
        if not active.any():
            break
        _, state, r, _, _, _ = env.step(state, torch.from_numpy(actions).to(dev))
        taken.append(np.where(active, actions, -1))
        snap = host_snapshot(state, r)
        for i in np.flatnonzero(active):
            last[i] = int(actions[i])
            steps[i] += 1
            reward[i] = snap.reward[i]
            if snap.terminated[i]:
                solved[i] = snap.reward[i] > 0
                active[i] = False
            elif snap.truncated[i]:
                active[i] = False
    actions = np.stack(taken) if taken else np.zeros((0, b), np.int32)
    return BotRun(solved=solved, steps=steps, reward=reward, errors=errors, actions=actions)


def _sweep_visibility(see_through: np.ndarray) -> np.ndarray:
    """NumPy twin of the device visibility sweep (ops/obs.py:process_vis /
    reference grid.py:291-328) over a (view, view) ``[vy, vx]`` map with the
    agent at the bottom-center, facing up."""
    view = see_through.shape[0]
    mask = np.zeros_like(see_through)
    mask[view - 1, view // 2] = True
    for j in range(view - 1, -1, -1):
        for i in range(view - 1):
            if mask[j, i] and see_through[j, i]:
                mask[j, i + 1] = True
                if j > 0:
                    mask[j - 1, i + 1] = True
                    mask[j - 1, i] = True
        for i in range(view - 1, 0, -1):
            if mask[j, i] and see_through[j, i]:
                mask[j, i - 1] = True
                if j > 0:
                    mask[j - 1, i - 1] = True
                    mask[j - 1, i] = True
    return mask
