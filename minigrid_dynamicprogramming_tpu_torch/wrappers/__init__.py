"""Observation, action and reward wrappers over the batch-first environment.

Counterpart of ``minigrid_dynamicprogramming_tpu/wrappers/__init__.py``, the
reference's wrapper suite (minigrid ``wrappers.py``).  A wrapper wraps an
:class:`~minigrid_dynamicprogramming_tpu_torch.core.env.Environment` (or
another wrapper) and keeps its batch-first surface::

    reset(generator, batch_size=1, device="cuda") -> (obs, state)
    step(state, action, generator=None)
        -> (obs, state, reward, terminated, truncated, info)

where JAX's wrappers are one env's functions that ``vmap`` batches.  Every
tensor a wrapper makes lies on the device of the state it was given.

Wrappers that carry their own state across steps (the visit counters)
thread it through a :class:`WrapperState` beside the inner state, as in
JAX; a step returns a new table and leaves the old one as it was.

Mission strings exist only on the host, so ``DictObservationSpaceWrapper``
and ``FlatObsWrapper`` (when the mission varies per episode) decode each
env's mission codes there and put the stacked result on the state's
device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_FORWARD,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJECT_TO_IDX,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState, resolve_device
from minigrid_dynamicprogramming_tpu_torch.ops.obs import gen_obs_image
from minigrid_dynamicprogramming_tpu_torch.parallel.lanes import MAX_VIEW, _dir_vec
from minigrid_dynamicprogramming_tpu_torch.render import render_frame, render_pov

__all__ = [
    "Wrapper",
    "WrapperState",
    "core_state",
    "ReseedWrapper",
    "ActionBonus",
    "PositionBonus",
    "ImgObsWrapper",
    "OneHotPartialObsWrapper",
    "RGBImgObsWrapper",
    "RGBImgPartialObsWrapper",
    "FullyObsWrapper",
    "DictObservationSpaceWrapper",
    "FlatObsWrapper",
    "ViewSizeWrapper",
    "DirectionObsWrapper",
    "SymbolicObsWrapper",
    "StochasticActionWrapper",
    "NoDeath",
    "get_minigrid_words",
]


@dataclass
class WrapperState:
    """Inner env state plus one wrapper's own data."""

    inner: Any
    data: Any

    def replace(self, **changes) -> "WrapperState":
        return dataclasses.replace(self, **changes)


def core_state(state) -> EnvState:
    """Unwrap nested WrapperStates down to the core :class:`EnvState`."""
    while isinstance(state, WrapperState):
        state = state.inner
    return state


def _actions(state, action) -> torch.Tensor:
    """``action`` as a ``(B,)`` tensor on the state's device."""
    core = core_state(state)
    b = core.agent_dir.shape[0]
    return torch.as_tensor(action, device=core.agent_dir.device).expand(b)


class Wrapper:
    """Base wrapper: transparent delegation."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    @property
    def unwrapped(self) -> Environment:
        e = self.env
        while isinstance(e, Wrapper):
            e = e.env
        return e

    def reset(self, generator: torch.Generator, batch_size: int = 1, device="cuda"):
        return self.env.reset(generator, batch_size, device)

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        return self.env.step(state, action, generator)


class ObservationWrapper(Wrapper):
    """Applies :meth:`observation` to every observation (gymnasium
    ObservationWrapper semantics)."""

    def observation(self, obs, state):
        raise NotImplementedError

    def reset(self, generator: torch.Generator, batch_size: int = 1, device="cuda"):
        obs, state = self.env.reset(generator, batch_size, device)
        return self.observation(obs, state), state

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        obs, new_state, r, term, trunc, info = self.env.step(state, action, generator)
        return self.observation(obs, new_state), new_state, r, term, trunc, info


# ---------------------------------------------------------------------------
# Reward-bonus wrappers (stateful: visit-count tables instead of dicts)
# ---------------------------------------------------------------------------


class ActionBonus(Wrapper):
    """+1/sqrt(N(s, a)) exploration bonus keyed on
    (agent_pos, agent_dir, action) (``wrappers.py:70-125``).  The
    reference's dict of counts becomes a dense ``(B, W, H, 4, n_actions)``
    int32 table carried in :class:`WrapperState`.

    Example (first visit of a (state, action) pair earns bonus 1/sqrt(1)):

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import ActionBonus
        >>> env = ActionBonus(port.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> obs, state, r, term, trunc, _ = env.step(state, 2)
        >>> r.tolist()
        [1.0]
    """

    def reset(self, generator: torch.Generator, batch_size: int = 1, device="cuda"):
        obs, state = self.env.reset(generator, batch_size, device)
        p, core = self.unwrapped.params, core_state(state)
        counts = torch.zeros(
            (batch_size, p.width, p.height, 4, self.unwrapped.action_dim),
            dtype=torch.int32, device=core.agent_dir.device,
        )
        return obs, WrapperState(inner=state, data=counts)

    def step(self, wstate, action, generator: Optional[torch.Generator] = None):
        action = _actions(wstate, action)
        obs, inner, r, term, trunc, info = self.env.step(wstate.inner, action, generator)
        core = core_state(inner)
        rows = torch.arange(action.shape[0], device=action.device)
        idx = (rows, core.agent_pos[:, 0].long(), core.agent_pos[:, 1].long(),
               core.agent_dir.long(), action.long())
        new_count = wstate.data[idx] + 1
        counts = wstate.data.index_put(idx, new_count)
        r = r + 1.0 / torch.sqrt(new_count.to(torch.float32))
        return obs, WrapperState(inner=inner, data=counts), r, term, trunc, info


class PositionBonus(Wrapper):
    """+1/sqrt(N(pos)) exploration bonus keyed on the post-step agent
    position (``wrappers.py:128-187``); the table is ``(B, W, H)`` int32.

    Example:

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import PositionBonus
        >>> env = PositionBonus(port.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> obs, state, r, term, trunc, _ = env.step(state, 0)
        >>> r.tolist()  # turning in place still visits the position once
        [1.0]
    """

    def reset(self, generator: torch.Generator, batch_size: int = 1, device="cuda"):
        obs, state = self.env.reset(generator, batch_size, device)
        p, core = self.unwrapped.params, core_state(state)
        counts = torch.zeros(
            (batch_size, p.width, p.height), dtype=torch.int32, device=core.agent_dir.device
        )
        return obs, WrapperState(inner=state, data=counts)

    def step(self, wstate, action, generator: Optional[torch.Generator] = None):
        obs, inner, r, term, trunc, info = self.env.step(wstate.inner, action, generator)
        core = core_state(inner)
        rows = torch.arange(core.agent_dir.shape[0], device=core.agent_dir.device)
        idx = (rows, core.agent_pos[:, 0].long(), core.agent_pos[:, 1].long())
        new_count = wstate.data[idx] + 1
        counts = wstate.data.index_put(idx, new_count)
        r = r + 1.0 / torch.sqrt(new_count.to(torch.float32))
        return obs, WrapperState(inner=inner, data=counts), r, term, trunc, info


# ---------------------------------------------------------------------------
# Observation wrappers
# ---------------------------------------------------------------------------


class ImgObsWrapper(ObservationWrapper):
    """Image-only observation (``wrappers.py:190-217``).

    Example:

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import ImgObsWrapper
        >>> env = ImgObsWrapper(port.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> tuple(obs.shape)
        (1, 7, 7, 3)
    """

    def observation(self, obs, state):
        return obs["image"]


class OneHotPartialObsWrapper(ObservationWrapper):
    """(B, v, v, 3) symbolic image -> (B, v, v, 20) one-hot of type, color
    and state (``wrappers.py:220-287``); a code out of range gives zeros,
    as ``jax.nn.one_hot`` does.

    Example:

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import (
        ...     OneHotPartialObsWrapper)
        >>> env = OneHotPartialObsWrapper(port.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> tuple(obs["image"].shape)
        (1, 7, 7, 20)
    """

    N_TYPE, N_COLOR, N_STATE = 11, 6, 3

    def observation(self, obs, state):
        img = obs["image"]
        parts = []
        for ch, n in enumerate((self.N_TYPE, self.N_COLOR, self.N_STATE)):
            codes = torch.arange(n, dtype=img.dtype, device=img.device)
            parts.append((img[..., ch, None] == codes).to(torch.uint8))
        return {**obs, "image": torch.cat(parts, dim=-1)}


class RGBImgObsWrapper(ObservationWrapper):
    """Full-grid RGB frames as the image observation
    (``wrappers.py:290-334``), rendered on the state's device.

    Example (5x5 grid at 8px tiles -> 40x40 RGB):

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import RGBImgObsWrapper
        >>> env = RGBImgObsWrapper(port.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> tuple(obs["image"].shape)
        (1, 40, 40, 3)
    """

    def __init__(self, env, tile_size: int = 8, highlight: bool = True):
        super().__init__(env)
        self.tile_size = tile_size
        self.highlight = highlight

    def observation(self, obs, state):
        img = render_frame(self.unwrapped.params, core_state(state), self.tile_size, self.highlight)
        return {**obs, "image": img}


class RGBImgPartialObsWrapper(ObservationWrapper):
    """Agent-POV RGB frames as the image observation
    (``wrappers.py:337-381``).

    Example (7x7 view at 8px tiles -> 56x56 RGB):

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import (
        ...     RGBImgPartialObsWrapper)
        >>> env = RGBImgPartialObsWrapper(port.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> tuple(obs["image"].shape)
        (1, 56, 56, 3)
    """

    def __init__(self, env, tile_size: int = 8):
        super().__init__(env)
        self.tile_size = tile_size

    def observation(self, obs, state):
        img = render_pov(self.unwrapped.params, core_state(state), self.tile_size)
        return {**obs, "image": img}


class FullyObsWrapper(ObservationWrapper):
    """Full symbolic (B, W, H, 3) grid, ``[x, y]``-major, with the agent cell
    encoded as (agent=10, red=0, dir) (``wrappers.py:384-423``).

    Example:

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import FullyObsWrapper
        >>> env = FullyObsWrapper(port.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> tuple(obs["image"].shape)
        (1, 5, 5, 3)
        >>> int((obs["image"][..., 0] == 10).sum())  # exactly one agent cell
        1
    """

    def observation(self, obs, state):
        core = core_state(state)
        img = torch.stack([core.grid_obj, core.grid_color, core.grid_state], dim=-1)
        img = img.transpose(1, 2)  # [x, y]
        b, w, h = img.shape[:3]
        dev = img.device
        xs = torch.arange(w, device=dev)[:, None]
        ys = torch.arange(h, device=dev)[None, :]
        at_agent = (xs == core.agent_pos[:, 0].view(b, 1, 1)) & (ys == core.agent_pos[:, 1].view(b, 1, 1))
        agent = torch.zeros(b, 3, dtype=torch.uint8, device=dev)
        agent[:, 0] = OBJECT_TO_IDX["agent"]
        agent[:, 2] = core.agent_dir.to(torch.uint8)
        img = torch.where(at_agent[..., None], agent[:, None, None, :], img)
        return {**obs, "image": img}


class SymbolicObsWrapper(ObservationWrapper):
    """Full grid of (x, y, obj_idx) triples, ``[x, y]``-major, empty cells
    -1, the agent cell 10 (``wrappers.py:726-772``); int32.

    Example:

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import (
        ...     SymbolicObsWrapper)
        >>> env = SymbolicObsWrapper(port.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> tuple(obs["image"].shape)
        (1, 5, 5, 3)
        >>> int((obs["image"][..., 2] == 10).sum())  # the agent cell
        1
    """

    def observation(self, obs, state):
        core = core_state(state)
        b, h, w = core.grid_obj.shape
        dev = core.grid_obj.device
        objs = torch.where(core.grid_obj == OBJ_EMPTY, -1, core.grid_obj.to(torch.int32))
        objs = objs.transpose(1, 2)  # [x, y]
        xs = torch.arange(w, dtype=torch.int32, device=dev)[:, None].expand(b, w, h)
        ys = torch.arange(h, dtype=torch.int32, device=dev)[None, :].expand(b, w, h)
        at_agent = (xs == core.agent_pos[:, 0].view(b, 1, 1)) & (ys == core.agent_pos[:, 1].view(b, 1, 1))
        objs = torch.where(at_agent, OBJECT_TO_IDX["agent"], objs)
        return {**obs, "image": torch.stack([xs, ys, objs], dim=-1)}


class ViewSizeWrapper(ObservationWrapper):
    """Re-renders the symbolic partial observation at another view size
    (``wrappers.py:626-670``): any odd size from 3 to ``lanes.MAX_VIEW``
    (63), the widest view the visibility sweep holds.

    Example:

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import ViewSizeWrapper
        >>> env = ViewSizeWrapper(port.make("MiniGrid-Empty-5x5-v0"), agent_view_size=5)
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> tuple(obs["image"].shape)
        (1, 5, 5, 3)
    """

    def __init__(self, env, agent_view_size: int = 7):
        super().__init__(env)
        if agent_view_size % 2 != 1 or not 3 <= agent_view_size <= MAX_VIEW:
            raise ValueError(
                f"agent_view_size must be odd and within 3..{MAX_VIEW}, got {agent_view_size}"
            )
        self.agent_view_size = agent_view_size

    def observation(self, obs, state):
        p = self.unwrapped.params.replace(agent_view_size=self.agent_view_size)
        return {**obs, "image": gen_obs_image(p, core_state(state))}


class DirectionObsWrapper(ObservationWrapper):
    """Adds ``goal_direction``: the slope (or arctan angle) toward the first
    goal cell in row-major order, with the reference's coordinate pairing
    (``wrappers.py:673-723``): the goal index is decoded as
    ``(idx // height, idx % width)`` and differenced against
    ``(agent_x, agent_y)`` crosswise, in float32, where the divisor may be
    zero.  The reference caches the goal across all resets of the wrapper
    object; here it comes from each episode's own grid, which is the same
    for every registered env (static goals).

    Example:

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import (
        ...     DirectionObsWrapper)
        >>> env = DirectionObsWrapper(port.make("MiniGrid-Empty-5x5-v0"), type="slope")
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> "goal_direction" in obs
        True
    """

    def __init__(self, env, type: str = "slope"):
        super().__init__(env)
        self.type = type

    def observation(self, obs, state):
        core = core_state(state)
        b, h, w = core.grid_obj.shape
        # Row-major over [j, i]: grid.grid index = j * width + i (grid.py:72);
        # argmax gives the first of ties, as jnp.argmax does.
        goal = (core.grid_obj == OBJ_GOAL).reshape(b, -1).to(torch.uint8)
        idx = torch.argmax(goal, dim=1).to(torch.int32)
        gy = idx // h  # the reference divides by *height* (wrappers.py:705-708)
        gx = idx % w
        slope = (gx - core.agent_pos[:, 1]).to(torch.float32) / (gy - core.agent_pos[:, 0]).to(torch.float32)
        val = torch.arctan(slope) if self.type == "angle" else slope
        return {**obs, "goal_direction": val}


# ---------------------------------------------------------------------------
# Mission-text wrappers (host-side string handling)
# ---------------------------------------------------------------------------


def get_minigrid_words() -> dict:
    """The fixed 50-word vocabulary (``wrappers.py:471-529``)."""
    colors = ["red", "green", "blue", "yellow", "purple", "grey"]
    objects = [
        "unseen", "empty", "wall", "floor", "box", "key", "ball", "door",
        "goal", "agent", "lava",
    ]
    verbs = [
        "pick", "avoid", "get", "find", "put", "use", "open", "go", "fetch",
        "reach", "unlock", "traverse",
    ]
    extra = [
        "up", "the", "a", "at", ",", "square", "and", "then", "to", "of",
        "rooms", "near", "opening", "must", "you", "matching", "end",
        "hallway", "object", "from", "room",
    ]
    words = colors + objects + verbs + extra
    return {w: i for i, w in enumerate(words)}


def _mission_texts(env, obs) -> list:
    """Each env's mission string, decoded on the host."""
    return [env.mission_text(codes) for codes in obs["mission"].cpu().tolist()]


class DictObservationSpaceWrapper(ObservationWrapper):
    """Mission string -> padded word-index vector over the fixed vocabulary
    (``wrappers.py:426-550``): ``(B, max_words_in_mission)`` int64 on the
    state's device.

    Host-side: mission strings exist only on the host, so each env's
    mission codes are decoded there, one env at a time.  On the card, the
    mission code vector ``obs["mission"]`` is already fully numerical.

    Example ("get to the green goal square" over the 50-word vocabulary,
    1-offset, zero-padded):

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import (
        ...     DictObservationSpaceWrapper)
        >>> env = DictObservationSpaceWrapper(port.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> tuple(obs["mission"].shape)
        (1, 50)
        >>> obs["mission"][0, :6].tolist()
        [20, 38, 31, 2, 15, 35]
    """

    def __init__(self, env, max_words_in_mission: int = 50, word_dict=None):
        super().__init__(env)
        self.max_words_in_mission = max_words_in_mission
        self.word_dict = word_dict or get_minigrid_words()

    def string_to_indices(self, string: str, offset: int = 1):
        indices = []
        for word in string.replace(",", " , ").split():
            if word not in self.word_dict:
                raise ValueError(f"Unknown word: {word}")
            indices.append(self.word_dict[word] + offset)
        return indices

    def observation(self, obs, state):
        rows = []
        for text in _mission_texts(self.unwrapped, obs):
            idx = self.string_to_indices(text)
            if len(idx) >= self.max_words_in_mission:
                raise ValueError(f"mission has {len(idx)} words, limit {self.max_words_in_mission}")
            rows.append(idx + [0] * (self.max_words_in_mission - len(idx)))
        dev = obs["mission"].device
        return {**obs, "mission": torch.tensor(rows, dtype=torch.int64, device=dev)}


def mission_char_onehot(text: str, max_len: int = 96) -> np.ndarray:
    """(max_len, 28) float32 char one-hot (``wrappers.py:589-619``): a-z,
    space, comma."""
    if len(text) > max_len:
        raise ValueError(f"mission string too long ({len(text)} chars)")
    arr = np.zeros((max_len, 28), dtype=np.float32)
    for i, ch in enumerate(text.lower()):
        if "a" <= ch <= "z":
            no = ord(ch) - ord("a")
        elif ch == " ":
            no = 26
        elif ch == ",":
            no = 27
        else:
            raise ValueError(f"Character {ch} is not available in mission string.")
        arr[i, no] = 1
    return arr


class FlatObsWrapper(ObservationWrapper):
    """Image and char-one-hot mission, flattened into ``(B, v*v*3 +
    max_str_len*28)`` float32 (``wrappers.py:553-623``).

    For envs with a fixed mission (most of the suite) the mission one-hot
    is made once at construction and the transform stays on the device;
    for per-episode missions (``mission=None``, or detected) each env's
    mission is decoded on the host.

    Example (7*7*3 image + 96*28 chars = 2835 floats):

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import FlatObsWrapper
        >>> env = FlatObsWrapper(port.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), device="cpu")
        >>> tuple(obs.shape)
        (1, 2835)
    """

    def __init__(self, env, max_str_len: int = 96, mission: Optional[str] = "auto"):
        super().__init__(env)
        self.max_str_len = max_str_len
        if mission == "auto":
            # Static-mission detection: if the decoded text ignores the code
            # vector, the mission is constant for the id and can be baked in.
            try:
                a = self.unwrapped.mission_text([0] * 8)
                b = self.unwrapped.mission_text([1] * 8)
                mission = a if a == b else None
            except (IndexError, KeyError):  # codes no mission of the id holds
                mission = None
        self._static_chars = (
            None
            if mission is None
            else torch.from_numpy(mission_char_onehot(mission, max_str_len)).reshape(-1)
        )

    def observation(self, obs, state):
        img = obs["image"]
        b, dev = img.shape[0], img.device
        if self._static_chars is not None:
            chars = self._static_chars.to(dev).expand(b, -1)
        else:
            each = [mission_char_onehot(t, self.max_str_len).reshape(-1)
                    for t in _mission_texts(self.unwrapped, obs)]
            chars = torch.from_numpy(np.stack(each)).to(dev)
        return torch.cat([img.reshape(b, -1).to(torch.float32), chars], dim=1)


# ---------------------------------------------------------------------------
# Action / dynamics wrappers
# ---------------------------------------------------------------------------


class StochasticActionWrapper(Wrapper):
    """With probability ``1 - prob`` the intended action is replaced by
    ``random_action`` (or a uniform draw over actions 0..5, as the
    reference's ``integers(0, high=6)``, ``wrappers.py:775-796``).  The
    draws, one uniform and one replacement per env, come from the step's
    ``generator``, which must be given; the inner step gets the same
    generator after them.

    Example (``prob=1.0`` never substitutes, so it behaves like the bare
    env):

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import (
        ...     StochasticActionWrapper)
        >>> env = StochasticActionWrapper(port.make("MiniGrid-Empty-5x5-v0"), prob=1.0)
        >>> g = torch.Generator().manual_seed(0)
        >>> obs, state = env.reset(g, device="cpu")
        >>> obs, state, r, term, trunc, _ = env.step(state, 0, g)
        >>> term.tolist()
        [False]
    """

    def __init__(self, env, prob: float = 0.9, random_action: Optional[int] = None):
        super().__init__(env)
        self.prob = prob
        self.random_action = random_action

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        if generator is None:
            raise ValueError("StochasticActionWrapper draws; pass a generator")
        action = _actions(state, action)
        b, dev = action.shape[0], action.device
        keep = torch.rand(b, generator=generator, device=dev) < self.prob
        if self.random_action is None:
            rand = torch.randint(0, 6, (b,), generator=generator, device=dev, dtype=action.dtype)
        else:
            rand = torch.full((b,), self.random_action, dtype=action.dtype, device=dev)
        action = torch.where(keep, action, rand)
        return self.env.step(state, action, generator)


class NoDeath(Wrapper):
    """Deaths on the given cell types become ``death_cost`` reward without
    termination (``wrappers.py:799-872``): checks the pre-step front cell
    (clipped into the grid; the Dynamic-Obstacles pre-move snapshot) and
    the post-step current cell, and clears ``terminated`` on the core state
    too, through nested :class:`WrapperState`s.

    Example: with these seeds the first forward step of some
    LavaCrossingS9N1 agents walks into lava, a terminal death on the bare
    env and a ``death_cost`` penalty without termination under the
    wrapper:

        >>> import torch
        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import NoDeath
        >>> bare = port.make("MiniGrid-LavaCrossingS9N1-v0")
        >>> env = NoDeath(bare, no_death_types=("lava",), death_cost=-1.0)
        >>> obs, state = env.reset(torch.Generator().manual_seed(0), 64, device="cpu")
        >>> died = bare.step(state, 2)[3]
        >>> _, _, r, term, _, _ = env.step(state, 2)
        >>> bool(died.any()), bool(term.any()), bool((r[died] == -1.0).all())
        (True, False, True)
    """

    def __init__(self, env, no_death_types: Sequence[str], death_cost: float = -1.0):
        if "goal" in no_death_types:
            raise ValueError("goal cannot be a death cell")
        super().__init__(env)
        self.death_cost = death_cost
        self.no_death_ids = tuple(OBJECT_TO_IDX[t] for t in no_death_types)

    def _is_death(self, obj: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(obj, dtype=torch.bool)
        for i in self.no_death_ids:
            out |= obj == i
        return out

    def step(self, state, action, generator: Optional[torch.Generator] = None):
        action = _actions(state, action)
        prev = core_state(state)
        b, h, w = prev.grid_obj.shape
        rows = torch.arange(b, device=action.device)
        dx, dy = _dir_vec(prev.agent_dir)
        fx = (prev.agent_pos[:, 0] + dx).clamp(0, w - 1).long()
        fy = (prev.agent_pos[:, 1] + dy).clamp(0, h - 1).long()
        going_to_death = (action == ACT_FORWARD) & self._is_death(prev.grid_obj[rows, fy, fx])

        obs, inner, r, term, trunc, info = self.env.step(state, action, generator)
        core = core_state(inner)
        cur_obj = core.grid_obj[rows, core.agent_pos[:, 1].long(), core.agent_pos[:, 0].long()]
        cancel = term & (going_to_death | self._is_death(cur_obj))
        r = torch.where(cancel, r + self.death_cost, r)
        term = term & ~cancel
        # The terminated flag lives on the core state too: clear it when a
        # death was cancelled so auto-reset machinery agrees with the return.
        new_inner = _replace_core(inner, core.replace(terminated=core.terminated & ~cancel))
        return obs, new_inner, r, term, trunc, info


def _replace_core(state, new_core):
    if isinstance(state, WrapperState):
        return state.replace(inner=_replace_core(state.inner, new_core))
    return new_core


class ReseedWrapper(Wrapper):
    """Cycles a fixed list of seeds on reset (``wrappers.py:17-67``).  The
    seed cursor lives on the wrapper object, on the host, as in the
    reference; each ``reset`` draws the whole batch from a fresh
    ``torch.Generator`` on ``device`` seeded with the next seed, and
    ignores the generator it is given.

    Example (two seeds cycle, so resets 1 and 3 are identical):

        >>> import minigrid_dynamicprogramming_tpu_torch as port
        >>> from minigrid_dynamicprogramming_tpu_torch.wrappers import ReseedWrapper
        >>> env = ReseedWrapper(port.make("MiniGrid-Empty-8x8-v0"), seeds=[7, 9])
        >>> o1, s1 = env.reset(device="cpu")
        >>> o2, s2 = env.reset(device="cpu")
        >>> o3, s3 = env.reset(device="cpu")
        >>> bool((o1["image"] == o3["image"]).all())
        True
    """

    def __init__(self, env, seeds: Sequence[int] = (0,), seed_idx: int = 0):
        super().__init__(env)
        self.seeds = list(seeds)
        self.seed_idx = seed_idx

    def reset(self, generator: Optional[torch.Generator] = None, batch_size: int = 1, device="cuda"):
        seed = self.seeds[self.seed_idx]
        self.seed_idx = (self.seed_idx + 1) % len(self.seeds)
        g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return self.env.reset(g, batch_size, device)
