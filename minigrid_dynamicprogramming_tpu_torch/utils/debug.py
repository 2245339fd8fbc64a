"""Host-side debugging helpers: the ASCII grid printer and the state digest.

Counterparts of ``minigrid_dynamicprogramming_tpu/utils/debug.py``, which
re-express the reference's ``MiniGridEnv.pprint_grid`` (string rendering)
and ``MiniGridEnv.hash`` (a sha256 digest).  A port state is a batch, so
each function takes the index ``i`` of one env in it (on any device: only
that env's planes come to the host).  The strings equal the JAX package's
on the same state: the digest hashes the wire encoding (the three grid
planes in the reference's ``Grid.encode`` layout) and the agent pose, so
it compares across the two frameworks.
"""

from __future__ import annotations

import hashlib

import numpy as np

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    IDX_TO_COLOR,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJECT_TO_IDX,
    STATE_LOCKED,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState

_OBJ_CHAR = {
    OBJECT_TO_IDX["wall"]: "W",
    OBJECT_TO_IDX["floor"]: "F",
    OBJECT_TO_IDX["door"]: "D",
    OBJECT_TO_IDX["key"]: "K",
    OBJECT_TO_IDX["ball"]: "A",
    OBJECT_TO_IDX["box"]: "B",
    OBJECT_TO_IDX["goal"]: "G",
    OBJECT_TO_IDX["lava"]: "V",
}
_DIR_CHAR = {0: ">", 1: "V", 2: "<", 3: "^"}


def _pose(state: EnvState, i: int):
    pos = state.agent_pos[i].tolist()
    return (int(pos[0]), int(pos[1])), int(state.agent_dir[i])


def pprint_state(state: EnvState, i: int = 0) -> str:
    """Env ``i``'s grid, two characters a cell (object, color initial),
    the agent a doubled direction arrow: the reference's ``pprint_grid``
    format."""
    obj = state.grid_obj[i].cpu().numpy()
    color = state.grid_color[i].cpu().numpy()
    st = state.grid_state[i].cpu().numpy()
    (ax, ay), adir = _pose(state, i)
    rows = []
    h, w = obj.shape
    for j in range(h):
        line = []
        for x in range(w):
            if (x, j) == (ax, ay):
                line.append(2 * _DIR_CHAR[adir])
                continue
            t = int(obj[j, x])
            if t == OBJ_EMPTY:
                line.append("  ")
                continue
            c = IDX_TO_COLOR[int(color[j, x])][0].upper()
            if t == OBJ_DOOR:
                s = int(st[j, x])
                line.append("__" if s == STATE_OPEN else ("L" + c if s == STATE_LOCKED else "D" + c))
                continue
            line.append(_OBJ_CHAR.get(t, "?") + c)
        rows.append("".join(line))
    return "\n".join(rows)


def encode_grid(state: EnvState, i: int = 0) -> np.ndarray:
    """(W, H, 3) uint8 wire encoding of env ``i``'s grid: the reference's
    ``Grid.encode`` with an all-visible mask."""
    planes = np.stack(
        [p[i].cpu().numpy() for p in (state.grid_obj, state.grid_color, state.grid_state)],
        axis=-1,
    )  # [y, x, 3]
    return np.transpose(planes, (1, 0, 2))  # the reference's layout is [x, y, 3]


def state_hash(state: EnvState, i: int = 0, size: int = 16) -> str:
    """Digest of env ``i``'s world state, the grid encoding and the agent
    pose hashed as ``MiniGridEnv.hash`` hashes them."""
    h = hashlib.sha256()
    pos, adir = _pose(state, i)
    for item in (encode_grid(state, i).tolist(), pos, adir):
        h.update(str(item).encode("utf8"))
    return h.hexdigest()[:size]
