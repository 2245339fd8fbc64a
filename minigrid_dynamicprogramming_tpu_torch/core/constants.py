"""Integer encodings of the Minigrid wire format.

Own copy of the codes in ``minigrid_dynamicprogramming_tpu/core/constants.py``
(which imports ``jax.numpy``); the port keeps the plain Python ints and
numpy tables of the codes only (the renderer keeps its colour table in
``render/tiles.py``).  The codes are the observation wire format, so they
must stay identical to the reference's (checked by
``tests/test_torch_package.py``).
"""

from __future__ import annotations

import numpy as np

# --- object type ids ---
OBJ_UNSEEN = 0
OBJ_EMPTY = 1
OBJ_WALL = 2
OBJ_FLOOR = 3
OBJ_DOOR = 4
OBJ_KEY = 5
OBJ_BALL = 6
OBJ_BOX = 7
OBJ_GOAL = 8
OBJ_LAVA = 9
OBJ_AGENT = 10

NUM_OBJECTS = 11

OBJECT_TO_IDX = {
    "unseen": OBJ_UNSEEN,
    "empty": OBJ_EMPTY,
    "wall": OBJ_WALL,
    "floor": OBJ_FLOOR,
    "door": OBJ_DOOR,
    "key": OBJ_KEY,
    "ball": OBJ_BALL,
    "box": OBJ_BOX,
    "goal": OBJ_GOAL,
    "lava": OBJ_LAVA,
    "agent": OBJ_AGENT,
}
IDX_TO_OBJECT = {v: k for k, v in OBJECT_TO_IDX.items()}

# --- color ids ---
COLOR_RED = 0
COLOR_GREEN = 1
COLOR_BLUE = 2
COLOR_PURPLE = 3
COLOR_YELLOW = 4
COLOR_GREY = 5

NUM_COLORS = 6

COLOR_TO_IDX = {
    "red": 0,
    "green": 1,
    "blue": 2,
    "purple": 3,
    "yellow": 4,
    "grey": 5,
}
IDX_TO_COLOR = {v: k for k, v in COLOR_TO_IDX.items()}
COLOR_NAMES = sorted(COLOR_TO_IDX.keys())

# --- door states ---
STATE_OPEN = 0
STATE_CLOSED = 1
STATE_LOCKED = 2

STATE_TO_IDX = {"open": 0, "closed": 1, "locked": 2}

# --- actions ---
ACT_LEFT = 0
ACT_RIGHT = 1
ACT_FORWARD = 2
ACT_PICKUP = 3
ACT_DROP = 4
ACT_TOGGLE = 5
ACT_DONE = 6

NUM_ACTIONS = 7

# --- direction vectors, row = dir id, cols = (dx, dy):
# 0 = +x right, 1 = +y down, 2 = -x left, 3 = -y up
DIR_TO_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int32)
