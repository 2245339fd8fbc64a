"""Tile rasterizer and tile look-up table.

Own copy of ``minigrid_dynamicprogramming_tpu/render/tiles.py`` (NumPy; the
port keeps its own so that it imports nothing of the JAX package), plus
:func:`tile_lut_tensor`, the table as a uint8 tensor on a device.

The reference rasterizes each tile on demand with per-pixel Python loops
over coordinate-predicate closures (minigrid ``utils/rendering.py:25-37``)
and caches the result per ``(obj.encode(), agent_dir, highlight,
tile_size)`` key (``core/grid.py:145-198``).  Here the full key space is
tiny (11 object types x 6 colors x 3 states x 5 agent overlays x 2
highlight flags), so all tiles are rasterized into one dense table and
rendering a frame becomes one gather (see
:mod:`minigrid_dynamicprogramming_tpu_torch.render`).

The rasterizer is vectorized numpy over the supersampled pixel-center
grid: every shape predicate of the reference
(``point_in_rect/circle/line/triangle``, ``rotate_fn``,
``rendering.py:40-123``) becomes a boolean mask over an (S, S) coordinate
array, with the same 3x supersampling and box-filter downsample
(``rendering.py:8-22``, ``grid.py:160-163``), so output pixels match the
reference bit for bit.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_FLOOR,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    OBJ_WALL,
    STATE_LOCKED,
    STATE_OPEN,
)

TILE_PIXELS = 32  # reference default (constants.py:5)

# RGB values per color index (constants.py:8-20).
COLOR_RGB = np.array(
    [
        [255, 0, 0],  # red
        [0, 255, 0],  # green
        [0, 0, 255],  # blue
        [112, 39, 195],  # purple
        [255, 255, 0],  # yellow
        [100, 100, 100],  # grey
    ],
    dtype=np.float64,
)

N_OBJ, N_COLOR, N_STATE, N_AGENT, N_HL = 11, 6, 3, 5, 2


# -- coordinate-predicate rasterization (vectorized) -------------------------


def _coords(n: int):
    """Pixel-center coordinates in [0, 1): xf = (x + 0.5) / n
    (rendering.py:30-33)."""
    c = (np.arange(n, dtype=np.float64) + 0.5) / n
    return np.meshgrid(c, c)  # X[y, x], Y[y, x]


def fill(img: np.ndarray, mask: np.ndarray, color) -> None:
    """Assign ``color`` where mask holds; float colors truncate on uint8
    assignment exactly like ``img[y, x] = color`` in the reference."""
    img[mask] = np.asarray(color)


def in_rect(X, Y, xmin, xmax, ymin, ymax):
    return (X >= xmin) & (X <= xmax) & (Y >= ymin) & (Y <= ymax)


def in_circle(X, Y, cx, cy, r):
    return (X - cx) ** 2 + (Y - cy) ** 2 <= r * r


def in_line(X, Y, x0, y0, x1, y1, r):
    # Distance from each pixel center to the segment (rendering.py:53-81);
    # the reference's bbox early-out never changes membership, so it is
    # dropped.  Intermediate math mirrors the reference's float32 direction
    # normalization before float64 promotion.
    p0 = np.array([x0, y0], dtype=np.float32)
    p1 = np.array([x1, y1], dtype=np.float32)
    d = p1 - p0
    dist = np.linalg.norm(d)
    d = d / dist
    pqx = X - p0[0]
    pqy = Y - p0[1]
    a = np.clip(pqx * d[0] + pqy * d[1], 0, dist)
    px = p0[0] + a * d[0]
    py = p0[1] + a * d[1]
    return (X - px) ** 2 + (Y - py) ** 2 <= r * r


def in_triangle(X, Y, a, b, c):
    a = np.array(a, dtype=np.float32)
    b = np.array(b, dtype=np.float32)
    c = np.array(c, dtype=np.float32)
    v0 = c - a
    v1 = b - a
    dot00 = float(v0 @ v0)
    dot01 = float(v0 @ v1)
    dot11 = float(v1 @ v1)
    v2x = X - a[0]
    v2y = Y - a[1]
    dot02 = v0[0] * v2x + v0[1] * v2y
    dot12 = v1[0] * v2x + v1[1] * v2y
    inv = 1.0 / (dot00 * dot11 - dot01 * dot01)
    u = (dot11 * dot02 - dot01 * dot12) * inv
    v = (dot00 * dot12 - dot01 * dot02) * inv
    return (u >= 0) & (v >= 0) & (u + v < 1)


def rotated(X, Y, cx, cy, theta):
    """Coordinates rotated by ``-theta`` about (cx, cy) (rendering.py:40-50)."""
    x = X - cx
    y = Y - cy
    X2 = cx + x * math.cos(-theta) - y * math.sin(-theta)
    Y2 = cy + y * math.cos(-theta) + x * math.sin(-theta)
    return X2, Y2


# -- per-object tile painters (world_object.py render methods) ----------------


def _paint_object(img, X, Y, obj: int, color: int, st: int) -> None:
    c = COLOR_RGB[color]
    if obj == OBJ_WALL or obj == OBJ_GOAL:
        # Wall world_object.py:168-169; Goal :117-118 — full-rect fill.
        fill(img, in_rect(X, Y, 0, 1, 0, 1), c)
    elif obj == OBJ_FLOOR:
        # Floor :132-135 — half-bright, leaves the grid-line band.
        fill(img, in_rect(X, Y, 0.031, 1, 0.031, 1), c / 2)
    elif obj == OBJ_LAVA:
        # Lava :145-158 — orange with three black wave strokes.
        fill(img, in_rect(X, Y, 0, 1, 0, 1), (255, 128, 0))
        for i in range(3):
            ylo = 0.3 + 0.2 * i
            yhi = 0.4 + 0.2 * i
            fill(img, in_line(X, Y, 0.1, ylo, 0.3, yhi, 0.03), (0, 0, 0))
            fill(img, in_line(X, Y, 0.3, yhi, 0.5, ylo, 0.03), (0, 0, 0))
            fill(img, in_line(X, Y, 0.5, ylo, 0.7, yhi, 0.03), (0, 0, 0))
            fill(img, in_line(X, Y, 0.7, yhi, 0.9, ylo, 0.03), (0, 0, 0))
    elif obj == OBJ_DOOR:
        # Door :215-237 — open edge / locked pane+keyhole / closed frame+knob.
        if st == STATE_OPEN:
            fill(img, in_rect(X, Y, 0.88, 1.00, 0.00, 1.00), c)
            fill(img, in_rect(X, Y, 0.92, 0.96, 0.04, 0.96), (0, 0, 0))
        elif st == STATE_LOCKED:
            fill(img, in_rect(X, Y, 0.00, 1.00, 0.00, 1.00), c)
            fill(img, in_rect(X, Y, 0.06, 0.94, 0.06, 0.94), 0.45 * c)
            fill(img, in_rect(X, Y, 0.52, 0.75, 0.50, 0.56), c)
        else:
            fill(img, in_rect(X, Y, 0.00, 1.00, 0.00, 1.00), c)
            fill(img, in_rect(X, Y, 0.04, 0.96, 0.04, 0.96), (0, 0, 0))
            fill(img, in_rect(X, Y, 0.08, 0.92, 0.08, 0.92), c)
            fill(img, in_rect(X, Y, 0.12, 0.88, 0.12, 0.88), (0, 0, 0))
            fill(img, in_circle(X, Y, 0.75, 0.50, 0.08), c)
    elif obj == OBJ_KEY:
        # Key :247-259 — vertical shaft, two teeth, ring with hole.
        fill(img, in_rect(X, Y, 0.50, 0.63, 0.31, 0.88), c)
        fill(img, in_rect(X, Y, 0.38, 0.50, 0.59, 0.66), c)
        fill(img, in_rect(X, Y, 0.38, 0.50, 0.81, 0.88), c)
        fill(img, in_circle(X, Y, 0.56, 0.28, 0.190), c)
        fill(img, in_circle(X, Y, 0.56, 0.28, 0.064), (0, 0, 0))
    elif obj == OBJ_BALL:
        # Ball :269-270.
        fill(img, in_circle(X, Y, 0.5, 0.5, 0.31), c)
    elif obj == OBJ_BOX:
        # Box :281-289 — frame plus horizontal lid line.
        fill(img, in_rect(X, Y, 0.12, 0.88, 0.12, 0.88), c)
        fill(img, in_rect(X, Y, 0.18, 0.82, 0.18, 0.82), (0, 0, 0))
        fill(img, in_rect(X, Y, 0.16, 0.84, 0.47, 0.53), c)
    # unseen / empty / agent cell codes: background only.


def render_tile(
    obj: int,
    color: int,
    st: int,
    agent_dir: int = -1,
    highlight: bool = False,
    tile_size: int = TILE_PIXELS,
    subdivs: int = 3,
) -> np.ndarray:
    """Rasterize one (tile_size, tile_size, 3) uint8 tile, matching
    ``Grid.render_tile`` (grid.py:145-198) pixel-for-pixel."""
    s = tile_size * subdivs
    img = np.zeros((s, s, 3), dtype=np.uint8)
    X, Y = _coords(s)

    # Grid lines: top and left 3.1% bands in grey (grid.py:169-171).
    fill(img, in_rect(X, Y, 0, 0.031, 0, 1), (100, 100, 100))
    fill(img, in_rect(X, Y, 0, 1, 0, 0.031), (100, 100, 100))

    _paint_object(img, X, Y, obj, color, st)

    if agent_dir >= 0:
        # Red agent chevron rotated by dir (grid.py:177-186).
        X2, Y2 = rotated(X, Y, 0.5, 0.5, 0.5 * math.pi * agent_dir)
        fill(
            img,
            in_triangle(X2, Y2, (0.12, 0.19), (0.87, 0.50), (0.12, 0.81)),
            (255, 0, 0),
        )

    if highlight:
        # White alpha blend (rendering.py:126-133).
        img = (img + 0.30 * (np.array([255, 255, 255]) - img)).clip(0, 255)
        img = img.astype(np.uint8)

    # 3x box-filter downsample; float mean truncates on uint8 cast exactly as
    # the reference's float->uint8 slice assignment does (grid.py:234-240).
    img = img.reshape(tile_size, subdivs, tile_size, subdivs, 3)
    return img.mean(axis=3).mean(axis=1).astype(np.uint8)


def tile_key(obj, color, st, agent_code, hl):
    """Flat LUT index; ``agent_code`` is 0 for no agent else 1 + dir."""
    return (((obj * N_COLOR + color) * N_STATE + st) * N_AGENT + agent_code) * N_HL + hl


@lru_cache(maxsize=8)
def tile_lut(tile_size: int = TILE_PIXELS) -> np.ndarray:
    """Dense (11*6*3*5*2, tile_size, tile_size, 3) uint8 tile table."""
    lut = np.zeros(
        (N_OBJ * N_COLOR * N_STATE * N_AGENT * N_HL, tile_size, tile_size, 3),
        dtype=np.uint8,
    )
    for obj in range(N_OBJ):
        for color in range(N_COLOR):
            for st in range(N_STATE):
                for ag in range(N_AGENT):
                    for hl in range(N_HL):
                        lut[tile_key(obj, color, st, ag, hl)] = render_tile(
                            obj, color, st, agent_dir=ag - 1,
                            highlight=bool(hl), tile_size=tile_size,
                        )
    return lut


@lru_cache(maxsize=16)
def tile_lut_tensor(tile_size: int, device: torch.device) -> torch.Tensor:
    """:func:`tile_lut` as a uint8 tensor on ``device``, made once per
    (tile size, device)."""
    return torch.from_numpy(tile_lut(tile_size)).to(device)
