"""Documentation pages and GIFs of the environments.

Counterpart of ``minigrid_dynamicprogramming_tpu/docs_gen.py`` (the
reference's ``gen_env_docs.py``, one markdown page per env family, and
``gen_gifs.py``, one random-policy episode GIF per family).  A page is
built from the record (``EnvParams``, the action count, the reward range)
and one reset; frames come from ``render.render_frame``, stepped on the
device a batch of one.  Pages equal the JAX package's but for the
creation line, which names this package, and the example mission, which
this package's generator draws.

Run::

    python -m minigrid_dynamicprogramming_tpu_torch.docs_gen --out docs \\
        [--gifs] [--length 60] [--tile-size 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.core.state import resolve_device
from minigrid_dynamicprogramming_tpu_torch.registry import family
from minigrid_dynamicprogramming_tpu_torch.render import render_frame

PACKAGE = "minigrid_dynamicprogramming_tpu_torch"


def _one_id_per_family(ids) -> dict:
    """The first id of each family: the reference documents one env per
    class."""
    picked = {}
    for env_id in ids:
        picked.setdefault(family(env_id), env_id)
    return picked


def _targets(ids) -> dict:
    return {family(i): i for i in ids} if ids else _one_id_per_family(port.registered_ids())


def _env_page(env_id: str, device) -> str:
    env = port.make(env_id)
    p = env.params
    _, state = env.reset(torch.Generator(device=device).manual_seed(0), 1, device)
    mission = env.mission_text(state.mission[0].tolist())
    fam = family(env_id)
    siblings = [i for i in port.registered_ids() if family(i) == fam]
    view = p.agent_view_size
    lines = [
        "---",
        "autogenerated:",
        f"title: {fam}",
        "---",
        "",
        f"# {fam}",
        "",
        f"![{fam}](../_static/gifs/{fam}.gif)",
        "",
        "|   |   |",
        "|---|---|",
        f"| Action Space | `Discrete({env.action_dim})` |",
        f"| Observation | `image (uint8 {view}x{view}x3)`, `direction`, `mission` |",
        f"| Grid Size | `{p.width} x {p.height}` |",
        f"| Max Steps | `{p.max_steps}` |",
        f"| Reward Range | `{env.reward_range}` |",
        f"| Creation | `{PACKAGE}.make(\"{env_id}\")` |",
        "",
        f"Example mission: *{mission}*",
        "",
        "## Registered configurations",
        "",
    ]
    lines += [f"- `{i}`" for i in siblings]
    lines.append("")
    return "\n".join(lines)


def gen_env_docs(out_dir: str, ids=None, device="cuda") -> list:
    """One markdown page per env family under ``out_dir/environments/``."""
    dev = resolve_device(device)
    written = []
    for fam, env_id in _targets(ids).items():
        group = "babyai" if env_id.startswith("BabyAI-") else "minigrid"
        d = os.path.join(out_dir, "environments", group)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{fam}.md")
        with open(path, "w", encoding="utf-8") as f:
            f.write(_env_page(env_id, dev))
        written.append(path)
    return written


def episode_frames(env, seed: int = 0, length: int = 60, tile_size: int = 16, device="cuda") -> list:
    """``length`` frames of one env under a uniform random policy, reset
    at each episode's end (``gen_gifs.py``), as (H, W, 3) uint8 arrays."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    _, state = env.reset(g, 1, dev)
    frames = []
    for _ in range(length):
        frames.append(render_frame(env.params, state, tile_size)[0].cpu().numpy())
        a = torch.randint(0, env.action_dim, (1,), generator=g, device=dev)
        _, state, _, term, trunc, _ = env.step(state, a, g)
        if bool(term[0] | trunc[0]):
            _, state = env.reset(g, 1, dev)
    return frames


def gen_gifs(out_dir: str, length: int = 60, tile_size: int = 16, ids=None, device="cuda") -> list:
    """One GIF per env family under ``out_dir/_static/gifs/``."""
    from PIL import Image

    d = os.path.join(out_dir, "_static", "gifs")
    os.makedirs(d, exist_ok=True)
    written = []
    for fam, env_id in _targets(ids).items():
        frames = [
            Image.fromarray(np.ascontiguousarray(f))
            for f in episode_frames(port.make(env_id), length=length, tile_size=tile_size, device=device)
        ]
        path = os.path.join(d, f"{fam}.gif")
        frames[0].save(path, save_all=True, append_images=frames[1:], duration=100, loop=0)
        written.append(path)
    return written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="docs")
    ap.add_argument("--gifs", action="store_true", help="also render GIFs")
    ap.add_argument("--length", type=int, default=60)
    ap.add_argument("--tile-size", type=int, default=16)
    ap.add_argument("--env-id", default=None, help="restrict to one id")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ids = [args.env_id] if args.env_id else None
    pages = gen_env_docs(args.out, device=args.device) if not ids else []
    print(f"wrote {len(pages)} pages")
    if args.gifs:
        gifs = gen_gifs(args.out, args.length, args.tile_size, ids, args.device)
        print(f"wrote {len(gifs)} gifs")


if __name__ == "__main__":
    main()
