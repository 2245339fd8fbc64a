"""Interactive keyboard control of one environment.

Counterpart of ``minigrid_dynamicprogramming_tpu/manual_control.py`` (the
reference's pygame REPL, ``minigrid/manual_control.py``): a pygame window
where a display is available, else a terminal loop over the ASCII grid
printer, which also works over ssh onto a machine without a display.  The
env is a batch of one.

Run: ``python -m minigrid_dynamicprogramming_tpu_torch.manual_control --env-id ...``
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import os

import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_DONE,
    ACT_DROP,
    ACT_FORWARD,
    ACT_LEFT,
    ACT_PICKUP,
    ACT_RIGHT,
    ACT_TOGGLE,
)
from minigrid_dynamicprogramming_tpu_torch.core.state import resolve_device
from minigrid_dynamicprogramming_tpu_torch.utils.debug import pprint_state

# The reference key handler's bindings, and one-letter aliases for the
# terminal.
KEY_TO_ACTION = {
    "left": ACT_LEFT,
    "right": ACT_RIGHT,
    "up": ACT_FORWARD,
    "space": ACT_TOGGLE,
    "pageup": ACT_PICKUP,
    "pagedown": ACT_DROP,
    "tab": ACT_PICKUP,
    "left shift": ACT_DROP,
    "enter": ACT_DONE,
    "return": ACT_DONE,
    "a": ACT_LEFT,
    "d": ACT_RIGHT,
    "w": ACT_FORWARD,
    "t": ACT_TOGGLE,
    "p": ACT_PICKUP,
    "o": ACT_DROP,
    "e": ACT_DONE,
}


class ManualControl:
    """Step one env from keyboard input; resets on an episode's end or 'r'."""

    def __init__(self, env, seed: int = 0, screen_size: int = 640, device="cuda"):
        self.env = env
        self.seed = seed
        self.screen_size = screen_size
        self.device = resolve_device(device)
        self.state = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def reset(self):
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        _, self.state = self.env.reset(g, 1, self.device)
        self.seed += 1

    def step(self, action: int):
        _, self.state, reward, term, trunc, _ = self.env.step(self.state, action, self.generator)
        return float(reward[0]), bool(term[0]), bool(trunc[0])

    def handle_key(self, name: str):
        """Returns (reward, terminated, truncated), or None for a key that
        is no action."""
        if name in ("escape", "q"):
            raise SystemExit
        if name in ("backspace", "r"):
            self.reset()
            return None
        action = KEY_TO_ACTION.get(name)
        if action is None:
            return None
        return self.step(int(action))

    # -- frontends ---------------------------------------------------------
    def run_terminal(self):
        self.reset()
        print(self.describe())
        while True:
            try:
                line = input("action [w/a/d fwd/turn, p pick, o drop, t toggle, e done, r reset, q quit] > ")
            except EOFError:
                return
            out = self.handle_key(line.strip().lower() or "w")
            if out is not None:
                reward, term, trunc = out
                print(f"reward={reward:.3f} terminated={term} truncated={trunc}")
                if term or trunc:
                    print("episode over — resetting")
                    self.reset()
            print(self.describe())

    def describe(self) -> str:
        mission = self.env.mission_text(self.state.mission[0].tolist())
        header = f"[{self.env.env_id}] mission: {mission}" if mission else f"[{self.env.env_id}]"
        return header + "\n" + pprint_state(self.state)

    def run_pygame(self):
        import pygame

        from minigrid_dynamicprogramming_tpu_torch.render import render_frame_np

        pygame.init()
        screen = pygame.display.set_mode((self.screen_size, self.screen_size))
        pygame.display.set_caption(self.env.env_id)
        clock = pygame.time.Clock()
        self.reset()
        running = True
        while running:
            frame = render_frame_np(self.env, self.state)[0]
            surf = pygame.surfarray.make_surface(frame.swapaxes(0, 1))
            surf = pygame.transform.scale(surf, (self.screen_size, self.screen_size))
            screen.blit(surf, (0, 0))
            pygame.display.flip()
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    running = False
                elif event.type == pygame.KEYDOWN:
                    try:
                        out = self.handle_key(pygame.key.name(int(event.key)))
                    except SystemExit:
                        running = False
                        break
                    if out is not None and (out[1] or out[2]):
                        self.reset()
            clock.tick(30)
        pygame.quit()

    def run(self):
        """The pygame window where pygame and a display are present, else
        the terminal."""
        try:
            import pygame  # noqa: F401
        except ImportError:
            return self.run_terminal()
        if os.environ.get("SDL_VIDEODRIVER") == "dummy":
            return self.run_terminal()
        try:
            self.run_pygame()
        except pygame.error:  # no display
            self.run_terminal()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env-id", default="MiniGrid-MultiRoom-N6-v0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--screen-size", type=int, default=640)
    p.add_argument("--terminal", action="store_true", help="force the ASCII mode")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    mc = ManualControl(port.make(args.env_id), args.seed, args.screen_size, args.device)
    if args.terminal:
        mc.run_terminal()
    else:
        mc.run()


if __name__ == "__main__":
    main()
