#!/usr/bin/env python
"""Interactive warehouse play in the terminal.

Equivalent of the reference's pyglet-based ``human_play.py`` (argparse
surface: --env/--max_steps/--display_info; TAB cycles the controlled agent,
arrows/WASD move, SPACE toggles load, R resets) rendered as a curses TUI so
it works over SSH and in containers with no display.

Key bindings (``--keys``):
  reference (default) — the reference's exact map (rware human_play.py
    _key_press): UP = forward, LEFT/RIGHT = rotate, P/L = toggle load,
    SPACE = noop, TAB = next agent, R = reset, H = help, D = toggle info,
    ESC/Q = quit.
  friendly — arrows/WASD rotate-toward-or-forward, SPACE = toggle load,
    TAB = next agent, R = reset, Q = quit.
The controlled agent acts; all others NOOP.
"""
from __future__ import annotations

import argparse
import curses

import numpy as np


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="rware-tiny-2ag-v2")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument(
        "--display_info", action="store_true", help="show rewards/info each step"
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--backend", choices=["auto", "curses", "window"], default="auto",
        help="window = graphical viewer with key hooks (needs a display, "
        "the reference's pyglet-window equivalent); curses = terminal TUI; "
        "auto tries window, falls back to curses",
    )
    p.add_argument(
        "--keys", choices=["reference", "friendly"], default="reference",
        help="key map: 'reference' matches the reference human_play.py "
        "(UP forward, LEFT/RIGHT rotate, P/L load, SPACE noop, H help, "
        "D info); 'friendly' = arrows/WASD rotate-toward-or-forward, "
        "SPACE load",
    )
    return p.parse_args()


HELP_REFERENCE = (
    "UP forward | LEFT/RIGHT rotate | P/L toggle load | SPACE noop | "
    "TAB next agent | R reset | H help | D info | ESC/Q quit"
)
HELP_FRIENDLY = (
    "arrows/WASD rotate-toward-or-forward | SPACE toggle load | "
    "TAB next agent | R reset | Q quit"
)

# friendly mode: rotation order UP -> RIGHT -> DOWN -> LEFT (clockwise)
_CLOCK = {0: 3, 3: 1, 1: 2, 2: 0}


def dispatch_key(mode: str, key: str, cur_dir: int):
    """Map a normalised key name to a play command, shared by both
    backends.  Returns ("action", int_action) | ("cycle",) | ("reset",) |
    ("quit",) | ("help",) | ("toggle_info",) | None.

    ``mode="reference"`` reproduces the reference's _key_press map
    (/root/reference/human_play.py:114-147) exactly; ``"friendly"`` keeps
    the rotate-toward-or-forward scheme.  ``key`` is lowercase: "up",
    "down", "left", "right", "tab", "escape", " ", or a letter."""
    from rware_tpu.types import Action, Direction

    if key == "tab":
        return ("cycle",)
    if key == "r":
        return ("reset",)
    if mode == "reference":
        if key in ("escape", "q"):
            return ("quit",)
        if key == "up":
            return ("action", int(Action.FORWARD))
        if key == "left":
            return ("action", int(Action.LEFT))
        if key == "right":
            return ("action", int(Action.RIGHT))
        if key in ("p", "l"):
            return ("action", int(Action.TOGGLE_LOAD))
        if key == " ":
            return ("action", int(Action.NOOP))
        if key == "h":
            return ("help",)
        if key == "d":
            return ("toggle_info",)
        return None
    # friendly
    if key == "q":
        return ("quit",)
    if key == " ":
        return ("action", int(Action.TOGGLE_LOAD))
    want = {
        "up": Direction.UP, "w": Direction.UP,
        "down": Direction.DOWN, "s": Direction.DOWN,
        "left": Direction.LEFT, "a": Direction.LEFT,
        "right": Direction.RIGHT, "d": Direction.RIGHT,
    }.get(key)
    if want is None:
        return None
    want = int(want)
    if cur_dir == want:
        return ("action", int(Action.FORWARD))
    if _CLOCK[cur_dir] == want:
        return ("action", int(Action.RIGHT))
    return ("action", int(Action.LEFT))


DIR_GLYPH = {0: "^", 1: "v", 2: "<", 3: ">"}


def draw(stdscr, env, state, selected, msg, display_info, last,
         help_line=HELP_FRIENDLY):
    import rware_tpu

    stdscr.erase()
    h, w = env.grid_size
    highways = env._env.layout.highways
    goals = {tuple(g) for g in env._env.layout.goals.tolist()}
    sx = np.asarray(state.shelf_x)
    sy = np.asarray(state.shelf_y)
    req = set(np.asarray(state.request_queue).tolist())
    ax = np.asarray(state.agent_x)
    ay = np.asarray(state.agent_y)
    adir = np.asarray(state.agent_dir)
    carrying = np.asarray(state.agent_carrying)

    shelf_at = {(int(x), int(y)): j for j, (x, y) in enumerate(zip(sx, sy))}
    agent_at = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(ax, ay))}

    for y in range(h):
        row = []
        for x in range(w):
            cell = (x, y)
            if cell in agent_at:
                i = agent_at[cell]
                ch = DIR_GLYPH[int(adir[i])]
                if i == selected:
                    ch = ch.upper() if ch.isalpha() else ch
                row.append(
                    f"[{ch}]" if carrying[i] >= 0 else f"({ch})"
                    if i == selected
                    else f" {ch}{'#' if carrying[i] >= 0 else ' '}"
                )
            elif cell in shelf_at:
                j = shelf_at[cell]
                row.append(" ▣ " if j in req else " □ ")
            elif cell in goals:
                row.append(" G ")
            elif highways[y, x]:
                row.append(" . ")
            else:
                row.append("   ")
        stdscr.addstr(y, 0, "".join(row))

    stdscr.addstr(
        h + 1, 0,
        f"agent {selected} selected | {help_line}"[: curses.COLS - 1],
    )
    if msg:
        stdscr.addstr(h + 2, 0, msg[: curses.COLS - 1])
    if display_info and last is not None:
        rew, done, info = last
        stdscr.addstr(h + 3, 0, f"rewards={rew} done={done} info={info}"[: curses.COLS - 1])
    stdscr.refresh()


def main(stdscr, args):
    import os

    import jax

    # Interactive play needs snappy steps, not accelerator throughput; allow
    # forcing the platform (e.g. cpu, which skips device round trips).
    if os.environ.get("RWARE_TPU_PLATFORM"):
        jax.config.update("jax_platforms", os.environ["RWARE_TPU_PLATFORM"])
    import jax.numpy as jnp
    import rware_tpu
    from rware_tpu.gym_adapter import make_gym

    curses.curs_set(0)
    stdscr.nodelay(False)

    env = make_gym(args.env, max_steps=args.max_steps or 500, render_mode="rgb_array")
    env.reset(seed=args.seed)
    selected = 0
    steps = 0
    last = None
    display_info = args.display_info
    help_line = HELP_REFERENCE if args.keys == "reference" else HELP_FRIENDLY
    msg = f"{args.env}: {env.n_agents} agents, grid {env.grid_size}"

    NAMES = {
        curses.KEY_UP: "up", curses.KEY_DOWN: "down",
        curses.KEY_LEFT: "left", curses.KEY_RIGHT: "right",
        ord("\t"): "tab", 27: "escape", ord(" "): " ",
    }

    while True:
        draw(stdscr, env, env.state, selected, msg, display_info, last,
             help_line)
        key = stdscr.getch()
        name = NAMES.get(key)
        if name is None and 0 <= key < 256 and chr(key).isprintable():
            name = chr(key).lower()
        if name is None:
            continue
        cur = int(np.asarray(env.state.agent_dir)[selected])
        cmd = dispatch_key(args.keys, name, cur)
        if cmd is None:
            continue
        if cmd[0] == "quit":
            break
        if cmd[0] == "cycle":
            selected = (selected + 1) % env.n_agents
            continue
        if cmd[0] == "reset":
            env.reset(seed=args.seed + steps)
            last = None
            continue
        if cmd[0] == "help":
            msg = help_line
            continue
        if cmd[0] == "toggle_info":
            display_info = not display_info
            continue
        action = cmd[1]
        acts = [0] * env.n_agents
        acts[selected] = action
        obs, rew, done, trunc, info = env.step(acts)
        last = (rew, done, info)
        steps += 1
        if done:
            msg = f"episode done after {steps} steps — R to reset"


def main_window(args) -> bool:
    """Windowed play via rendering.InteractiveViewer (the reference's
    pyglet-window surface, rware/rendering.py:85-137 + human_play.py:70).

    Returns False when no GUI backend exists so the caller can fall back.
    """
    import os

    import jax

    if os.environ.get("RWARE_TPU_PLATFORM"):
        jax.config.update("jax_platforms", os.environ["RWARE_TPU_PLATFORM"])
    import time

    import numpy as np

    from rware_tpu.gym_adapter import make_gym
    from rware_tpu.rendering import InteractiveViewer

    env = make_gym(
        args.env, max_steps=args.max_steps or 500, render_mode="rgb_array"
    )
    try:
        viewer = InteractiveViewer(env.config)
    except RuntimeError as e:
        print(f"windowed viewer unavailable ({e})")
        return False
    env.reset(seed=args.seed)
    state = {"selected": 0, "steps": 0, "info": args.display_info}
    help_line = HELP_REFERENCE if args.keys == "reference" else HELP_FRIENDLY

    def on_key(key):
        cur = int(np.asarray(env.state.agent_dir)[state["selected"]])
        cmd = dispatch_key(args.keys, key, cur)
        if cmd is None:
            # friendly mode keeps q/escape as quit even when unmapped
            if key == "escape":
                viewer.close()
            return
        if cmd[0] == "quit":
            viewer.close()
            return
        if cmd[0] == "cycle":
            state["selected"] = (state["selected"] + 1) % env.n_agents
            return
        if cmd[0] == "reset":
            env.reset(seed=args.seed + state["steps"])
            viewer.show(env.state)
            return
        if cmd[0] == "help":
            print(help_line)
            return
        if cmd[0] == "toggle_info":
            state["info"] = not state["info"]
            return
        acts = [0] * env.n_agents
        acts[state["selected"]] = cmd[1]
        obs, rew, done, trunc, info = env.step(acts)
        state["steps"] += 1
        if state["info"]:
            print(f"rewards={rew} done={done} info={info}")
        viewer.show(env.state)

    viewer.on_key_press = on_key
    viewer.show(env.state)
    print(f"{args.env}: {help_line} (focus the window)")
    while viewer.open:
        viewer._fig.canvas.flush_events()
        time.sleep(0.03)
    return True


if __name__ == "__main__":
    args = parse_args()
    if args.backend in ("auto", "window"):
        if main_window(args):
            raise SystemExit(0)
        if args.backend == "window":
            raise SystemExit(1)
    curses.wrapper(main, args)
