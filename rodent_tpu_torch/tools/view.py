"""view: interactive progressive viewer (torch port of
rodent_tpu/tools/view.py; the driver.cpp GUI loop in terminal form).

The reference driver opens an SDL2 window with mouse-look and arrow-key
camera movement and restarts the progressive accumulation whenever the
camera moves (src/driver/driver.cpp:60-135, 279-325). This viewer draws to
the terminal instead: each frame in ANSI truecolor half-block characters
(two image rows per character cell), keys read raw from the tty between
progressive iterations. Camera semantics are the reference's:

  rotate(yaw, pitch): dir rotated about right by -pitch, then about up by
      -yaw, the basis re-orthonormalized     (driver.cpp:41-47)
  move(x, y, z): eye += right*x + up*y + dir*z   (driver.cpp:49-51)
  any movement resets the accumulation to iteration 0
      (driver.cpp:98-112)
  +/- scale the movement speed by 1.1 / 0.9      (driver.cpp:113-114)

Controls: arrows move (up/down along dir, left/right strafe), w/s pitch,
a/d yaw (the mouse-look analog), +/- speed, p saves a PNG, q or ESC quits.

Each iteration is one render_iteration_persistent under the scene's
select_render_policy, on the CUDA card (--cpu: the plain torch version on
the CPU; without --cpu the tool needs a card). The camera is rebuilt from
the rig for every frame; torch has nothing to recompile.

Scriptable for tests and headless runs: --keys supplies a key sequence
consumed one per iteration (arrows spelled U/D/L/R), --iters bounds the
loop; with --keys the tty is never touched.

Usage:
  python -m rodent_tpu_torch.tools.view scene.obj --eye 0 1 2.7 \
      --dir 0 0 -1 [--cpu]
"""
from __future__ import annotations

import argparse
import shutil
import sys
import time

import numpy as np


def rotate_about(v, axis, angle):
    """Rodrigues rotation of v about a unit axis (float3.h rotate)."""
    v = np.asarray(v, np.float64)
    axis = np.asarray(axis, np.float64)
    c, s = np.cos(angle), np.sin(angle)
    return v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c)


class CameraRig:
    """Mutable eye/dir/right/up basis with the reference driver's
    rotate/move semantics (driver.cpp:24-51)."""

    def __init__(self, eye, dirv, up):
        self.eye = np.asarray(eye, np.float64)
        d = np.asarray(dirv, np.float64)
        self.dir = d / np.linalg.norm(d)
        r = np.cross(self.dir, np.asarray(up, np.float64))
        self.right = r / np.linalg.norm(r)
        u = np.cross(self.right, self.dir)
        self.up = u / np.linalg.norm(u)

    def rotate(self, yaw, pitch):
        d = rotate_about(self.dir, self.right, -pitch)
        d = rotate_about(d, self.up, -yaw)
        self.dir = d / np.linalg.norm(d)
        r = np.cross(self.dir, self.up)
        self.right = r / np.linalg.norm(r)
        u = np.cross(self.right, self.dir)
        self.up = u / np.linalg.norm(u)

    def move(self, x, y, z):
        self.eye = self.eye + self.right * x + self.up * y + self.dir * z


ROT_STEP = 0.05  # radians per keypress (the mouse-look analog)

# key -> (move (x, y, z) in units of the speed, rotate (yaw, pitch))
_MOVES = {"U": (0, 0, 1), "D": (0, 0, -1), "L": (-1, 0, 0), "R": (1, 0, 0)}
_TURNS = {"w": (0.0, -ROT_STEP), "s": (0.0, ROT_STEP),
          "a": (-ROT_STEP, 0.0), "d": (ROT_STEP, 0.0)}


def apply_key(rig, key, tspeed):
    """One key event -> (moved, quit, save, tspeed). U/D/L/R are the arrow
    keys (move, driver.cpp:106-110), w/s/a/d rotate (mouse-look,
    driver.cpp:96-99), +/- change the speed, p saves, q/ESC quit."""
    if key in _MOVES:
        x, y, z = _MOVES[key]
        rig.move(x * tspeed, y * tspeed, z * tspeed)
        return True, False, False, tspeed
    if key in _TURNS:
        rig.rotate(*_TURNS[key])
        return True, False, False, tspeed
    if key == "+":
        tspeed *= 1.1
    elif key == "-":
        tspeed *= 0.9
    return False, key in ("q", "\x1b"), key == "p", tspeed


def ansi_frame(img):
    """uint8 (H, W, 3) image -> ANSI truecolor string, two image rows per
    text line via the upper-half-block glyph (fg = top row, bg = bottom).
    H is rounded down to even."""
    h = img.shape[0] & ~1
    lines = []
    for y in range(0, h, 2):
        top, bot = img[y], img[y + 1]
        cells = [f"\x1b[38;2;{int(t[0])};{int(t[1])};{int(t[2])}m"
                 f"\x1b[48;2;{int(b[0])};{int(b[1])};{int(b[2])}m▀"
                 for t, b in zip(top, bot)]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class _TtyKeys:
    """Raw non-blocking tty key source; arrow escape sequences are decoded
    to U/D/L/R. Gives no keys when stdin is not a tty."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._fd = None
        self._saved = None

    def __enter__(self):
        if self.enabled:
            import termios
            import tty
            self._fd = sys.stdin.fileno()
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def poll(self):
        """All pending keys (non-blocking)."""
        if not self.enabled:
            return []
        import select

        def ready():
            return select.select([sys.stdin], [], [], 0)[0]

        keys = []
        while ready():
            ch = sys.stdin.read(1)
            if ch == "":
                # EOF (the pty closed): select keeps reporting readable
                # while read returns '', so quit instead of spinning
                keys.append("q")
                self.enabled = False
                break
            if ch == "\x1b" and ready():
                if sys.stdin.read(1) == "[" and ready():
                    arrow = {"A": "U", "B": "D", "D": "L",
                             "C": "R"}.get(sys.stdin.read(1))
                    if arrow:
                        keys.append(arrow)
                continue
            keys.append(ch)
        return keys


class _ScriptedKeys:
    """--keys: one key per iteration, the tty untouched."""

    def __init__(self, keys):
        self.keys = list(keys)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def poll(self):
        return [self.keys.pop(0)] if self.keys else []


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="view")
    p.add_argument("scene")
    p.add_argument("--eye", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    p.add_argument("--dir", type=float, nargs=3, default=(0.0, 0.0, 1.0))
    p.add_argument("--up", type=float, nargs=3, default=(0.0, 1.0, 0.0))
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--width", type=int, default=0,
                   help="render width (0: fit the terminal)")
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--spp", type=int, default=1,
                   help="samples per progressive iteration")
    p.add_argument("--max-path-len", type=int, default=8)
    p.add_argument("--iters", type=int, default=0,
                   help="stop after N iterations (0 = until quit)")
    p.add_argument("--keys", default=None,
                   help="scripted key sequence (one per iteration; "
                        "U/D/L/R = arrows) instead of reading the tty")
    p.add_argument("-o", "--output", default="view.png",
                   help="PNG written by the p key / at exit")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain torch version on the CPU")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the ANSI frame output (tests)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..experiments import common
    device = common.device_of(args, "view")
    from ..io import png
    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.compiler import compile_obj, select_render_policy
    from ..render.integrator import render_iteration_persistent

    if args.width and args.height:
        w, h = args.width, args.height
    else:
        cols, rows = shutil.get_terminal_size((80, 24))
        w = args.width or min(cols, 160)
        h = args.height or max(2 * (rows - 2), 2) & ~1

    scene = compile_obj(args.scene, device, max_path_len=args.max_path_len)
    policy = select_render_policy(scene.device)
    rig = CameraRig(args.eye, args.dir, args.up)
    tspeed = 0.1
    film = film_mod.new_film(w, h, device)
    iter_count = 0
    total = 0
    out = sys.stdout

    def render_one():
        nonlocal film, iter_count
        cam = Camera.make(tuple(rig.eye), tuple(rig.dir), tuple(rig.up),
                          args.fov, w, h)
        film = render_iteration_persistent(scene.device, cam, film, w, h,
                                           args.spp, iter_count, **policy)
        iter_count += 1
        return film_mod.tonemap(film, w, h, iter_count)

    keysrc = (_TtyKeys() if args.keys is None
              else _ScriptedKeys(args.keys))
    with keysrc:
        while True:
            t0 = time.perf_counter()
            img = render_one()
            dt = time.perf_counter() - t0
            total += 1
            if not args.quiet:
                out.write("\x1b[H\x1b[2J" + ansi_frame(img) + "\n")
                out.write(f"iter {iter_count}  {w}x{h}  spp {args.spp}  "
                          f"{w * h * args.spp / dt / 1e6:.2f} Msamples/s  "
                          f"[arrows move, wasd look, +/- speed, p save, "
                          f"q quit]\n")
                out.flush()
            stop = False
            for k in keysrc.poll():
                moved, quit_, save, tspeed = apply_key(rig, k, tspeed)
                if save:
                    png.write_png(args.output, img)
                if moved:
                    film = film_mod.new_film(w, h, device)
                    iter_count = 0
                stop = stop or quit_
            if stop or (args.iters and total >= args.iters):
                break
    if args.output:
        png.write_png(args.output,
                      film_mod.tonemap(film, w, h, max(iter_count, 1)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
