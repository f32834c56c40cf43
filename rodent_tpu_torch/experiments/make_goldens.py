"""Converged golden films of the procedural bench scenes, made by the port
(port of experiments/make_goldens.py).

Renders hall, crown and mathall in their fixed configurations (CONFIGS,
the JAX file's: size, image, spp, camera and emitter) through
render_iteration_persistent with the dual-queue engine (packet=False,
compact=5), as the JAX file renders them: a long render of `--iters`
iterations (the golden) and a short one of TEST_ITERS (what the golden
tests render), and writes <scene>.png and golden_meta.json with the short
render's MSE against the long one (the gate's calibration).

It writes to build/goldens/ (gitignored) and refuses tests/golden/, the
JAX package's goldens, which its tests read. Each film is held against
the golden in tests/golden/ under the gate's rule, mse_u8 <= 3 x calib
+ 1 with the stored calibration: the short render, as
tests/test_golden_scenes.py holds it, and the long one.

The JAX file's flags keep their meaning; the measuring programs'
--blocks has none here, since nothing is timed.

Usage: python -m rodent_tpu_torch.experiments.make_goldens [--iters 30]
    [--scenes hall,crown,mathall] [--out build/goldens] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from ..io import png
from ..render import film as film_mod
from ..render.camera import Camera
from ..render.compiler import compile_mesh
from ..render.integrator import render_iteration_persistent
from ..utils import testscenes
from . import common

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "build" / "goldens"
STORED = REPO / "tests" / "golden"
# scene -> (tris, W, H, spp, eye, dir, fov, emitter)
# (experiments/make_goldens.py:27-34)
CONFIGS = {
    "hall": (40_000, 160, 90, 2, (2.5, 5.0, 5.0), (1.0, -0.12, 0.02),
             60.0, "inside"),
    "crown": (60_000, 160, 90, 2, (4.2, 1.8, 1.2), (-4.2, -1.4, -1.2),
              42.0, "above"),
    "mathall": (40_000, 160, 90, 2, (2.5, 5.0, 5.0), (1.0, -0.12, 0.02),
                60.0, "inside"),
}
TEST_ITERS = 2


def build_scene(name, tris, device, mpl=8):
    """The scene as the JAX file compiles it (max path length 8)."""
    if name == "crown":
        verts, idx = testscenes.make_crown(tris)
        return compile_mesh(verts, idx, device, max_path_len=mpl,
                            emitter="above")
    verts, idx = testscenes.make_hall(tris, rich_mats=name == "mathall")
    kw = {}
    if name == "mathall":
        mats, texs = testscenes.mat_hall_materials()
        kw = {"materials": mats, "tex_images": texs}
    return compile_mesh(verts, idx, device, max_path_len=mpl,
                        emitter="inside", **kw)


def render(scene, name, iters, device):
    """The tonemapped film (H, W, 3) u8 of `iters` persistent iterations
    through the dual-queue engine."""
    _, w, h, spp, eye, dirv, fov, _ = CONFIGS[name]
    cam = Camera.make(eye, dirv, (0, 1, 0), fov, w, h)
    film = film_mod.new_film(w, h, device)
    for it in range(iters):
        film = render_iteration_persistent(scene.device, cam, film, w, h,
                                           spp, it, packet=False, compact=5)
    return film_mod.tonemap(film, w, h, iters)


def gate(img, name):
    """(mse_u8 against tests/golden/<name>.png, the gate 3 x calib + 1)."""
    with open(STORED / "golden_meta.json") as f:
        calib = json.load(f)[name]["calib_mse_u8"]
    golden = png.read_png(STORED / f"{name}.png")[..., :3]
    return film_mod.mse_u8(golden, img), 3.0 * calib + 1.0


def run(device, scenes=tuple(CONFIGS), iters=30, out=OUT):
    """{scene: meta entry with "gate_short" and "gate_long" (mse, gate)};
    raises where a film is outside the gate."""
    out = Path(out)
    if out.resolve() == STORED.resolve():
        raise ValueError(f"make_goldens: {out} holds the JAX package's "
                         "goldens, which its tests read; write elsewhere")
    out.mkdir(parents=True, exist_ok=True)
    meta_path = out / "golden_meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    res = {}
    for name in scenes:
        tris, w, h, spp, *_ = CONFIGS[name]
        t0 = time.perf_counter()
        scene = build_scene(name, tris, device)
        golden = render(scene, name, iters, device)
        short = render(scene, name, TEST_ITERS, device)
        secs = time.perf_counter() - t0
        mse = film_mod.mse_u8(golden, short)
        png.write_png(str(out / f"{name}.png"), golden.astype(np.uint8))
        entry = {"tris": tris, "w": w, "h": h, "spp": spp,
                 "golden_iters": iters, "test_iters": TEST_ITERS,
                 "calib_mse_u8": round(float(mse), 2),
                 "mean_u8": round(float(golden.mean()), 2)}
        meta[name] = entry
        g_short, g_long = gate(short, name), gate(golden, name)
        res[name] = dict(entry, gate_short=g_short, gate_long=g_long,
                         seconds=secs)
        print(f"{name}: golden mean {golden.mean():.1f}, short-render MSE "
              f"{mse:.1f} (gate = 3x); against tests/golden: short "
              f"{g_short[0]:.2f}, long {g_long[0]:.2f} <= {g_short[1]:.2f}; "
              f"{secs:.1f} s", flush=True)
        for what, (m, limit) in (("short", g_short), ("long", g_long)):
            if m > limit:
                raise RuntimeError(f"make_goldens {name}: the {what} render's "
                                   f"MSE {m:.2f} against tests/golden is "
                                   f"over the gate {limit:.2f}")
    meta_path.write_text(json.dumps(meta, indent=1))
    print(f"wrote {meta_path}", flush=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="make_goldens")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--out", default=str(OUT))
    p.add_argument("--scenes", default=",".join(CONFIGS))
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the plain torch versions)")
    args = p.parse_args(argv)
    scenes = args.scenes.split(",")
    if any(s not in CONFIGS for s in scenes):
        p.error(f"--scenes {args.scenes}: each one of {tuple(CONFIGS)}")
    device = common.device_of(args, "make_goldens")
    print(f"card: {common.card(device)}", flush=True)
    run(device, scenes, args.iters, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
