"""quality_gate: the reference's ctest golden-image check as one CLI (torch
port of rodent_tpu/tools/quality_gate.py).

Mirrors cmake/test/run_rodent.cmake: the cornell box rendered with the
fixed camera (eye 0 1 2.7, looking down -z, fov 60) at the reference
image's size, 50 iterations x 4 spp by default through
render_iteration_persistent under select_render_policy, then the MSE on u8
values against the reference PNG. It passes when the MSE is at most the
threshold, by default 1.45 * (337 / iters + 7.0): the JAX package's
convergence model MSE(N) = 337/N + 7.0 (pure 1/N Monte-Carlo noise toward
the reference image's own floor) with 45% headroom. --checkpoints records
the MSE at more iteration counts (the convergence curve); --fast renders
at 1/8 of the size against the reference averaged over 8x8 blocks.

The scene and the reference default to testing/cornell_box.obj and
testing/ref-cornell.png of the reference checkout (AnyDSL/rodent) named
by the RODENT_REFERENCE environment variable (default: ./reference).
Where a file is missing the tool exits with an error that names it: a
gate that cannot run is never a pass.

It runs on the CUDA card; --cpu runs the plain torch version on the CPU.
Without --cpu the tool needs a card.

Usage:
  python -m rodent_tpu_torch.tools.quality_gate [--iters 50]
      [--threshold MSE] [--scene OBJ] [--ref PNG] [-o out.png] [--cpu]
      [--fast] [--checkpoints 25,50,100]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..utils.profiling import synchronize

REFERENCE_ENV = "RODENT_REFERENCE"
CAMERA = ((0.0, 1.0, 2.7), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), 60.0)


def default_path(name):
    """testing/<name> of the reference checkout ($RODENT_REFERENCE)."""
    return os.path.join(os.environ.get(REFERENCE_ENV, "reference"),
                        "testing", name)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="quality_gate")
    p.add_argument("--scene", default=None,
                   help="OBJ scene (default: the reference checkout's "
                        "testing/cornell_box.obj)")
    p.add_argument("--ref", default=None,
                   help="reference PNG (default: the reference "
                        "checkout's testing/ref-cornell.png)")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--threshold", type=float, default=None,
                   help="max allowed MSE on u8 values; default "
                        "1.45 * (337/iters + 7.0) from the measured "
                        "convergence model")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run the plain torch version on the CPU")
    p.add_argument("--fast", action="store_true",
                   help="1/8 resolution + downsampled reference")
    p.add_argument("--checkpoints", default="",
                   help="comma list of iteration counts at which to "
                        "record the MSE (the convergence curve)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..experiments import common
    device = common.device_of(args, "quality_gate")
    scene_path = args.scene or default_path("cornell_box.obj")
    ref_path = args.ref or default_path("ref-cornell.png")
    for path, flag in ((scene_path, "--scene"), (ref_path, "--ref")):
        if not os.path.isfile(path):
            sys.exit(f"quality_gate: {path} does not exist; pass {flag}, "
                     f"or set {REFERENCE_ENV} to the reference checkout")
    from ..io import png
    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.compiler import compile_obj, select_render_policy
    from ..render.integrator import render_iteration_persistent

    ref = png.read_png(ref_path)[..., :3]
    h0, w0 = ref.shape[:2]
    if args.fast:
        w, h = w0 // 8, h0 // 8
        ref = ref[:h * 8, :w * 8].reshape(h, 8, w, 8, 3).mean((1, 3))
    else:
        w, h = w0, h0

    scene = compile_obj(scene_path, device, max_path_len=64)
    policy = select_render_policy(scene.device)
    cam = Camera.make(*CAMERA, w, h)
    film = film_mod.new_film(w, h, device)
    checkpoints = sorted(int(t) for t in args.checkpoints.split(",") if t)
    iters = max([args.iters] + checkpoints)
    if args.threshold is None:
        args.threshold = 1.45 * (337.0 / iters + 7.0)
    t0 = time.time()
    for it in range(iters):
        film = render_iteration_persistent(scene.device, cam, film, w, h,
                                           args.spp, it, **policy)
        if it + 1 in checkpoints:
            img_c = film_mod.tonemap(film, w, h, it + 1)
            print(f"checkpoint {it + 1:5d} iters "
                  f"({(it + 1) * args.spp} spp): "
                  f"MSE={film_mod.mse_u8(ref, img_c):.3f}", flush=True)
    synchronize(film)
    img = film_mod.tonemap(film, w, h, iters)
    if args.output:
        png.write_png(args.output, img)

    mse = film_mod.mse_u8(ref, img)
    mad = float(np.mean(np.abs(ref.astype(np.float64)
                               - img.astype(np.float64))))
    msamp = w * h * args.spp * iters / (time.time() - t0) / 1e6
    print(f"cornell {w}x{h}, {iters} iters x {args.spp} spp: "
          f"MSE={mse:.2f} mean|diff|={mad:.2f}/255 ({msamp:.2f} Msamples/s)")
    if mse > args.threshold:
        print(f"FAIL: MSE {mse:.2f} > threshold {args.threshold}")
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
