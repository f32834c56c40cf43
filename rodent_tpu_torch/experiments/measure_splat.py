"""Time the persistent renderer on the cornell scene at the bench's
configuration (port of experiments/measure_splat.py, which A/B'd the
planar film's splat): one untimed iteration, then --iters - 1 timed ones
(host clock, synchronised), through K1 where the scene's tables fit the
fast memory (packet_ok) and the dual-queue engine where not.

The scene, its size and the camera are ab_cornell_engine's: the
reference's cornell_box.obj at its ref-cornell.png's size where
--reference exists, else the stand-in open box at 1080x720. It prints
ms/iter and Msamples/s, then the MSE of the tonemapped film against
ref-cornell.png where the reference exists, else the tonemapped film's
mean and that there is no reference.

Usage: python -m rodent_tpu_torch.experiments.measure_splat
    [--reference DIR] [--wh WxH] [--spp 4] [--iters 10] [--cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

from ..render import film as film_mod
from ..render.camera import Camera
from ..render.compiler import packet_ok
from ..render.integrator import render_iteration_persistent
from ..utils.profiling import synchronize
from . import ab_cornell_engine, common

# measure_splat.py:23: the bench's max path length
MAX_PATH_LEN = 64


def run(device, scene, ref, size, spp, iters, out=print):
    """iters iterations (the first untimed); returns ms per iteration,
    Msamples/s, the MSE against ref (None without one), the tonemapped
    film's mean and the film."""
    w, h = size
    use_packet = packet_ok(scene.device)
    cam = Camera.make(*ab_cornell_engine.CORNELL_VIEW, w, h)
    film = render_iteration_persistent(scene.device, cam,
                                       film_mod.new_film(w, h, device), w, h,
                                       spp, 0, packet=use_packet)
    synchronize(film)
    t0 = time.perf_counter()
    for it in range(1, iters):
        film = render_iteration_persistent(scene.device, cam, film, w, h,
                                           spp, it, packet=use_packet)
    synchronize(film)
    dt = time.perf_counter() - t0
    ms, msps = dt / (iters - 1) * 1e3, w * h * spp * (iters - 1) / dt / 1e6
    out(f"cornell {w}x{h} spp{spp} packet={use_packet}: {ms:.1f} ms/iter "
        f"({msps:.3f} Msamples/s) over {iters - 1} iters")
    img = film_mod.tonemap(film, w, h, iters)
    mse = None if ref is None else film_mod.mse_u8(ref, img)
    if mse is None:
        out(f"no reference image: the tonemapped film's mean "
            f"{img.mean():.2f}/255 at {iters} iters")
    else:
        out(f"MSE vs ref at {iters} iters: {mse:.2f}")
    return {"ms": ms, "msamples": msps, "mse": mse,
            "mean": float(img.mean()), "packet": use_packet, "film": film}


def main(argv=None):
    p = argparse.ArgumentParser(prog="measure_splat")
    ab_cornell_engine.add_scene_args(p)
    p.add_argument("--iters", type=int, default=10,
                   help="iterations, the first one untimed")
    common.add_args(p)
    args = p.parse_args(argv)
    if args.iters < 2:
        raise SystemExit("measure_splat: --iters must be at least 2 (the "
                         "first iteration is untimed)")
    device = common.device_of(args, "measure_splat")
    scene, ref, size, line = ab_cornell_engine.load_scene(
        args.reference, device, MAX_PATH_LEN,
        ab_cornell_engine.parse_wh(args.wh))
    if ref is not None and ref.shape[:2] != (size[1], size[0]):
        raise SystemExit(f"measure_splat: --wh {args.wh} is not the "
                         f"reference image's size "
                         f"{ref.shape[1]}x{ref.shape[0]}")
    print(line, flush=True)
    print(f"card: {common.card(device)}", flush=True)
    run(device, scene, ref, size, args.spp, args.iters,
        out=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
