"""bench_traversal: the Mrays/s benchmark + correctness harness (port of
rodent_tpu/tools/bench_traversal.py; CLI of the reference's
tools/bench_traversal/bench_traversal.cpp).

Loads a .bvh and a .rays file (rodent_tpu_torch.io.formats), runs
warm-up and timed iterations of closest-hit (intersect) or any-hit
(occluded, -any) traversal, prints the intersection count and
"N Mrays/sec" (the line benchmarks/benchmark.py parses), and optionally
dumps hit distances as .fbuf.

--variant packet runs K1 (csrc/bvh_traverse.cu); hbm and giga run K2, K1
with the exact next-pop L2 prefetch. The dual-queue variants (tiled,
tiled-c; ROADMAP A4) and --sharded (ROADMAP A6) are not ported. A
timed iteration is a sample of rodent_tpu_torch.experiments.common: CUDA
events around a block of back-to-back calls, about 20 ms long, on a card;
--cpu runs the plain torch version on the CPU, one call per iteration on
the host clock. Without --cpu the tool needs a CUDA card.

Usage:
  python -m rodent_tpu_torch.tools.bench_traversal -bvh scene.bvh
      -ray cam.rays [--tmin T] [--tmax T] [-any] [--bench N] [--warmup N]
      [-o out.fbuf] [--bvh-width 8] [--sort] [--variant packet|hbm|giga]
      [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..experiments import common


def main(argv=None):
    p = argparse.ArgumentParser(prog="bench_traversal")
    p.add_argument("-bvh", "--bvh", required=True)
    p.add_argument("-ray", "--ray", required=True)
    p.add_argument("--tmin", type=float, default=0.0)
    p.add_argument("--tmax", type=float, default=3.402823466e38)
    p.add_argument("-any", "--any", action="store_true",
                   help="any-hit (occlusion) instead of closest-hit")
    p.add_argument("--bench", type=int, default=1,
                   help="timed iterations")
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("-o", "--output", default=None,
                   help="dump hit t per ray as .fbuf")
    p.add_argument("--bvh-width", type=int, default=None, choices=(2, 4, 8),
                   help="which BVH block to load (default: first present)")
    p.add_argument("--sort", action="store_true",
                   help="octant+Morton ray reordering before traversal")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain torch version on the CPU")
    p.add_argument("--variant", choices=("packet", "hbm", "giga"),
                   default="packet",
                   help="packet: K1; hbm, giga: K2 (K1 with the next-pop "
                        "L2 prefetch)")
    args = p.parse_args(argv)
    device = common.device_of(args, "bench_traversal")

    from ..accel.layout import WideBvh
    from ..io import formats
    from ..traversal.api import bvh_to_device, make_rays
    from ..traversal.packet import traverse_packet
    from ..traversal.sorting import sort_rays

    btype = {2: formats.BVH2_TRI1, 4: formats.BVH4_TRI4,
             8: formats.BVH8_TRI4}.get(args.bvh_width)
    bvh = WideBvh.from_block(formats.read_bvh(args.bvh, btype))
    dev = bvh_to_device(bvh, device)
    r = formats.read_rays(args.ray, tmin=args.tmin, tmax=args.tmax)
    n = len(r["org"])
    rays = make_rays(r["org"], r["dir"], r["tmin"], r["tmax"],
                     device=device)
    perm = None
    if args.sort:
        b = bvh.bounds[0]                  # root children's slabs
        lo = [b[0].min(), b[2].min(), b[4].min()]
        hi = [b[1].max(), b[3].max(), b[5].max()]
        rays, perm = sort_rays(rays, lo, hi)

    def fn():
        return traverse_packet(dev, rays, any_hit=args.any,
                               prefetch=args.variant in ("hbm", "giga"))

    for _ in range(max(args.warmup, 1)):
        hit = fn()
    times_ms, hit = common.samples(fn, device, max(args.bench, 1))
    if perm is not None:
        out = {k: torch.empty_like(v) for k, v in hit.items()}
        for k, v in hit.items():
            out[k][perm] = v
        hit = out
    prim = hit["prim_id"].cpu().numpy()
    times_ms = np.asarray(times_ms)
    med = float(np.median(times_ms))
    print(f"{int((prim >= 0).sum())} intersection(s)")
    print(f"# avg/med/min: {times_ms.mean():.2f}/{med:.2f}/"
          f"{times_ms.min():.2f} ms")
    print(f"{n * 1e-6 / (med * 1e-3):.2f} Mrays/sec")
    if args.output:
        t = hit["t"].cpu().numpy().astype(np.float32)
        if args.any:
            t = (prim >= 0).astype(np.float32)   # 1 where blocked
        formats.write_fbuf(args.output, t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
