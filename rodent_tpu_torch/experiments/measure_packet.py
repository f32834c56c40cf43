"""Where the traversal kernel's time goes per ray distribution (port of
experiments/measure_packet.py).

On hall-260K (BVH8/Tri8) with 1M rays of each distribution (sorted
primaries, ao any-hit rays and bounce rays from the primaries' hit
points, both sorted), K1 is timed with CUDA events and K3 counts its pops.
Printed per distribution: Mrays/s; mean pops per ray; the mean over
warps of the largest pop count in a warp (a warp runs as long as its
longest ray: the card's counterpart of the TPU's pops per tile, whose
rays share one stack); their ratio; the warp's SIMT efficiency (mean pops
over warp-max pops, the share of a warp's pop slots that do work); and
ns per pop, K1's time over all pops.

--frustum raises, as api.traverse does: the row-frustum test needs a
warp-shared stack (ROADMAP B3a).

Usage: python -m rodent_tpu_torch.experiments.measure_packet [--tris 260000]
    [--rays 1048576] [--dists primary,ao,bounces] [--blocks 5] [--frustum]
    [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..traversal import api, packet
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(prog="measure_packet")
    p.add_argument("--tris", type=int, default=260_000)
    p.add_argument("--rays", type=int, default=1024 * 1024)
    p.add_argument("--dists", default="primary,ao,bounces")
    p.add_argument("--frustum", action="store_true")
    common.add_args(p)
    args = p.parse_args(argv)
    api.check_options(False, frustum=args.frustum)
    device = common.device_of(args, "measure_packet")
    print(f"card: {common.card(device)}", flush=True)
    verts, idx, dev, secs = common.load("hall", common.TRI8, device,
                                        args.tris)
    side = int(np.sqrt(args.rays))
    n = side * side
    dists = common.distributions("hall", verts, idx, dev, side, device,
                                 args.dists.split(","))
    print(f"hall-{args.tris // 1000}K: {dev['nodes'].shape[0]} BVH8 nodes, "
          f"{dev['tris'].shape[0]} Tri8 rows (built in {secs:.1f} s); {n} "
          f"rays per distribution", flush=True)
    print(f"{'dist':>8} {'Mrays/s':>9} {'K1 ms':>9} {'pops/ray':>9} "
          f"{'leaf/ray':>9} {'warp-max':>9} {'ratio':>6} {'SIMT':>6} "
          f"{'ns/pop':>9}", flush=True)
    for name, (comps, any_hit) in dists.items():
        ms, _ = common.timed(lambda: packet.traverse_packet_components(
            dev, *comps, any_hit=any_hit), device, args.blocks,
            warmup_s=common.WARMUP_S)
        s = common.pop_stats(common.counted(dev, comps, any_hit))
        ratio = s["warp_pops"] / s["pops_ray"]
        print(f"{name:>8} {n / ms / 1e3:9.2f} {ms:9.4f} {s['pops_ray']:9.3f} "
              f"{s['leaf_ray']:9.3f} {s['warp_pops']:9.3f} {ratio:6.3f} "
              f"{1.0 / ratio:6.3f} {ms * 1e6 / s['pops']:9.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
