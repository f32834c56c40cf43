"""Where the traversal kernels' time goes per ray distribution (port of
experiments/measure_packet.py).

On hall-260K (BVH8/Tri8) with 1M rays of each distribution (sorted
primaries, ao any-hit rays and bounce rays from the primaries' hit
points, both sorted):

- K1, one thread per ray, is timed with CUDA events and K3 counts its
  pops. Printed: Mrays/s; mean pops per ray; the mean over warps of the
  largest pop count in a warp (a warp runs as long as its longest ray);
  their ratio; the warp's SIMT efficiency (mean pops over warp-max pops,
  the share of a warp's pop slots that do work); and ns per pop, K1's time
  over all pops.
- K5, the tile route whose tiles of 128 x rows rays share one stack (the
  JAX script's subject), for each of --rows, timed in turns against K1
  (K1, K5, K5, K1), then counted. Printed as there: Mrays/s, pops per tile
  (mean and max), ns per pop (K5's time over all tile pops) and pops per
  ray-equivalent (total pops x tile size / rays); beside them K5's time
  over K1's. --frustum takes the row-frustum node test on octant-pure
  tiles.

Usage: python -m rodent_tpu_torch.experiments.measure_packet [--tris 260000]
    [--rays 1048576] [--dists primary,ao,bounces] [--rows 1,2,4,16]
    [--frustum] [--blocks 5] [--cpu]
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
    p.add_argument("--rows", default="1,2,4,16",
                   help="128-ray rows per K5 tile (a list)")
    p.add_argument("--frustum", action="store_true",
                   help="K5's row-frustum node test on octant-pure tiles")
    common.add_args(p)
    args = p.parse_args(argv)
    rows_list = [int(r) for r in args.rows.split(",")]
    for rows in rows_list:
        api.check_options(False, frustum=args.frustum, tile_rows=rows)
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
          f"rays per distribution; K5 frustum={args.frustum}", flush=True)
    print(f"{'dist':>8} {'kernel':>6} {'Mrays/s':>9} {'ms':>9} "
          f"{'pops/ray':>9} {'leaf/ray':>9} {'warp-max':>9} {'ratio':>6} "
          f"{'SIMT':>6} {'ns/pop':>9}", flush=True)
    print(f"{'dist':>8} {'rows':>6} {'Mrays/s':>9} {'ms':>9} "
          f"{'pops/tile':>9} {'max':>9} {'ns/pop':>9} {'ray-equiv':>9} "
          f"{'vs K1':>6}", flush=True)
    for name, (comps, any_hit) in dists.items():
        def k1():
            return packet.traverse_packet_components(dev, *comps,
                                                     any_hit=any_hit)
        ms = common.timed(k1, device, args.blocks,
                          warmup_s=common.WARMUP_S)[0]
        s = common.pop_stats(common.counted(dev, comps, any_hit))
        ratio = s["warp_pops"] / s["pops_ray"]
        print(f"{name:>8} {'K1':>6} {n / ms / 1e3:9.2f} {ms:9.4f} "
              f"{s['pops_ray']:9.3f} {s['leaf_ray']:9.3f} "
              f"{s['warp_pops']:9.3f} {ratio:6.3f} {1.0 / ratio:6.3f} "
              f"{ms * 1e6 / s['pops']:9.5f}", flush=True)
        for rows in rows_list:
            def k5(rows=rows):
                return packet.traverse_packet_components(
                    dev, *comps, any_hit=any_hit, tile_rows=rows,
                    frustum=args.frustum)
            k1_ms, k5_ms, _, _ = common.in_turns(k1, k5, device,
                                                 args.blocks)
            t = common.tile_stats(common.counted_tile(
                dev, comps, any_hit, rows, args.frustum), 128 * rows, n)
            print(f"{name:>8} {rows:>6} {n / k5_ms / 1e3:9.2f} "
                  f"{k5_ms:9.4f} {t['mean']:9.1f} {t['max']:9d} "
                  f"{k5_ms * 1e6 / t['pops']:9.2f} {t['ray_equiv']:9.1f} "
                  f"{k5_ms / k1_ms:6.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
