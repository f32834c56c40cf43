"""The pair-layout traversal, K6, against K1 on the hall workloads (port of
experiments/measure_pair.py).

On hall-260K (BVH8/Tri8) with 1M rays of each distribution (sorted
primaries, and ao any-hit and bounce rays from the primaries' hit points,
sorted), K6 is timed in turns against K1 (K1, K6, K6, K1) for each of
--tiles, then counted. Printed per distribution and tile: Mrays/s, K6's
time, pops per tile (mean and max), ns per pop (K6's time over all tile
pops) and K6's time over K1's. The TPU script's streams (independent tiles
interleaved in one grid step) have no counterpart: the card runs the
tiles' blocks side by side.

Usage: python -m rodent_tpu_torch.experiments.measure_pair [--tris 260000]
    [--rays 1048576] [--tiles 256,1024,2048] [--dists primary,ao,bounces]
    [--blocks 5] [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..traversal import packet, pair
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(prog="measure_pair")
    p.add_argument("--tris", type=int, default=260_000)
    p.add_argument("--rays", type=int, default=1024 * 1024)
    p.add_argument("--tiles", default="256,1024,2048")
    p.add_argument("--dists", default="primary,ao,bounces")
    common.add_args(p)
    args = p.parse_args(argv)
    tiles = [int(x) for x in args.tiles.split(",")]
    for tr in tiles:
        if tr not in pair.PAIR_TILES:
            p.error(f"--tiles: {tr} is not one of {pair.PAIR_TILES}")
    device = common.device_of(args, "measure_pair")
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
    print(f"{'dist':>8} {'tile':>6} {'Mrays/s':>9} {'K6 ms':>9} "
          f"{'pops/tile':>9} {'max':>7} {'ns/pop':>9} {'vs K1':>6}",
          flush=True)
    for name, (comps, any_hit) in dists.items():
        def k1():
            return packet.traverse_packet_components(dev, *comps,
                                                     any_hit=any_hit)
        for i, tr in enumerate(tiles):
            def k6(tr=tr):
                return pair.traverse_pair_packet_components(
                    dev, *comps, any_hit=any_hit, tile_rays=tr)
            k1_ms, k6_ms, _, _ = common.in_turns(
                k1, k6, device, args.blocks,
                common.WARMUP_S if i == 0 else 0.0)
            t = common.tile_stats(common.counted_pair(dev, comps, any_hit,
                                                      tr), tr, n)
            print(f"{name:>8} {tr:>6} {n / k6_ms / 1e3:9.2f} {k6_ms:9.4f} "
                  f"{t['mean']:9.1f} {t['max']:7d} "
                  f"{k6_ms * 1e6 / t['pops']:9.2f} {k6_ms / k1_ms:6.2f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
