"""Per-pop cost bisection of the pair-layout traversal K6 by ablation (port
of experiments/ablate_pair.py; the hits of most ablations are wrong, the
times are the point).

hall-260K (BVH8/Tri8), 1M sorted primaries, tiles of 2,048 rays: K6 with
each ablation of the JAX script that has a counterpart, each timed in
turns against K6 without it (K6, ablated, ablated, K6) and counted.
Printed per case: Mrays/s, ns per pop, the tile pops, and the time over
K6's. "nomatmul" and "fastmatmul" ablate the TPU's matrix-unit broadcast of
a row, which the card's kernel does not have (traversal/pair.py), so their
cases are left out.

Usage: python -m rodent_tpu_torch.experiments.ablate_pair [--tris 260000]
    [--rays 1048576] [--tile 2048] [--blocks 5] [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..traversal import pair
from . import common

# experiments/ablate_pair.py:28-38, less the matrix-unit ablations
CASES = [(), ("noleaf",), ("nonode",), ("nostrip",), ("nosort",),
         ("noleaf", "nonode")]


def main(argv=None):
    p = argparse.ArgumentParser(prog="ablate_pair")
    p.add_argument("--tris", type=int, default=260_000)
    p.add_argument("--rays", type=int, default=1024 * 1024)
    p.add_argument("--tile", type=int, default=pair.TILE_RAYS,
                   choices=pair.PAIR_TILES)
    common.add_args(p)
    args = p.parse_args(argv)
    device = common.device_of(args, "ablate_pair")
    print(f"card: {common.card(device)}", flush=True)
    verts, idx, dev, secs = common.load("hall", common.TRI8, device,
                                        args.tris)
    side = int(np.sqrt(args.rays))
    n = side * side
    comps = common.distributions("hall", verts, idx, dev, side, device,
                                 ("primary",))["primary"][0]
    print(f"hall-{args.tris // 1000}K: {dev['nodes'].shape[0]} BVH8 nodes, "
          f"{dev['tris'].shape[0]} Tri8 rows (built in {secs:.1f} s); {n} "
          f"sorted primaries, tiles of {args.tile} rays", flush=True)

    def run(ab):
        return lambda: pair.traverse_pair_packet_components(
            dev, *comps, tile_rays=args.tile, ablate=ab)

    for i, ab in enumerate(CASES):
        base_ms, ms, _, _ = common.in_turns(
            run(()), run(ab), device, args.blocks,
            common.WARMUP_S if i == 0 else 0.0)
        t = common.tile_stats(common.counted_pair(dev, comps, False,
                                                  args.tile, ab),
                              args.tile, n)
        print(f"{','.join(ab) or 'baseline':>14}: {n / ms / 1e3:9.2f} "
              f"Mrays/s {ms * 1e6 / max(t['pops'], 1):9.2f} ns/pop "
              f"({t['pops']} pops; {ms / base_ms:.3f}x K6)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
