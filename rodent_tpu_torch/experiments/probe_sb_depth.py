"""Sub-batch depth of the dual-queue engine (port of
experiments/probe_sb_depth.py): on hall-260K's 1M sorted ao and bounce
rays, traversal/tiled.py with staged compaction (compact_stages=5) at
each sub-batch count of `--subs`, in Mrays/s. A deeper split gives each
chunk its own lockstep tail (the trips of its slowest ray) and pays one
more loop with its host reads per chunk. The JAX file's early-returning
block_until_ready has no counterpart: common.timed synchronises the
card.

Usage: python -m rodent_tpu_torch.experiments.probe_sb_depth
    [--subs 16,32,64] [--dist ao,bounces] [--blocks 5] [--cpu --tris
    20000 --side 64]
"""
from __future__ import annotations

import argparse
import sys

from ..traversal import tiled
from . import common

SUBS = (16, 32, 64)


def run(device, subs=SUBS, dists=("ao", "bounces"), blocks=5, tris=None,
        side=1024):
    """{(dist, sub_batches): ms}; sub_batches 0 is one chunk."""
    verts, idx, dev, _ = common.load("hall", common.TRI8, device, tris)
    data = common.distributions("hall", verts, idx, dev, side, device, dists)
    res, first = {}, True
    for kind, (comps, any_hit) in data.items():
        n = comps[4].shape[0]
        rows = -(-n // tiled.ROW)
        print(f"== {kind} ({n} rays, {rows} rows)", flush=True)
        for sb in subs:
            def call(comps=comps, any_hit=any_hit, sb=sb):
                return tiled.traverse_components(
                    dev, *comps, any_hit=any_hit, compact_stages=5,
                    sub_batches=sb)
            ms, _ = common.timed(call, device, blocks,
                                 warmup_s=common.WARMUP_S if first else 0.0)
            first = False
            res[(kind, sb)] = ms
            split = sb > 1 and rows % sb == 0 and rows // sb >= 8
            print(f"  sb{sb:<3}-c5: {n / ms / 1e3:8.3f} Mrays/s ({ms:.2f} ms)"
                  + ("" if split else " (not split: chunks of fewer than 8 "
                     "rows or rows not divisible)"), flush=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_sb_depth")
    p.add_argument("--subs", default=",".join(map(str, SUBS)))
    p.add_argument("--dist", default="ao,bounces")
    p.add_argument("--tris", type=int, default=None,
                   help="hall's size (default 260,000)")
    p.add_argument("--side", type=int, default=1024)
    common.add_args(p)
    args = p.parse_args(argv)
    dists = args.dist.split(",")
    if any(d not in ("ao", "bounces") for d in dists):
        p.error(f"--dist {args.dist}: ao or bounces")
    device = common.device_of(args, "probe_sb_depth")
    print(f"card: {common.card(device)}", flush=True)
    run(device, [int(s) for s in args.subs.split(",")], dists, args.blocks,
        args.tris, args.side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
