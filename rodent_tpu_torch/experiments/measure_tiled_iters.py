"""What a trip of the dual-queue engine costs (port of
experiments/measure_tiled_iters.py): on hall-260K's 1M sorted primaries,
ao and bounce rays, one counted single-stage run of traversal/tiled.py
each (debug_counters), timed: ms and Mrays/s, trips, the trips whose leaf
unit ran, the mean share of live rays per trip (utilisation), and ms and
ns per ray per trip; with the device's idle share over one call
(torch.profiler, common.device_idle). The JAX file's rjit and compile
cache have no counterpart: the engine is torch ops.

Usage: python -m rodent_tpu_torch.experiments.measure_tiled_iters
    [--dist primary,ao,bounces] [--blocks 3] [--cpu --tris 20000
    --side 64]
"""
from __future__ import annotations

import argparse
import sys

from ..traversal import tiled
from . import common

DISTS = ("primary", "ao", "bounces")


def run(device, dists=DISTS, blocks=3, tris=None, side=1024):
    """{dist: {"ms", "trips", "leaf_trips", "util", "idle"}} (idle None on
    the CPU)."""
    verts, idx, dev, _ = common.load("hall", common.TRI8, device, tris)
    print(f"hall: stack entries shared {dev['meta'].shared_stack}, node "
          f"{dev['meta'].node_stack}", flush=True)
    data = common.distributions("hall", verts, idx, dev, side, device, dists)
    res, first = {}, True
    for kind, (comps, any_hit) in data.items():
        n = comps[4].shape[0]

        def run_once(comps=comps, any_hit=any_hit):
            return tiled.traverse_components(dev, *comps, any_hit=any_hit,
                                             debug_counters=True)
        ms, out = common.timed(run_once, device, blocks,
                               warmup_s=common.WARMUP_S if first else 0.0)
        first = False
        c = out["counters"]
        trips = c["iters"]
        util = float(c["live_sum"]) / (trips * n)
        idle = (common.device_idle(run_once) if device.type == "cuda"
                else None)
        res[kind] = {"ms": ms, "trips": trips, "leaf_trips": c["leaf_iters"],
                     "util": util, "idle": idle}
        print(f"{kind:>8}: {ms:9.2f} ms ({n / ms / 1e3:7.3f} Mrays/s)  trips "
              f"{trips:5d}  leaf unit {c['leaf_iters']:5d}  utilisation "
              f"{util:.3f}  per trip {ms / trips:7.3f} ms "
              f"({ms / trips / n * 1e6:6.3f} ns per ray)"
              + ("" if idle is None else
                 f"  device idle {idle['idle']:.3f}"), flush=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="measure_tiled_iters")
    p.add_argument("--tris", type=int, default=None,
                   help="hall's size (default 260,000)")
    p.add_argument("--dist", default=",".join(DISTS))
    p.add_argument("--side", type=int, default=1024)
    common.add_args(p)
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    dists = args.dist.split(",")
    if any(d not in DISTS for d in dists):
        p.error(f"--dist {args.dist}: each one of {DISTS}")
    device = common.device_of(args, "measure_tiled_iters")
    print(f"card: {common.card(device)}", flush=True)
    run(device, dists, args.blocks, args.tris, args.side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
