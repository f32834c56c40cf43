"""ns per ray waterfall of the dual-queue engine (port of
experiments/waterfall_tiled.py): where a trip of traversal/tiled.py goes
on hall-260K's ao and bounce rays (1M, sorted).

For each distribution:

- the production form (staged compaction, compact_stages=5) timed, with
  the counted run's trips, leaf-unit trips and utilisation (the mean
  share of live rays per trip), and the device's idle share over one
  call (torch.profiler, common.device_idle: the engine is torch ops
  driven by one host read per trip);
- the waterfall: the single-stage loop pinned at the counted trips
  (fixed_iters) under each ablation of ROWS, so that every row runs the
  same pop schedule and a row's time against "full" is what that part of
  a trip costs: noleaf (the whole leaf unit), leafalways (what the gate
  saves), trigatherfix and nodegatherfix (the row gathers), nosort (the
  Batcher network), nopush and nopop (the stack writes and reads), and
  barebones (all of them but the gate's). Ablated runs return wrong hits;
  only their times are read;
- the production candidates CANDIDATES, sub-batches x compaction stages,
  in Mrays/s.

Each row: ms per call and ns per ray. `--iters` of the JAX file becomes
`--blocks`.

Usage: python -m rodent_tpu_torch.experiments.waterfall_tiled
    [--dist ao,bounces] [--rows full,noleaf,...] [--blocks 3]
    [--cpu --tris 20000 --side 64]
"""
from __future__ import annotations

import argparse
import sys

from ..traversal import tiled
from . import common

ROWS = {"full": (), "noleaf": ("noleaf",), "leafalways": ("leafalways",),
        "trigatherfix": ("trigatherfix",),
        "nodegatherfix": ("nodegatherfix",), "nosort": ("nosort",),
        "nopush": ("nopush",), "nopop": ("nopop",),
        "barebones": ("noleaf", "nodegatherfix", "nosort", "nopush",
                      "nopop")}
# (sub_batches, compact_stages) of the JAX file's candidates
CANDIDATES = ((0, 5), (4, 5), (8, 5), (16, 5), (8, 3), (16, 0))


def counters(dev, comps, any_hit):
    """The single-stage loop's counters: (trips, leaf trips, utilisation)."""
    c = tiled.traverse_components(dev, *comps, any_hit=any_hit,
                                  debug_counters=True)["counters"]
    n = comps[4].shape[0]
    return c["iters"], c["leaf_iters"], float(c["live_sum"]) / c["iters"] / n


def run(device, dists=("ao", "bounces"), rows=tuple(ROWS),
        candidates=CANDIDATES, blocks=3, tris=None, side=1024):
    """{dist: {"prod_ms", "trips", "leaf_trips", "util", "idle" (None on
    the CPU), "rows": {row: ms}, "candidates": {(sb, cs): ms}}}."""
    verts, idx, dev, _ = common.load("hall", common.TRI8, device, tris)
    data = common.distributions("hall", verts, idx, dev, side, device, dists)
    res = {}
    for kind, (comps, any_hit) in data.items():
        n = comps[4].shape[0]

        def prod(comps=comps, any_hit=any_hit):
            return tiled.traverse_components(dev, *comps, any_hit=any_hit,
                                             compact_stages=5)
        prod_ms, _ = common.timed(prod, device, blocks,
                                  warmup_s=common.WARMUP_S)
        trips, leaf_trips, util = counters(dev, comps, any_hit)
        idle = common.device_idle(prod) if device.type == "cuda" else None
        r = {"prod_ms": prod_ms, "trips": trips, "leaf_trips": leaf_trips,
             "util": util, "idle": idle, "rows": {}, "candidates": {}}
        print(f"== {kind} ({n} rays): production (compact 5) "
              f"{n / prod_ms / 1e3:.3f} Mrays/s ({prod_ms:.2f} ms, "
              f"{prod_ms * 1e6 / n:.2f} ns per ray) | trips {trips}, leaf "
              f"unit {leaf_trips}, utilisation {util:.3f}"
              + ("" if idle is None else
                 f"; device idle {idle['idle']:.3f} of {idle['wall_ms']:.1f}"
                 f" ms, {idle['kernels']} kernels"), flush=True)
        for name in rows:
            def fixed(comps=comps, any_hit=any_hit, ab=ROWS[name]):
                return tiled.traverse_components(
                    dev, *comps, any_hit=any_hit, debug_counters=True,
                    ablate=ab, fixed_iters=trips)
            ms, _ = common.timed(fixed, device, blocks)
            r["rows"][name] = ms
            base = r["rows"].get("full", ms)
            print(f"  {name:>14}: {ms:9.2f} ms ({ms * 1e6 / n:8.2f} ns per "
                  f"ray, {ms * 1e3 / trips:8.2f} us per trip); against full "
                  f"{ms - base:+9.2f} ms ({(ms - base) / base:+.0%})",
                  flush=True)
        for sb, cs in candidates:
            def cand(comps=comps, any_hit=any_hit, sb=sb, cs=cs):
                return tiled.traverse_components(
                    dev, *comps, any_hit=any_hit, sub_batches=sb,
                    compact_stages=cs)
            ms, _ = common.timed(cand, device, blocks)
            r["candidates"][(sb, cs)] = ms
            print(f"  sb{sb}-c{cs}: {n / ms / 1e3:.3f} Mrays/s ({ms:.2f} "
                  "ms)", flush=True)
        res[kind] = r
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="waterfall_tiled")
    p.add_argument("--tris", type=int, default=None,
                   help="hall's size (default 260,000)")
    p.add_argument("--dist", default="ao,bounces")
    p.add_argument("--rows", default=",".join(ROWS))
    p.add_argument("--side", type=int, default=1024)
    common.add_args(p)
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    rows = args.rows.split(",")
    if any(r not in ROWS for r in rows):
        p.error(f"--rows {args.rows}: each one of {tuple(ROWS)}")
    dists = args.dist.split(",")
    if any(d not in ("ao", "bounces", "primary") for d in dists):
        p.error(f"--dist {args.dist}: ao, bounces or primary")
    device = common.device_of(args, "waterfall_tiled")
    print(f"card: {common.card(device)}", flush=True)
    run(device, dists, rows, CANDIDATES, args.blocks, args.tris, args.side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
