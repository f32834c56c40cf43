"""Tree arity x Tri width for the dual-queue engine (port of
experiments/sweep_arity_tiled.py).

Every part of a trip of traversal/tiled.py scales with the node arity A
or the Tri width M: the node unit's A slab tests and its Batcher network
(19 exchanges at 8, 5 at 4, 1 at 2), the pushes onto both stacks, the
leaf unit's M lanes, and the node stack's size (compute_stack_needs
shrinks with fewer pushes a node). The price of a narrower tree is more
trips. Grid: A x M of `--grid` on hall-260K's 1M ao and bounce rays, the
same rays for every cell (traced from the primaries' hits on the Tri8
BVH8 build, as bench.py does; sorted), each cell's build through the
engine with staged compaction (`--compact`): Mrays/s (median of the
blocks), its stack sizes and its hit fraction against the first cell's
(other trees may keep another of two exactly equal hits, so ids are
compared as a fraction).

Usage: python -m rodent_tpu_torch.experiments.sweep_arity_tiled
    [--grid 8x8,8x4,4x8,4x4,2x8,2x4] [--compact 5] [--blocks 5]
    [--cpu --tris 20000 --side 64]
"""
from __future__ import annotations

import argparse
import sys

from ..accel import build_bvh
from ..traversal import api, tiled
from . import common

GRID = ((8, 8), (8, 4), (4, 8), (4, 4), (2, 8), (2, 4))


def run(device, grid=GRID, compact=5, blocks=5, tris=None, side=1024,
        kinds=("ao", "bounces")):
    """{(arity, m): {"nodes", "packets", "s_n", "s_sh", kind: {"ms",
    "mrays", "hit", "dhit"}}} for each kind of rays."""
    verts, idx, dev0, _ = common.load("hall", common.TRI8, device, tris)
    dists = common.distributions("hall", verts, idx, dev0, side, device,
                                 kinds)
    print(f"hall: {len(idx) // 4} tris; {side * side} rays", flush=True)
    res, ref, first = {}, {}, True
    for a, m in grid:
        bvh = build_bvh(verts, idx, arity=a, packet=m,
                        leaf_threshold=common.TRI8["leaf_threshold"])
        dev = api.bvh_to_device(bvh, device)
        meta = dev["meta"]
        r = {"nodes": bvh.num_nodes, "packets": bvh.num_packets,
             "s_n": meta.node_stack, "s_sh": meta.shared_stack}
        print(f"[a{a} pk{m}] nodes {bvh.num_nodes} packets "
              f"{bvh.num_packets} S_N {meta.node_stack} S_sh "
              f"{meta.shared_stack}", flush=True)
        for kind, (comps, any_hit) in dists.items():
            n = comps[4].shape[0]

            def call(dev=dev, comps=comps, any_hit=any_hit):
                return tiled.traverse_components(
                    dev, *comps, any_hit=any_hit, compact_stages=compact)
            ms, out = common.timed(call, device, blocks,
                                   warmup_s=common.WARMUP_S if first else 0.0)
            first = False
            hit = float((out["prim_id"] >= 0).float().mean())
            ref.setdefault(kind, hit)
            r[kind] = {"ms": ms, "mrays": n / ms / 1e3, "hit": hit,
                       "dhit": abs(hit - ref[kind])}
            print(f"  {kind} a{a}pk{m}: {n / ms / 1e3:8.3f} Mrays/s ({ms:.2f}"
                  f" ms) hit fraction {hit:.4f} (against the first cell "
                  f"{abs(hit - ref[kind]):.4f})", flush=True)
        res[(a, m)] = r
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="sweep_arity_tiled")
    p.add_argument("--grid", default=",".join(f"{a}x{m}" for a, m in GRID),
                   help="arity x Tri width pairs")
    p.add_argument("--compact", type=int, default=5)
    p.add_argument("--tris", type=int, default=None,
                   help="hall's size (default 260,000)")
    p.add_argument("--side", type=int, default=1024)
    common.add_args(p)
    args = p.parse_args(argv)
    grid = [tuple(int(x) for x in tok.split("x"))
            for tok in args.grid.split(",")]
    for a, m in grid:
        if a not in (2, 4, 8) or m < 1:
            p.error(f"--grid {a}x{m}: arity 2, 4 or 8")
    device = common.device_of(args, "sweep_arity_tiled")
    print(f"card: {common.card(device)}", flush=True)
    run(device, grid, args.compact, args.blocks, args.tris, args.side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
