"""Sort orders against crown's tile union on the card (port of
experiments/probe_crown_sort.py).

A tile of K5 pops the union of its rays' nodes, and crown's deep,
overlapping filigree makes that union large (attribute_crown). Two
mitigations: fewer rays per shared stack (smaller tile_rows), and a key
that orders rays by what they hit rather than by their origin cone, so
that a tile's rays walk one subtree. The key needs one exact trace first
(the prepass, K1 here), whose cost is left out, as in the JAX file: this
probes the ceiling.

Grid: the orders of sort_orders() {cone, hit-prim, hit-page, t-bucket} x
K5's tile_rows {32, 16, 8, 4} on crown's 1M primaries, each row K5's
Mrays/s and pops per tile, K1's beside it on the same order (timed in
turns, K1, K5, K5, K1).

The JAX file's configurations are tile rows x its kernel's interleave
("32x1ct", "16x2", "8x4", ...); here a configuration is tile_rows alone:
`multi` is a TPU knob with no counterpart (K5 interleaves nothing; the
card's warps hide each other's latency), and the carry-top body (ct) of a
shared tile stack has none either: the port's carry-top body, K7
(csrc/bvh_ct.cu), walks one ray per thread, K5 is the legacy body's tile
stack, and carry_top with tile_rows= is refused. So "16x2" is tile_rows
16 and "32x1ct" tile_rows 32. `--iters` becomes `--blocks`.

Usage: python -m rodent_tpu_torch.experiments.probe_crown_sort
    [--tris 800000] [--rows 32,16,8,4] [--orders cone,hit-prim,...]
    [--blocks 5] [--cpu --tris 20000 --side 64]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..accel import build_bvh
from ..core.math import FLT_MAX
from ..traversal import api, packet
from ..traversal.sorting import ray_sort_keys
from ..utils import testscenes
from . import common

ROWS = (32, 16, 8, 4)
ORDERS = ("cone", "hit-prim", "hit-page", "t-bucket")


def sort_orders(pid, t, cone):
    """{order: stable permutation} (experiments/probe_crown_sort.py:74-91,
    the same numpy arithmetic) from the prepass's prim ids and t and the
    cone key (traversal.sorting.ray_sort_keys), numpy arrays:
      cone      the production key;
      hit-prim  rays that hit one triangle adjacent (misses, -1, first),
                then by the cone key's top bits;
      hit-page  pages of 4,096 consecutive prim ids (the SBVH's order
                groups ids by subtree), ties by the cone key;
      t-bucket  32 buckets of hit distance (a depth layer), then the cone
                key."""
    cone = np.asarray(cone).astype(np.int64)
    pid = np.asarray(pid).astype(np.int64)
    t = np.asarray(t)
    tmax = max(float(t[pid >= 0].max()), 1e-6) if (pid >= 0).any() else 1.0
    return {
        "cone": np.argsort(cone, kind="stable"),
        "hit-prim": np.argsort(pid * (1 << 20) + (cone >> 12),
                               kind="stable"),
        "hit-page": np.argsort((pid // 4096) * (1 << 32) + cone,
                               kind="stable"),
        "t-bucket": np.argsort(
            (np.minimum(t / tmax, 1.0) * 31).astype(np.int64) * (1 << 32)
            + cone, kind="stable"),
    }


def run(device, rows=ROWS, orders=ORDERS, blocks=5, tris=None, side=1024):
    """{(order, tile_rows): {"k5_ms", "k1_ms", "k5_mrays", "k1_mrays",
    "k5" (common.tile_stats)}} on crown's primaries."""
    verts, idx = testscenes.make_crown(tris or common.SIZES["crown"])
    bvh = build_bvh(verts, idx, arity=8, **common.TRI8)
    dev = api.bvh_to_device(bvh, device)
    org, dirs = testscenes.crown_primary_rays(side, side)
    n = len(org)
    rays = api.make_rays(org, dirs, 0.0, FLT_MAX, device=device)
    print(f"crown: {len(idx) // 4} tris, {bvh.num_nodes} nodes, "
          f"{bvh.num_packets} packets; {n} primaries", flush=True)
    pre = packet.traverse_packet(dev, rays)
    cone = ray_sort_keys(rays["org"], rays["dir"], verts.min(0),
                         verts.max(0))
    perms = sort_orders(pre["prim_id"].cpu().numpy(), pre["t"].cpu().numpy(),
                        cone.cpu().numpy())
    res, first = {}, True
    for name in orders:
        perm = torch.from_numpy(perms[name]).to(device)
        comps = api.components({k: v[perm] for k, v in rays.items()})

        def k1(comps=comps):
            return packet.traverse_packet_components(dev, *comps)
        for r in rows:
            def k5(comps=comps, r=r):
                return packet.traverse_packet_components(dev, *comps,
                                                         tile_rows=r)
            k1_ms, k5_ms, _, _ = common.in_turns(
                k1, k5, device, blocks, common.WARMUP_S if first else 0.0)
            first = False
            st = common.tile_stats(common.counted_tile(dev, comps,
                                                       tile_rows=r),
                                   128 * r, n)
            res[(name, r)] = {"k5_ms": k5_ms, "k1_ms": k1_ms,
                              "k5_mrays": n / k5_ms / 1e3,
                              "k1_mrays": n / k1_ms / 1e3, "k5": st}
            print(f"{name:>9} rows {r:>2}: K5 {n / k5_ms / 1e3:9.2f} "
                  f"Mrays/s ({k5_ms:.4f} ms), {st['mean']:.1f} pops per tile "
                  f"(max {st['max']}); K1 {n / k1_ms / 1e3:9.2f} Mrays/s "
                  f"({k1_ms:.4f} ms)", flush=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_crown_sort")
    p.add_argument("--tris", type=int, default=None,
                   help="crown's size (default 800,000)")
    p.add_argument("--rows", default=",".join(map(str, ROWS)),
                   help="K5's tile_rows (the JAX file's --configs)")
    p.add_argument("--orders", default=",".join(ORDERS))
    p.add_argument("--side", type=int, default=1024)
    common.add_args(p)
    args = p.parse_args(argv)
    rows = [int(r) for r in args.rows.split(",")]
    orders = args.orders.split(",")
    if any(r not in api.TILE_ROWS for r in rows):
        p.error(f"--rows {args.rows}: each one of {api.TILE_ROWS}")
    if any(o not in ORDERS for o in orders):
        p.error(f"--orders {args.orders}: each one of {ORDERS}")
    device = common.device_of(args, "probe_crown_sort")
    print(f"card: {common.card(device)}", flush=True)
    run(device, rows, orders, args.blocks, args.tris, args.side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
