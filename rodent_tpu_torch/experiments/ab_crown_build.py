"""Crown's builder variants on the card (port of
experiments/ab_crown_build.py).

attribute_crown pins crown's deficit on the tile union of a shared stack:
a deep, lopsided tree of overlapping filigree makes a tile's rays walk
far more nodes than any one of them. This sweep asks whether the build's
shape moves it: SBVH spatial splits or binned SAH (`quality`), the DP
collapse's leaf cost (`leaf_cost`: lower makes fatter leaves and a
shallower tree, hence a smaller union per level) and the binary leaf
threshold (`leaf_threshold`) of accel.build_bvh. For each variant
(VARIANTS, the JAX file's six): the build's time, tree_stats, K5's pops
per tile at `--rows` and the hit fraction, then K1 and K5 timed in turns
(K1, K5, K5, K1) in Mrays/s. The same sweep runs on hall with --scene
hall.

The JAX file's `--multi` has no meaning here (K5 takes `--rows` alone)
and its `--iters` becomes `--blocks`; `--variants` picks some of the six
by label.

Usage: python -m rodent_tpu_torch.experiments.ab_crown_build
    [--scene crown|hall|powerplant] [--variants q1-lt12-lc1.2,...]
    [--rows 16] [--blocks 5] [--cpu --tris 20000 --side 64]
"""
from __future__ import annotations

import argparse
import sys
import time

from ..accel import build_bvh
from ..traversal import api, packet
from ..utils import testscenes
from . import common
from .attribute_crown import stats_line, tree_stats

# (label, build keywords) of experiments/ab_crown_build.py:37-45; Tri8
# leaves at arity 8 throughout, the first one crown's base build
VARIANTS = [
    ("q1-lt12-lc1.2", dict(quality=1, leaf_threshold=12)),
    ("q1-lt12-lc0.6", dict(quality=1, leaf_threshold=12, leaf_cost=0.6)),
    ("q1-lt12-lc0.3", dict(quality=1, leaf_threshold=12, leaf_cost=0.3)),
    ("q0-lt12-lc1.2", dict(quality=0, leaf_threshold=12)),
    ("q0-lt12-lc0.6", dict(quality=0, leaf_threshold=12, leaf_cost=0.6)),
    ("q1-lt24-lc0.6", dict(quality=1, leaf_threshold=24, leaf_cost=0.6)),
]


def run(device, scene="crown", labels=None, rows=16, blocks=5, tris=None,
        side=1024):
    """Each variant's {"build_s", "nodes", "packets", "stats", "k5"
    (common.tile_stats), "hit", "k1_ms", "k5_ms", "k1_mrays",
    "k5_mrays"}, by label, on the scene's sorted primaries (the rays sorted
    once, over the scene's box)."""
    picked = [(l, kw) for l, kw in VARIANTS if labels is None or l in labels]
    if labels is not None and len(picked) != len(labels):
        raise ValueError(f"unknown variants in {labels}; choose from "
                         f"{[l for l, _ in VARIANTS]}")
    make, rays_of = testscenes.SCENES[scene]
    verts, idx = make(tris or common.SIZES[scene])
    print(f"{scene}: {len(idx) // 4} tris, rows {rows}, blocks {blocks}",
          flush=True)
    res, comps = {}, None
    for label, kw in picked:
        t0 = time.perf_counter()
        bvh = build_bvh(verts, idx, arity=8, packet=8, **kw)
        build_s = time.perf_counter() - t0
        st = tree_stats(bvh, verts)
        dev = api.bvh_to_device(bvh, device)
        if comps is None:
            comps, _ = common.distributions(scene, verts, idx, dev, side,
                                            device, ("primary",))["primary"]
        n = comps[4].shape[0]
        k5 = common.tile_stats(common.counted_tile(dev, comps,
                                                   tile_rows=rows),
                               128 * rows, n)

        def k1(dev=dev):
            return packet.traverse_packet_components(dev, *comps)

        def k5_run(dev=dev):
            return packet.traverse_packet_components(dev, *comps,
                                                     tile_rows=rows)
        k1_ms, k5_ms, hit, _ = common.in_turns(
            k1, k5_run, device, blocks, common.WARMUP_S if not res else 0.0)
        r = {"build_s": build_s, "nodes": bvh.num_nodes,
             "packets": bvh.num_packets, "stats": st, "k5": k5,
             "hit": float((hit["prim_id"] >= 0).float().mean()),
             "k1_ms": k1_ms, "k5_ms": k5_ms, "k1_mrays": n / k1_ms / 1e3,
             "k5_mrays": n / k5_ms / 1e3}
        print(f"{label}: {r['nodes']} nodes, {r['packets']} packets, built "
              f"in {build_s:.1f} s; {stats_line(st)}", flush=True)
        print(f"  K5 rows {rows}: {k5['mean']:.1f} pops per tile (max "
              f"{k5['max']}), hit {r['hit']:.3f}; in turns K1 "
              f"{r['k1_mrays']:.2f} Mrays/s ({k1_ms:.4f} ms), K5 "
              f"{r['k5_mrays']:.2f} Mrays/s ({k5_ms:.4f} ms)", flush=True)
        res[label] = r
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="ab_crown_build")
    p.add_argument("--scene", default="crown",
                   choices=("crown", "hall", "powerplant"))
    p.add_argument("--variants", default=None,
                   help="labels of VARIANTS, comma-separated (default all)")
    p.add_argument("--rows", type=int, default=16,
                   help="K5's tile_rows (the JAX file's rows x multi)")
    p.add_argument("--tris", type=int, default=None)
    p.add_argument("--side", type=int, default=1024)
    common.add_args(p)
    args = p.parse_args(argv)
    if args.rows not in api.TILE_ROWS:
        p.error(f"--rows {args.rows}: one of {api.TILE_ROWS}")
    device = common.device_of(args, "ab_crown_build")
    print(f"card: {common.card(device)}", flush=True)
    run(device, args.scene,
        args.variants.split(",") if args.variants else None, args.rows,
        args.blocks, args.tris, args.side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
