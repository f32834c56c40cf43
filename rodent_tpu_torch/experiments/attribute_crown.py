"""Where crown's primary rays lose against hall's (port of
experiments/attribute_crown.py): host-side tree statistics of the port's
native build, then counted and timed passes on the card.

crown-800K has three times hall-260K's triangles and a much deeper tree
of spiky, overlapping filigree. On the TPU the shared-stack packet kernel
popped 3.3x hall's nodes per tile there. This tool separates the
suspects on the card, for each scene's BVH8/Tri8 build (the JAX file's
build) and its 1M sorted primaries:

  1. the tree: child occupancy, lane fill, packets per triangle, the SAH
     surface-area sums of inner nodes and leaves over the root's, leaf
     chain lengths and depth (tree_stats; the reference prints the same
     behind #ifdef STATISTICS, src/driver/bvh.h:109-111), and its table
     sizes;
  2. the work: K3's pops per ray (node and leaf, and the mean over warps
     of each warp's largest count) and K5's pops per tile at `--rows`
     (the tile union of a shared stack, the JAX file's pops/tile);
  3. the cost of a pop: K1 and K5 timed in turns (K1, K5, K5, K1), each
     one's ns per pop (ray pops for K1, tile pops for K5) and Mrays/s.

The JAX file's `--multi` and its TPU configuration (tile rows x the
kernel's interleave) have no meaning here: K5 takes `--rows` alone (the
JAX "16x2" is tile_rows 16 here), and K1 one ray a thread. `--iters`
becomes `--blocks`, the timed blocks of experiments.common.

Usage: python -m rodent_tpu_torch.experiments.attribute_crown
    [--scenes hall,crown] [--rows 16] [--blocks 5]
    [--cpu --tris 20000 --side 64]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..accel import build_bvh
from ..traversal import api, packet
from ..utils import testscenes
from . import common


def tree_stats(bvh, verts):
    """The build's shape (experiments/attribute_crown.py:28-81, the same
    numpy arithmetic): child occupancy, lane fill, packets per triangle,
    SAH sums of inner and leaf slots over the root's half area (leaves
    weighted by their chain of packets), the mean and largest leaf chain,
    and the tree's depth."""
    child = bvh.child
    bounds = bvh.bounds
    stats = {}
    occ = (child != 0).sum(1)
    stats["child_occupancy"] = float(occ.mean())
    # a sign-flagged (last-packet) lane counts as valid; only -1 is empty
    valid = bvh.prim_id != -1
    stats["lane_fill"] = float(valid.mean())
    stats["packets_per_tri"] = bvh.num_packets * bvh.packet / max(
        1, int(valid.sum()))
    w = np.maximum(bounds[:, 1::2, :] - bounds[:, 0::2, :], 0.0)
    ha = w[:, 0] * w[:, 1] + w[:, 1] * w[:, 2] + w[:, 2] * w[:, 0]
    ext = verts.max(0) - verts.min(0)
    root_ha = ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0]
    inner = child > 0
    leaf = child < 0
    stats["sah_inner"] = float(ha[inner].sum() / root_ha)
    pid_last = bvh.prim_id[:, -1] < 0
    first = child[leaf]
    chain = np.zeros(len(first), np.int64)
    code = (~first).astype(np.int64)
    done = np.zeros(len(first), bool)
    for _ in range(64):
        if done.all():
            break
        chain = np.where(done, chain, chain + 1)
        done |= pid_last[np.clip(code, 0, bvh.num_packets - 1)]
        code += 1
    stats["leaf_chain_mean"] = float(chain.mean())
    stats["leaf_chain_max"] = int(chain.max())
    stats["sah_leaf"] = float((ha[leaf] * chain).sum() / root_ha)
    depth = np.zeros(bvh.num_nodes, np.int32)
    order = [0]
    for n in order:
        for c in child[n]:
            if c > 0:
                depth[c - 1] = depth[n] + 1
                order.append(c - 1)
    stats["max_depth"] = int(depth.max())
    return stats


def stats_line(st):
    return (f"occupancy {st['child_occupancy']:.2f}/8, lane fill "
            f"{st['lane_fill']:.2f}, packets/tri {st['packets_per_tri']:.2f}, "
            f"leaf chain mean {st['leaf_chain_mean']:.2f} max "
            f"{st['leaf_chain_max']}, depth {st['max_depth']}; SAH/root area "
            f"inner {st['sah_inner']:.1f}, leaf {st['sah_leaf']:.1f}")


def passes(dev, comps, device, rows, blocks):
    """K3's pop statistics, K5's per-tile pops at `rows`, and K1 and K5 in
    turns: {"k3": common.pop_stats, "k5": common.tile_stats, "k1_ms",
    "k5_ms", "k1_ns_pop", "k5_ns_pop", "hit"}."""
    n = comps[4].shape[0]
    k3 = common.pop_stats(common.counted(dev, comps))
    k5 = common.tile_stats(common.counted_tile(dev, comps, tile_rows=rows),
                           128 * rows, n)

    def k1():
        return packet.traverse_packet_components(dev, *comps)

    def k5_run():
        return packet.traverse_packet_components(dev, *comps, tile_rows=rows)
    k1_ms, k5_ms, hit, _ = common.in_turns(k1, k5_run, device, blocks,
                                           common.WARMUP_S)
    return {"k3": k3, "k5": k5, "k1_ms": k1_ms, "k5_ms": k5_ms,
            "k1_ns_pop": k1_ms * 1e6 / k3["pops"],
            "k5_ns_pop": k5_ms * 1e6 / k5["pops"],
            "hit": float((hit["prim_id"] >= 0).float().mean())}


def run(device, scenes=("hall", "crown"), rows=16, blocks=5, tris=None,
        side=1024):
    """tree_stats and passes() per scene: {scene: {"stats", "tris",
    "nodes", "packets", "node_mb", "tri_mb", **passes()}}."""
    res = {}
    for scene in scenes:
        verts, idx = testscenes.SCENES[scene][0](tris
                                                 or common.SIZES[scene])
        bvh = build_bvh(verts, idx, arity=8, **common.TRI8)
        st = tree_stats(bvh, verts)
        dev = api.bvh_to_device(bvh, device)
        r = {"stats": st, "tris": len(idx) // 4, "nodes": bvh.num_nodes,
             "packets": bvh.num_packets,
             "node_mb": bvh.num_nodes * 7 * bvh.arity * 4 / 1e6,
             "tri_mb": bvh.num_packets * 14 * bvh.packet * 4 / 1e6}
        print(f"{scene}: {r['tris']} tris, {r['nodes']} nodes, "
              f"{r['packets']} packets, node table {r['node_mb']:.1f} MB, "
              f"Tri table {r['tri_mb']:.1f} MB", flush=True)
        print(f"  {stats_line(st)}", flush=True)
        comps, _ = common.distributions(scene, verts, idx, dev, side, device,
                                        ("primary",))["primary"]
        r.update(passes(dev, comps, device, rows, blocks))
        n = comps[4].shape[0]
        k3, k5 = r["k3"], r["k5"]
        print(f"  primary ({n} sorted rays, hit {r['hit']:.3f}): K3 "
              f"{k3['pops_ray']:.2f} pops per ray ({k3['node'] / n:.2f} "
              f"node, {k3['leaf_ray']:.2f} leaf; warp-max {k3['warp_pops']:.2f})"
              f"; K5 rows {rows}: {k5['mean']:.1f} pops per tile (max "
              f"{k5['max']}), {k5['ray_equiv']:.2f} per ray-equivalent",
              flush=True)
        print(f"  in turns: K1 {r['k1_ms']:.4f} ms ({n / r['k1_ms'] / 1e3:.1f}"
              f" Mrays/s, {r['k1_ns_pop']:.4f} ns per ray pop); K5 "
              f"{r['k5_ms']:.4f} ms ({n / r['k5_ms'] / 1e3:.1f} Mrays/s, "
              f"{r['k5_ns_pop']:.2f} ns per tile pop)", flush=True)
        res[scene] = r
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="attribute_crown")
    p.add_argument("--scenes", default="hall,crown")
    p.add_argument("--rows", type=int, default=16,
                   help="K5's tile_rows (the JAX file's rows x multi)")
    p.add_argument("--tris", type=int, default=None,
                   help="every scene at this size (default: their own)")
    p.add_argument("--side", type=int, default=1024)
    common.add_args(p)
    args = p.parse_args(argv)
    if args.rows not in api.TILE_ROWS:
        p.error(f"--rows {args.rows}: one of {api.TILE_ROWS}")
    device = common.device_of(args, "attribute_crown")
    print(f"card: {common.card(device)}", flush=True)
    run(device, args.scenes.split(","), args.rows, args.blocks, args.tris,
        args.side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
