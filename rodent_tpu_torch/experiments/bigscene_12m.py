"""powerplant at the reference's scale through K1 and K2 (port of
experiments/bigscene_12m.py): make_powerplant(14,600,000) (the
reference's powerplant is 12.7M triangles) with the big-scene build
(BVH8, Tri --packet leaves, binned SAH, leaf_threshold 12, leaf_cost
--lc), its build seconds, its node and Tri tables against the card's L2
(compiler.fast_memory_bytes) and the tier compiler.packet_mode picks;
then for each distribution of --dists (1M rays: sorted primaries, and ao
and bounce rays from their hits) the pops per ray from K3 and the
engines of --modes in turns: "packet" is K1, "hbm" K2 (the JAX tool's
hbm; its giga, both tables outside VMEM, is K2 as well on the card).

Usage: python -m rodent_tpu_torch.experiments.bigscene_12m
    [--target 14600000] [--packet 24] [--lc 0.45] [--modes hbm,packet]
    [--dists primary,ao,bounces] [--rays 1048576] [--blocks 5] [--cpu]
"""
from __future__ import annotations

import argparse
import math
import sys
import time

from ..accel import build_bvh
from ..render import compiler
from ..traversal import api, packet
from ..utils import testscenes
from . import common

MODES = {"packet": False, "hbm": True}     # the mode -> prefetch (K2)


def main(argv=None):
    p = argparse.ArgumentParser(prog="bigscene_12m")
    p.add_argument("--target", type=int, default=14_600_000)
    p.add_argument("--packet", type=int, default=24)
    p.add_argument("--lc", type=float, default=0.45)
    p.add_argument("--modes", default="hbm,packet")
    p.add_argument("--dists", default="primary,ao,bounces")
    p.add_argument("--rays", type=int, default=1024 * 1024)
    common.add_args(p)
    args = p.parse_args(argv)
    modes = args.modes.split(",")
    for m in modes:
        if m not in MODES:
            p.error(f"--modes {m}: choose from {', '.join(MODES)}")
    device = common.device_of(args, "bigscene_12m")
    print(f"card: {common.card(device)}", flush=True)
    t0 = time.perf_counter()
    verts, idx = testscenes.make_powerplant(args.target)
    t1 = time.perf_counter()
    dev = api.bvh_to_device(build_bvh(
        verts, idx, arity=8, packet=args.packet, quality=0,
        leaf_threshold=12, leaf_cost=args.lc), device)
    t2 = time.perf_counter()
    scene = {"bvh": dev}
    l2 = compiler.fast_memory_bytes(scene)
    a = dev["nodes"].shape[1] // 7
    m = dev["tris"].shape[1] // 14
    print(f"powerplant: {len(idx) // 4} tris (made in {t1 - t0:.1f} s, "
          f"built in {t2 - t1:.1f} s); {dev['nodes'].shape[0]} BVH{a} nodes "
          f"= {dev['nodes'].numel() * 4 / 1e6:.1f} MB, {dev['tris'].shape[0]}"
          f" Tri{m} rows = {dev['tris'].numel() * 4 / 1e6:.1f} MB; fast "
          f"memory {l2 / 1e6:.1f} MB; tier {compiler.packet_mode(scene)}",
          flush=True)
    side = math.isqrt(args.rays)
    n = side * side
    dists = common.distributions("powerplant", verts, idx, dev, side, device,
                                 tuple(args.dists.split(",")))
    del verts, idx
    for dist, (comps, any_hit) in dists.items():
        s = common.pop_stats(common.counted(dev, comps, any_hit))
        print(f"{dist}: pops/ray {s['pops_ray']:.6f} (node "
              f"{s['node'] / n:.6f}, leaf {s['leaf_ray']:.6f})", flush=True)

        def run(mode, comps=comps, any_hit=any_hit):
            return lambda: packet.traverse_packet_components(
                dev, *comps, any_hit=any_hit, prefetch=MODES[mode])
        if len(modes) == 2:
            a_ms, b_ms, ra, rb = common.in_turns(
                run(modes[0]), run(modes[1]), device, args.blocks,
                warmup_s=common.WARMUP_S)
            res = {modes[0]: (a_ms, ra), modes[1]: (b_ms, rb)}
        else:
            res = {mode: common.timed(run(mode), device, args.blocks,
                                      warmup_s=common.WARMUP_S)
                   for mode in modes}
        for mode, (ms, out) in res.items():
            hits = int((out["prim_id"] >= 0).sum())
            print(f"{dist} : {mode} : {n / ms / 1e3:.2f} Mrays "
                  f"({ms:.4f} ms; {hits} intersections)", flush=True)
        if len(modes) == 2:
            print(f"{dist} : {modes[1]}/{modes[0]} time "
                  f"{res[modes[1]][0] / res[modes[0]][0]:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
