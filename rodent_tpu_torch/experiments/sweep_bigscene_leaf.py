"""Big-scene leaf builds through K1 and K2 (port of
experiments/sweep_bigscene_leaf.py): on powerplant, every BVH8 build of
--packets Tri width x --lts leaf_threshold x --lcs leaf_cost (0:
build_bvh's default; binned SAH, quality 0), and for each its build seconds,
node and Tri rows, the node and leaf pops per ray of 1M sorted primaries
from K3, and K1 and K2 (the next-pop L2 prefetch) timed in turns (K1, K2,
K2, K1). Fewer, wider leaves cut the Tri-row fetches that miss the L2 on
this scene. The JAX tool's --configs (the TPU kernel's tile rows x multi)
have no meaning for K1 and K2.

Usage: python -m rodent_tpu_torch.experiments.sweep_bigscene_leaf
    [--tris 5000000] [--rays 1048576] [--lts 12,24,32] [--lcs 0,4,8]
    [--packets 8] [--blocks 5] [--cpu]
"""
from __future__ import annotations

import argparse
import math
import sys
import time

from ..accel import build_bvh
from ..traversal import api, packet
from ..utils import testscenes
from . import common
from .race_hall_packet import build_line, packets_arg


def main(argv=None):
    p = argparse.ArgumentParser(prog="sweep_bigscene_leaf")
    p.add_argument("--tris", type=int, default=common.SIZES["powerplant"])
    p.add_argument("--rays", type=int, default=1024 * 1024)
    p.add_argument("--lts", default="12,24,32")
    p.add_argument("--lcs", default="0,4,8")
    p.add_argument("--packets", default="8")
    common.add_args(p)
    args = p.parse_args(argv)
    packets = packets_arg(p, args.packets)
    device = common.device_of(args, "sweep_bigscene_leaf")
    print(f"card: {common.card(device)}", flush=True)
    verts, idx = testscenes.make_powerplant(args.tris)
    side = math.isqrt(args.rays)
    n = side * side
    comps, _ = common.distributions("powerplant", verts, idx, None, side,
                                    device, ("primary",))["primary"]
    print(f"powerplant: {len(idx) // 4} tris, {n} sorted primaries",
          flush=True)
    for pk in packets:
        for lt in (int(x) for x in args.lts.split(",")):
            for lc in (float(x) for x in args.lcs.split(",")):
                t0 = time.perf_counter()
                dev = api.bvh_to_device(build_bvh(
                    verts, idx, arity=8, packet=pk, quality=0,
                    leaf_threshold=lt, leaf_cost=lc), device)
                secs = time.perf_counter() - t0
                out = common.counted(dev, comps)
                s = common.pop_stats(out)
                hits = float((out["prim_id"] >= 0).double().mean())
                name = f"pk={pk} lt={lt} lc={lc:g}" if lc \
                    else f"pk={pk} lt={lt} lc=def"
                print(f"{build_line(name, dev, s, hits)}; node pops/ray "
                      f"{s['node'] / n:.6f}; built in {secs:.1f} s",
                      flush=True)

                def k(prefetch, dev=dev):
                    return lambda: packet.traverse_packet_components(
                        dev, *comps, prefetch=prefetch)
                k1_ms, k2_ms, _, _ = common.in_turns(
                    k(False), k(True), device, args.blocks,
                    warmup_s=common.WARMUP_S)
                print(f"  K1: {k1_ms:.4f} ms = {n / k1_ms / 1e3:.2f} Mrays/s;"
                      f" K2: {k2_ms:.4f} ms = {n / k2_ms / 1e3:.2f} Mrays/s;"
                      f" K2/K1 {k2_ms / k1_ms:.3f}", flush=True)
                del dev
    return 0


if __name__ == "__main__":
    sys.exit(main())
