"""Leaf width on hall's primaries (port of experiments/race_hall_packet.py):
does a wider leaf packet, fewer leaf pops for more triangle lanes per pop,
pay where the tables fit the L2?

Builds hall-260K at BVH8 with Tri --packets leaves and each --lcs leaf
cost (0: build_bvh's default; leaf_threshold 12), and for each build
prints its node and Tri rows, the pops and leaf pops per ray of 1M sorted
primaries from K3, and K1's time, timed in turns (common.in_turns)
against the first build. The JAX tool races the builds through the
carry-top body (traverse_packet(carry_top=True), :66), so each build's
K7 (csrc/bvh_ct.cu, select "fold", the fused slab) is timed too, in turns
with that build's K1, with its own pops per ray from its counters. --packets takes the JAX
tool's default, 8,12,16,24: K1 is built for Tri 1/4/8/12/16/24 leaves and
K3, which counts the pops, and K7 for Tri 8/12/16/24 at arity 8
(packet.WIDE_PACKETS, packet.CT_PACKETS), so a width that one of them
lacks is refused. The JAX tool's --rows (the TPU kernel's tile rows) has
no meaning here.

Usage: python -m rodent_tpu_torch.experiments.race_hall_packet
    [--tris 260000] [--rays 1048576] [--packets 8,12,16,24] [--lcs 0,0.6]
    [--blocks 5] [--cpu]
"""
from __future__ import annotations

import argparse
import math
import sys

from ..accel import build_bvh
from ..traversal import api, packet
from ..utils import testscenes
from . import common

# the JAX tool's body (race_hall_packet.py:66): carry_top with its defaults
CT_BODY = {"carry_top": True, "select": "fold", "fma_slab": True}


def packets_arg(p, text):
    """The Tri widths of --packets; refuses one that K3 (which counts the
    pops) or K7 was not built for."""
    out = [int(x) for x in text.split(",")]
    for pk in out:
        if pk not in packet.WIDE_PACKETS:
            p.error(f"--packets {pk}: K1 and K3 are built for Tri "
                    f"{'/'.join(map(str, packet.WIDE_PACKETS))} leaves at "
                    "arity 8 (csrc/bvh_traverse.cu)")
        if pk not in packet.CT_PACKETS:
            p.error(f"--packets {pk}: K7 is built for Tri "
                    f"{'/'.join(map(str, packet.CT_PACKETS))} leaves at "
                    "arity 8 (csrc/bvh_ct.cu)")
    return out


def build_line(name, dev, s, hits):
    """A build's tables and its counted pops per ray."""
    a = dev["nodes"].shape[1] // 7
    m = dev["tris"].shape[1] // 14
    return (f"{name}: {dev['nodes'].shape[0]} BVH{a} nodes "
            f"({dev['nodes'].numel() * 4 / 1e6:.1f} MB), "
            f"{dev['tris'].shape[0]} Tri{m} rows "
            f"({dev['tris'].numel() * 4 / 1e6:.1f} MB); pops/ray "
            f"{s['pops_ray']:.6f}, leaf pops/ray {s['leaf_ray']:.6f}, "
            f"warp-max {s['warp_pops']:.3f}; hit {hits:.4f}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="race_hall_packet")
    p.add_argument("--tris", type=int, default=common.SIZES["hall"])
    p.add_argument("--rays", type=int, default=1024 * 1024)
    p.add_argument("--packets", default="8,12,16,24")
    p.add_argument("--lcs", default="0,0.6")
    common.add_args(p)
    args = p.parse_args(argv)
    packets = packets_arg(p, args.packets)
    device = common.device_of(args, "race_hall_packet")
    print(f"card: {common.card(device)}", flush=True)
    verts, idx = testscenes.make_hall(args.tris)
    side = math.isqrt(args.rays)
    n = side * side
    comps, _ = common.distributions("hall", verts, idx, None, side, device,
                                    ("primary",))["primary"]
    print(f"hall: {len(idx) // 4} tris, {n} sorted primaries", flush=True)
    base = None
    for pk in packets:
        for lc in (float(x) for x in args.lcs.split(",")):
            dev = api.bvh_to_device(build_bvh(
                verts, idx, arity=8, packet=pk, leaf_threshold=12,
                leaf_cost=lc), device)
            name = f"pk={pk} lc={lc:g}" if lc else f"pk={pk} lc=def"
            out = common.counted(dev, comps)
            s = common.pop_stats(out)
            hits = float((out["prim_id"] >= 0).double().mean())
            print(build_line(name, dev, s, hits), flush=True)

            def k1(dev=dev):
                return packet.traverse_packet_components(dev, *comps)

            def k7(dev=dev, count_pops=False):
                return packet.traverse_packet_components(
                    dev, *comps, count_pops=count_pops, **CT_BODY)
            if base is None:
                ms, _ = common.timed(k1, device, args.blocks,
                                     warmup_s=common.WARMUP_S)
                base = (name, k1)
                print(f"  K1: {ms:.4f} ms = {n / ms / 1e3:.2f} Mrays/s",
                      flush=True)
            else:
                b_ms, ms, _, _ = common.in_turns(base[1], k1, device,
                                                 args.blocks)
                print(f"  K1: {ms:.4f} ms = {n / ms / 1e3:.2f} Mrays/s; in "
                      f"turns with {base[0]} {b_ms:.4f} ms: "
                      f"{ms / b_ms:.3f}x", flush=True)
            k1_ms, ms, _, _ = common.in_turns(k1, k7, device, args.blocks)
            s = common.pop_stats(k7(count_pops=True))
            print(f"  K7 ct-fold: {ms:.4f} ms = {n / ms / 1e3:.2f} "
                  f"Mrays/s; in turns with this build's K1 {k1_ms:.4f} ms: "
                  f"{ms / k1_ms:.3f}x; pops/ray {s['pops_ray']:.6f}, leaf "
                  f"pops/ray {s['leaf_ray']:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
