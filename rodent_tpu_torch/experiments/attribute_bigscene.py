"""Attribution of the big-scene traversal's cost on the card (port of
experiments/attribute_bigscene.py).

On powerplant-4.3M (BVH8/Tri24, the big-scene build: a 300 MB Tri table,
six times the card's L2) with 1M sorted primaries:

- the counted pass (K3): node pops against leaf pops per ray, the warps'
  largest counts, and the node-row and Tri-row bytes a ray's pops read
  (a node row is 28A bytes, a Tri24 row 1,344);
- K1 against K2 (the next-pop L2 prefetch) in turns (K1, K2, K2, K1);
- K3 against each K4 option in turns (K3, option, option, K3): the
  row-load and leaf-chain variants matter most here, where Tri rows miss
  L2. nonodetest is not run by default: without slab tests a ray pops
  all of the tree's 250,000 entries.

Each row prints its time, Mrays/s, pops per ray and its bound, the least
time the card could take for the same pops and the table rows they read
(common.bound_ms; the plain version counts the rows, common.rows_read).

Usage: python -m rodent_tpu_torch.experiments.attribute_bigscene
    [--tris 5000000] [--rays 1048576] [--blocks 5]
    [--options noleaftest,nosort,pops2,chain2,chain4,row_loads] [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..traversal import packet
from . import common

OPTIONS = ("noleaftest", "nosort", "pops2", "chain2", "chain4", "row_loads")


def main(argv=None):
    p = argparse.ArgumentParser(prog="attribute_bigscene")
    p.add_argument("--tris", type=int, default=5_000_000)
    p.add_argument("--rays", type=int, default=1024 * 1024)
    p.add_argument("--options", default=",".join(OPTIONS))
    common.add_args(p)
    args = p.parse_args(argv)
    device = common.device_of(args, "attribute_bigscene")
    options = [o for o in args.options.split(",") if o]
    for o in options:
        if o not in packet.OPTIONS:
            p.error(f"option {o!r}: choose from {', '.join(packet.OPTIONS)}")
    print(f"card: {common.card(device)}", flush=True)
    verts, idx, dev, secs = common.load("powerplant", common.TRI24, device,
                                        args.tris)
    side = int(np.sqrt(args.rays))
    n = side * side
    comps, _ = common.distributions("powerplant", verts, idx, dev, side,
                                    device, ("primary",))["primary"]
    a = dev["nodes"].shape[1] // 7
    m = dev["tris"].shape[1] // 14
    print(f"powerplant: {len(idx) // 4} tris, {dev['nodes'].shape[0]} BVH{a}"
          f" nodes = {dev['nodes'].numel() * 4 / 1e6:.1f} MB, "
          f"{dev['tris'].shape[0]} Tri{m} rows = "
          f"{dev['tris'].numel() * 4 / 1e6:.1f} MB (built in {secs:.1f} s); "
          f"{n} sorted primaries", flush=True)

    k3 = common.pop_stats(common.counted(dev, comps))
    print(f"counted (K3): pops/ray {k3['pops_ray']:.3f}, node "
          f"{k3['node'] / n:.3f}, leaf {k3['leaf_ray']:.3f} (leaf share "
          f"{k3['leaf'] / k3['pops']:.4f}); warp-max node "
          f"{k3['warp_node']:.3f}, leaf {k3['warp_leaf']:.3f}; bytes per ray "
          f"read by pops: node rows {k3['node'] / n * 28 * a:.0f}, Tri rows "
          f"{k3['leaf_ray'] * 56 * m:.0f}", flush=True)
    read = common.rows_read(dev, comps)
    print(f"rows read (plain version): {read[0]} of {dev['nodes'].shape[0]} "
          f"node rows, {read[1]} of {dev['tris'].shape[0]} Tri rows = "
          f"{(read[0] * 28 * a + read[1] * 56 * m) / 1e6:.1f} MB", flush=True)

    def row(name, ms, s, option=None, counters=True):
        tested = k3["leaf"] if option in ("chain2", "chain4") else s["leaf"]
        rows = common.rows_read(dev, comps, option=option) if option \
            else read
        bound, by = common.bound_ms(dev, n, s["node"], tested, rows,
                                    option=option, counters=counters)
        print(f"{name:>10}: {ms:9.4f} ms = {n / ms / 1e3:9.2f} Mrays/s; "
              f"pops/ray {s['pops_ray']:8.3f} (leaf {s['leaf_ray']:.3f}); "
              f"bound {bound:.4f} ms ({by}), {bound / ms:.1%} of it",
              flush=True)

    def k(prefetch):
        return lambda: packet.traverse_packet_components(dev, *comps,
                                                         prefetch=prefetch)
    k1_ms, k2_ms, _, _ = common.in_turns(k(False), k(True), device,
                                         args.blocks, warmup_s=common.WARMUP_S)
    row("K1", k1_ms, k3, counters=False)
    row("K2", k2_ms, k3, counters=False)
    res = common.option_turns(dev, comps, device, options, blocks=args.blocks)
    if options:
        row("K3", res["K3"]["ms"], k3)
    for o in options:
        row(o, res[o]["ms"], common.pop_stats(res[o]["out"]), option=o)
        print(f"{'':>10}  in turns with K3: {res[o]['k3_ms']:.4f} ms, "
              f"{o} {res[o]['ms'] / res[o]['k3_ms']:.3f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
