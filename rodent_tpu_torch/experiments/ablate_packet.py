"""Per-pop cost bisection of the traversal kernel by ablation (port of
experiments/ablate_packet.py).

On 1M sorted hall-260K primaries (BVH8/Tri8), K3 (K1 with pop counters)
and K4 with each ablation compiled in, timed in turns (K3, option,
option, K3):

  nonodetest  push every nonzero child without a slab test: hits stay
              right, and a closest-hit ray then pops the whole tree
  noleaftest  skip the Moller-Trumbore lanes of a leaf: every ray misses
  nosort      push hit children in slot order (no Batcher network)

Each row prints Mrays/s, pops per ray (node and leaf) and ns per pop, the
launch's time over all of its own pops, as the JAX script does. The
differences of ns per pop against K3 say where a pop's time goes: K3's
less nonodetest's is what the slab tests (and the divergence they cause)
add to a pop, K3's less noleaftest's what the MT lanes add. nonodetest's
rays all walk the whole tree in slot order, so its warps never diverge
and read each row once for all their threads: its ns per pop is a
coherent walk's, not a cheaper pop of K3's kind. (A linear model with a
cost per node pop, per leaf pop and per bare pop, solved from the three
variants, gives the bare pop a negative cost on the H100: the costs do not
add up across variants whose warps diverge this differently.)

Usage: python -m rodent_tpu_torch.experiments.ablate_packet [--tris 260000]
    [--rays 1048576] [--cases nonodetest,noleaftest,nosort] [--blocks 5]
    [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..traversal.api import ABLATIONS
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(prog="ablate_packet")
    p.add_argument("--tris", type=int, default=260_000)
    p.add_argument("--rays", type=int, default=1024 * 1024)
    p.add_argument("--cases", default=",".join(ABLATIONS))
    common.add_args(p)
    args = p.parse_args(argv)
    device = common.device_of(args, "ablate_packet")
    cases = args.cases.split(",")
    for c in cases:
        if c not in ABLATIONS:
            p.error(f"case {c!r}: choose from {', '.join(ABLATIONS)}")
    print(f"card: {common.card(device)}", flush=True)
    verts, idx, dev, secs = common.load("hall", common.TRI8, device,
                                        args.tris)
    side = int(np.sqrt(args.rays))
    comps, _ = common.distributions("hall", verts, idx, dev, side, device,
                                    ("primary",))["primary"]
    n = side * side
    print(f"hall-{args.tris // 1000}K: {dev['nodes'].shape[0]} BVH8 nodes, "
          f"{dev['tris'].shape[0]} Tri8 rows (built in {secs:.1f} s); {n} "
          f"sorted primaries", flush=True)
    res = common.option_turns(dev, comps, device, cases, blocks=args.blocks)
    k3 = common.pop_stats(res["K3"]["out"])

    def row(name, ms, s):
        print(f"{name:>12}: {n / ms / 1e3:9.2f} Mrays/s  {ms:9.4f} ms  "
              f"pops/ray {s['pops_ray']:9.2f} (node {s['node'] / n:8.2f}, "
              f"leaf {s['leaf_ray']:8.2f})  ns/pop "
              f"{ms * 1e6 / s['pops']:.5f}", flush=True)

    row("K3", res["K3"]["ms"], k3)
    stats = {}
    for c in cases:
        stats[c] = common.pop_stats(res[c]["out"])
        row(c, res[c]["ms"], stats[c])
        ratio = res[c]["ms"] / res[c]["k3_ms"]
        print(f"{'':>12}  in turns with K3: K3 {res[c]['k3_ms']:.4f} ms, "
              f"{c} {res[c]['ms']:.4f} ms ({ratio:.3f}x)", flush=True)
    k3_ns = res["K3"]["ms"] * 1e6 / k3["pops"]
    what = {"nonodetest": "the slab tests and sort", "noleaftest":
            "the MT lanes", "nosort": "the Batcher network"}
    for c in cases:
        ns = res[c]["ms"] * 1e6 / stats[c]["pops"]
        print(f"ns per pop, K3 less {c}: {k3_ns - ns:.5f} ({what[c]}, per "
              f"pop of each's own)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
