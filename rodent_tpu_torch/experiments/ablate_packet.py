"""Per-pop cost bisection of the traversal kernel by ablation (port of
experiments/ablate_packet.py).

On 1M sorted hall-260K primaries (BVH8/Tri8), K3 (K1 with pop counters),
K4's base (K4 with no option: K3's pops on K4's loop) and K4 with each
ablation compiled in, timed in turns (K3, base, the ablations, and back:
common.option_turns):

  nonodetest  push every nonzero child without a slab test: hits stay
              right, and a closest-hit ray then pops the whole tree
  noleaftest  skip the Moller-Trumbore lanes of a leaf: every ray misses
  nosort      push hit children in slot order (no Batcher network)

Each row prints Mrays/s, pops per ray (node and leaf) and ns per pop, the
launch's time over all of its own pops, as the JAX script does, and its
time over K3's and over the base's in their turns. The differences of ns
per pop against K3 and against the base say where a pop's time goes:
K3's (or the base's) less nonodetest's is what the slab tests (and the
divergence they cause) add to a pop, less noleaftest's what the MT lanes
add; against the base, on the loop the options run.
nonodetest's rays all walk the whole tree in slot order, so its warps
never diverge and read each row once for all their threads: its ns per
pop is a coherent walk's, not a cheaper pop of the base's kind. (A linear
model with a cost per node pop, per leaf pop and per bare pop, solved
from the three variants, gives the bare pop a negative cost on the H100:
the costs do not add up across variants whose warps diverge this
differently.)

--against DIR [DIR ...] times another checkout's K4 against this one's:
the other tree's "options" library (csrc/bvh_traverse.cu with
-DRT_OPTIONS; a parent commit unpacked with `git archive` into a
directory that .gitignore lists) is built with this tree's nvcc flags
into build/measure_ct/ and launched through K4's wrapper on the same
tensors, in turns (other, this, this, other), for every option, closest-
hit and any-hit, on hall-260K (Tri8) and powerplant-4.3M (Tri24): the 1M
sorted primaries and 65,536 ao rays in pixel order, chip_smoke.py phase
11's rays (nonodetest, which pops the whole tree, on the first
NONODE_RAYS of them). Both bodies' outputs must be equal bit for bit,
hits and counters. Beside each: this tree's option over K3 and over the
base in their turns (K3, base, option, option, base, K3), its pops and
leaf pops per ray and its share of its bound (common.bound_ms, from the
rows its plain version reads on the first ROWS_RAYS rays). The ao turns
(but nonodetest's) are timed as CUDA-graph replays (common.launch_ms): an
ao launch is about as short as the wrapper's host time per call, and
timed call by call its ratios moved by up to 1.8x from one run to the
next. The base has no counterpart in an older tree: its row is its turns
with K3. Needs the card.

Usage: python -m rodent_tpu_torch.experiments.ablate_packet [--tris 260000]
    [--rays 1048576] [--cases nonodetest,noleaftest,nosort] [--blocks 5]
    [--cpu]
    python -m rodent_tpu_torch.experiments.ablate_packet --against DIR
    [DIR ...] [--blocks 5]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..traversal import packet
from ..traversal.api import ABLATIONS
from . import common

# --against: the scenes and builds, and the rays of chip_smoke.py phase 11
AGAINST = (("hall", common.TRI8), ("powerplant", common.TRI24))
AO_RAYS = 65_536
NONODE_RAYS = {"hall": 65_536, "powerplant": 16_384}
# the rays whose rows read the bound counts (a lower bound: fewer rays
# read fewer rows)
ROWS_RAYS = 65_536


def option_bound(dev, comps, any_hit, option, out, k3_out):
    """(common.bound_ms's (ms, what binds), pop_stats of out): the least
    time for the pops K4's `option` made on these rays (out, a counted
    launch) and the rows its plain version reads on the first ROWS_RAYS;
    a leaf chain tests the Tri rows K3 (k3_out) pops one by one."""
    s = common.pop_stats(out)
    tested = (common.pop_stats(k3_out)["leaf"] if option.startswith("chain")
              else s["leaf"])
    rows = common.rows_read(dev, common.head(comps, ROWS_RAYS), any_hit,
                            option)
    return common.bound_ms(dev, s["n"], s["node"], tested, rows, any_hit,
                           option, counters=True), s


def measure_against(dev, comps, device, libs, option, any_hit=False,
                    blocks=5, warmup_s=0.0, graphs=False):
    """K4's `option` on these rays: in turns with K3 and the base
    (common.option_turns), and each other checkout's K4 (libs: {root:
    its "options" library}) in turns with this one's (common.against),
    counters on; with graphs, every turn as CUDA-graph replays. Raises
    unless every output of each equals this body's bit for bit. {"ms",
    "k3_ms", "base_ms", "stats", "bound", "share", root: {"ms",
    "other_ms", "ratio" (this over the other)}}."""
    turns = common.option_turns(dev, comps, device, [option], any_hit,
                                blocks, graphs)
    r = turns[option]
    bound, s = option_bound(dev, comps, any_hit, option, r["out"],
                            turns["K3"]["out"])
    res = {"ms": r["ms"], "k3_ms": r["k3_ms"], "base_ms": r["base_ms"],
           "stats": s, "bound": bound, "share": bound[0] / r["ms"]}
    flat = [*comps[2], *comps[0], *comps[1], comps[4], comps[5]]
    others = {root: (lambda lib=lib: packet._launch(
        dev, flat, any_hit, "bvh_traverse_option", option, lib))
        for root, lib in libs.items()}
    res.update(common.against(
        lambda: common.counted(dev, comps, any_hit, option), others, device,
        blocks, warmup_s, graphs, option))
    return res


def report_against(what, option, r, roots):
    s = r["stats"]
    text = (f"{what} {option:10s} {r['ms']:.4f} ms; K3 in turns "
            f"{r['k3_ms']:.4f} ms: {r['ms'] / r['k3_ms']:.4f}x; base in "
            f"turns {r['base_ms']:.4f} ms: {r['ms'] / r['base_ms']:.4f}x")
    for root in roots:
        if root in r:
            a = r[root]
            text += (f"; {root} in turns {a['other_ms']:.4f} ms: "
                     f"{a['ratio']:.4f}x")
    return (text + f"; pops/ray {s['pops_ray']:.4f} (leaf "
            f"{s['leaf_ray']:.4f}); bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}), {r['share']:.1%} of it")


def run_against(device, roots, blocks=5, tris=None, side=1024):
    """The checkouts at roots each against this one (measure_against) on
    AGAINST's scenes, every option on the primaries and the ao rays,
    printed; returns {(scene, kind): {option: result}}."""
    print(f"card: {common.card(device)}", flush=True)
    libs = common.against_libraries("options", roots)
    out, first = {}, True
    for scene, cfg in AGAINST:
        verts, idx, dev, secs = common.load(scene, cfg, device, tris)
        print(common.scene_line(scene, idx, dev, secs), flush=True)
        dists = common.distributions(scene, verts, idx, dev, side, device,
                                     ("primary", "ao-unsorted"))
        for kind, comps, any_hit in (
                ("primary", dists["primary"][0], False),
                ("ao", common.head(dists["ao-unsorted"][0], AO_RAYS), True)):
            res = out[(scene, kind)] = {}
            for option in common.options_for(any_hit):
                nonode = option == "nonodetest"
                c = common.head(comps, NONODE_RAYS[scene]) if nonode else comps
                # an ao launch (512 blocks, under one wave of the card)
                # takes about as long as the wrapper's host time per call:
                # timed as graph replays; nonodetest's launches take 80 ms
                graphs = kind == "ao" and not nonode
                res[option] = measure_against(
                    dev, c, device, {} if option == "base" else libs,
                    option, any_hit, blocks,
                    common.WARMUP_S if first else 0.0, graphs)
                first = False
                print(report_against(
                    f"{scene} {kind} ({c[4].shape[0]} rays"
                    f"{', graphed' if graphs else ''})", option,
                    res[option], roots), flush=True)
    return out


def run(device, cases, tris=260_000, rays=1024 * 1024, blocks=5):
    """The ablations of `cases` on hall's sorted primaries, printed."""
    print(f"card: {common.card(device)}", flush=True)
    verts, idx, dev, secs = common.load("hall", common.TRI8, device, tris)
    side = int(np.sqrt(rays))
    comps, _ = common.distributions("hall", verts, idx, dev, side, device,
                                    ("primary",))["primary"]
    n = side * side
    print(f"hall-{tris // 1000}K: {dev['nodes'].shape[0]} BVH8 nodes, "
          f"{dev['tris'].shape[0]} Tri8 rows (built in {secs:.1f} s); {n} "
          f"sorted primaries", flush=True)
    res = common.option_turns(dev, comps, device, cases, blocks=blocks)
    k3 = common.pop_stats(res["K3"]["out"])

    def row(name, ms, s):
        print(f"{name:>12}: {n / ms / 1e3:9.2f} Mrays/s  {ms:9.4f} ms  "
              f"pops/ray {s['pops_ray']:9.2f} (node {s['node'] / n:8.2f}, "
              f"leaf {s['leaf_ray']:8.2f})  ns/pop "
              f"{ms * 1e6 / s['pops']:.5f}", flush=True)

    row("K3", res["K3"]["ms"], k3)
    stats = {}
    for c in ["base"] + cases:
        stats[c] = common.pop_stats(res[c]["out"])
        row(c, res[c]["ms"], stats[c])
        print(f"{'':>12}  in turns with K3: K3 {res[c]['k3_ms']:.4f} ms, "
              f"{c} {res[c]['ms']:.4f} ms "
              f"({res[c]['ms'] / res[c]['k3_ms']:.3f}x); with the base: "
              f"base {res[c]['base_ms']:.4f} ms "
              f"({res[c]['ms'] / res[c]['base_ms']:.3f}x)", flush=True)
    what = {"nonodetest": "the slab tests and sort", "noleaftest":
            "the MT lanes", "nosort": "the Batcher network"}
    for ref, s in (("K3", k3), ("the base", stats["base"])):
        ref_ns = res["K3" if ref == "K3" else "base"]["ms"] * 1e6 / s["pops"]
        for c in cases:
            ns = res[c]["ms"] * 1e6 / stats[c]["pops"]
            print(f"ns per pop, {ref} less {c}: {ref_ns - ns:.5f} "
                  f"({what[c]}, per pop of each's own)", flush=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="ablate_packet")
    p.add_argument("--tris", type=int, default=None,
                   help="the scenes' size (default: hall 260,000, "
                   "powerplant 5,000,000)")
    p.add_argument("--rays", type=int, default=1024 * 1024)
    p.add_argument("--cases", default=",".join(ABLATIONS))
    p.add_argument("--against", nargs="+", metavar="DIR",
                   help="the roots of other checkouts whose K4 is timed "
                   "against this one's, every option")
    common.add_args(p)
    args = p.parse_args(argv)
    if args.against and args.cpu:
        p.error("--against times two builds of a CUDA kernel: it needs the "
                "card")
    if args.against:
        device = common.device_of(args, "ablate_packet")
        run_against(device, args.against, args.blocks, args.tris,
                    int(np.sqrt(args.rays)))
        return 0
    cases = args.cases.split(",")
    for c in cases:
        if c not in ABLATIONS:
            p.error(f"case {c!r}: choose from {', '.join(ABLATIONS)}")
    device = common.device_of(args, "ablate_packet")
    run(device, cases, args.tris or common.SIZES["hall"], args.rays,
        args.blocks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
