"""A model of how a warp of K7 (csrc/bvh_ct.cu, the carry-top body) runs
its rays' pops, from each ray's sequence of pop kinds.

Each ray pops the same entries in the same order whatever the loop's form
(its t, its stack and its carried next pop are its own), so its sequence of
pop kinds (node, leaf, done) is fixed by its inputs: K7's plain version
records it (api.traverse_ct_components(..., record_kinds=True)). A warp of
32 consecutive rays runs a path of the loop whenever any of its rays takes
it, so what a warp runs depends on the loop's form. For each warp this
counts the node path's and the leaf path's runs under three rules:

- "if-if": `while (code != 0) { if (code > 0) node; else leaf; }`, one pop
  a ray a trip, the rays in lockstep: a trip runs the node path where any
  ray of the warp pops a node, and the leaf path where any pops a leaf;
- "while-while": `while (code != 0) { while (code > 0) node; while (code <
  0) leaf; }` (the reference's GPU traversal, mapping_gpu.impala:94-178,
  and the Aila-Laine kernel): node pops while any ray's next pop is a
  node (a ray that holds a leaf or is done waits), then leaf pops while
  any ray's next pop is a leaf, and again;
- "busiest": each path as often as the warp's busiest ray takes it (the
  issue estimate of experiments/sass_audit.py), the least any loop runs.

Beside each: the share of lanes busy in a run (the pops over 32 x runs) and
the outer loop's trips (while-while). Given a node pop's and a leaf pop's
warp instructions (`--instr M=NODE,LEAF` for Tri-M rows, from sass_audit),
it prints the instructions each rule issues and while-while over if-if.

Distributions: hall-260K's sorted primaries, bounce and ao rays and the
primaries and bounces interleaved ray by ray (the Tri8 build, ct-fold;
any-hit "ct"), and powerplant-4.3M's three (the Tri24 build). The plain
version runs on the card, or on the CPU with --cpu at a small size.

--legacy counts the legacy order's pops instead, K1's and K3's (and K4's
base's, csrc/bvh_traverse.cu): K7 with the Batcher network and without
the fused slab (any-hit: without the fused slab) pops what K1 pops in
K1's order (csrc/bvh_ct.cu), so its record is K3's pop sequence.

Usage: python -m rodent_tpu_torch.experiments.ct_warp_model
    [--scenes hall,powerplant] [--instr 8=NODE,LEAF --instr 24=NODE,LEAF]
    [--legacy] [--cpu --tris 20000 --side 64]
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..traversal import api
from . import common, measure_ct

RULES = ("if-if", "while-while", "busiest")
# K7's bodies whose pops are K1's, in K1's order: closest-hit, any-hit
LEGACY = ({"select": "sort", "fma_slab": False},
          {"select": "fold", "fma_slab": False})
# scene -> (build, distributions)
SCENES = {"hall": (common.TRI8, ("primary", "bounces", "ao", "interleaved")),
          "powerplant": (common.TRI24, ("primary", "bounces", "ao"))}


def kinds(dev, comps, any_hit, body):
    """(n, L) int8 pop kinds of K7's plain version on these rays (1 node,
    -1 leaf, 0 done) with body {"select", "fma_slab"}."""
    return api.traverse_ct_components(
        dev, comps[0], comps[1], comps[2], comps[4], comps[5], any_hit,
        record_kinds=True, **body)["kinds"]


def _while_while(w):
    """(node runs, leaf runs, outer trips) of each warp ((W, 32, L) kinds,
    every lane's sequence ending in 0) under the while-while loop, as
    (W,) int64 tensors: a step runs the warp's current inner loop once
    where any lane's next pop is of its kind, else leaves that loop."""
    nw, lanes, _ = w.shape
    pos = torch.zeros((nw, lanes, 1), dtype=torch.int64, device=w.device)
    in_leaf = torch.zeros(nw, dtype=torch.bool, device=w.device)
    node = torch.zeros(nw, dtype=torch.int64, device=w.device)
    leaf = torch.zeros_like(node)
    cur = w.gather(2, pos)[..., 0]
    outer = (cur != 0).any(1).to(torch.int64)
    while True:
        live = (cur != 0).any(1)
        if not bool(live.any()):
            break
        want = torch.where(in_leaf, -1, 1).to(w.dtype)
        act = cur == want[:, None]
        run = act.any(1)
        node += run & ~in_leaf
        leaf += run & in_leaf
        pos += act[..., None]
        leave = live & ~run
        outer += leave & in_leaf
        in_leaf ^= leave
        cur = w.gather(2, pos)[..., 0]
    return node, leaf, outer


def warp_counts(kinds, warp=common.WARP):
    """The warps' path runs of (n, L) pop kinds (rays in launch order, a
    warp `warp` consecutive rays; the last warp padded with done lanes):
    {"rays", "warps", "node_pops", "leaf_pops", rule: {"node", "leaf"
    (runs summed over the warps), "node_busy", "leaf_busy" (the share of
    lanes that pop in a run)}, and "while-while"'s "outer" (its outer
    loop's trips)}."""
    n, length = kinds.shape
    k = torch.zeros((n + (-n) % warp, length + 1), dtype=torch.int8,
                    device=kinds.device)
    k[:n, :length] = kinds
    w = k.view(-1, warp, length + 1)
    is_node, is_leaf = w == 1, w == -1
    out = {"rays": n, "warps": w.shape[0], "node_pops": int(is_node.sum()),
           "leaf_pops": int(is_leaf.sum())}
    node, leaf, outer = _while_while(w)
    runs = {"if-if": (int(is_node.any(1).sum()), int(is_leaf.any(1).sum())),
            "while-while": (int(node.sum()), int(leaf.sum())),
            "busiest": (int(is_node.sum(2).max(1).values.sum()),
                        int(is_leaf.sum(2).max(1).values.sum()))}
    for rule, (nr, lr) in runs.items():
        out[rule] = {"node": nr, "leaf": lr,
                     "node_busy": out["node_pops"] / max(1, warp * nr),
                     "leaf_busy": out["leaf_pops"] / max(1, warp * lr)}
    out["while-while"]["outer"] = int(outer.sum())
    return out


def instructions(counts, node_instr, leaf_instr):
    """{rule: warp instructions}: each rule's node and leaf runs times a
    node pop's and a leaf pop's warp instructions."""
    return {rule: counts[rule]["node"] * node_instr
            + counts[rule]["leaf"] * leaf_instr for rule in RULES}


def report(what, c, instr=None):
    """The lines of one distribution's counts (instr: (node, leaf) warp
    instructions a pop, or None)."""
    w = c["warps"]
    lines = [f"{what}: {c['rays']} rays, {w} warps; pops/ray "
             f"{(c['node_pops'] + c['leaf_pops']) / c['rays']:.4f} (leaf "
             f"{c['leaf_pops'] / c['rays']:.4f})"]
    for rule in RULES:
        r = c[rule]
        lines.append(
            f"  {rule:11s} node runs/warp {r['node'] / w:.4f} (lanes busy "
            f"{r['node_busy']:.1%}), leaf runs/warp {r['leaf'] / w:.4f} "
            f"(lanes busy {r['leaf_busy']:.1%})"
            + (f", outer trips/warp {r['outer'] / w:.4f}"
               if "outer" in r else ""))
    if instr:
        ins = instructions(c, *instr)
        lines.append(
            f"  warp instructions/warp at {instr[0]} a node pop, {instr[1]} "
            "a leaf pop: " + ", ".join(f"{k} {v / w:.1f}"
                                       for k, v in ins.items())
            + f"; while-while / if-if {ins['while-while'] / ins['if-if']:.4f}")
    return lines


def run(device, scenes=tuple(SCENES), instr=None, tris=None, side=1024,
        legacy=False):
    """The counts of each scene's distributions, printed: {(scene, kind):
    warp_counts' result}. instr: {M: (node, leaf) warp instructions};
    legacy: the legacy order's pops (LEGACY) instead of ct-fold's."""
    print(f"card: {common.card(device)}", flush=True)
    out = {}
    for scene in scenes:
        build, kinds_of = SCENES[scene]
        verts, idx, dev, secs = common.load(scene, build, device, tris)
        print(common.scene_line(scene, idx, dev, secs), flush=True)
        dists = common.distributions(scene, verts, idx, dev, side, device,
                                     kinds_of)
        for kind, (comps, any_hit) in dists.items():
            name, body = next(iter((measure_ct.ANY_HIT_VARIANTS if any_hit
                                    else measure_ct.VARIANTS).items()))
            if legacy:
                name, body = "legacy order (K3)", LEGACY[any_hit]
            c = warp_counts(kinds(dev, comps, any_hit, body))
            out[(scene, kind)] = c
            for line in report(f"{scene} {kind} {name}", c,
                               (instr or {}).get(dev["tris"].shape[1] // 14)):
                print(line, flush=True)
    return out


def parse_instr(specs):
    """{M: (node, leaf)} of "M=NODE,LEAF" strings."""
    out = {}
    for spec in specs or ():
        m, _, pair = spec.partition("=")
        node, _, leaf = pair.partition(",")
        try:
            out[int(m)] = (float(node), float(leaf))
        except ValueError:
            raise ValueError(f"--instr {spec!r}: expected M=NODE,LEAF") \
                from None
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="ct_warp_model")
    p.add_argument("--scenes", default=",".join(SCENES),
                   help="comma-separated, of " + ", ".join(SCENES))
    p.add_argument("--instr", action="append", metavar="M=NODE,LEAF",
                   help="a node pop's and a leaf pop's warp instructions "
                   "at Tri-M rows (sass_audit's)")
    p.add_argument("--tris", type=int, default=None,
                   help="the scenes' size (default: their full size)")
    p.add_argument("--side", type=int, default=1024,
                   help="side x side rays")
    p.add_argument("--legacy", action="store_true",
                   help="the legacy order's pops (K1, K3, K4's base)")
    p.add_argument("--cpu", action="store_true",
                   help="the plain version on the CPU, at a small size")
    args = p.parse_args(argv)
    scenes = args.scenes.split(",")
    bad = [s for s in scenes if s not in SCENES]
    if bad:
        p.error(f"unknown scenes {bad}")
    try:
        instr = parse_instr(args.instr)
    except ValueError as e:
        p.error(str(e))
    device = common.device_of(args, "ct_warp_model")
    run(device, scenes, instr, args.tris, args.side, args.legacy)
    return 0


if __name__ == "__main__":
    sys.exit(main())
