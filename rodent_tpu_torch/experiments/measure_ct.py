"""The carry-top body against the legacy body on hall's primary row (port
of experiments/measure_ct.py).

The JAX program raced four bodies of the TPU's packet kernel on hall-260K's
1M sorted primaries: the legacy body and the carry-top body (the next pop
in the while loop's carry, the reference's top-of-stack trick,
stack.impala:25-50) with its two child selections and its two slab forms.
Here the same four run on the card: the legacy body is K1
(csrc/bvh_traverse.cu), the carry-top body K7 (csrc/bvh_ct.cu) as ct-fold
(the strict-< min-fold, the fused slab b * inv + (-(org * inv))), ct-sort
(Batcher's network, fused) and ct-fold-nofma (the min-fold, (b - org) *
inv). Each body is timed in turns with K1 (common.in_turns: K1, body,
body, K1), so the legacy row is K1 against itself, the noise of a turn.
Beside each: its pops and leaf pops per ray and its warps' largest, from
its counting instantiation (K3, or K7 with counters), the rays where it
keeps another hit than K1 (differences: ties, or grazing rays, at most
DIFF_LIMIT of them; each body equals its own plain version bit for bit,
which chip_smoke.py checks), and its bound
(common.bound_ms from its own pops and the rows its plain version reads)
with its share of it. The JAX program's tile rows (its argument) are the
TPU kernel's tile shape, which a ray per thread does not have, so they
went.

--prefetch times K7-PF, each K7 variant with the exact next-pop L2
prefetch (the JAX package's _kernel_ct with tris_hbm and prefetch, which
its tools run on the big-scene tiers), on powerplant-4.3M's 1M sorted
primaries, bounce rays and ao rays (the Tri24 build): each variant in
turns with the same variant without the prefetch (K7), then in turns with
K2 (K1 with the same prefetch, the legacy body the big-scene tiers take),
beside its pops per ray, its bound and its share of it; K7-PF's hits must
equal K7's bit for bit.

--against DIR [DIR ...] times another checkout's K7 body against this
one's: the other tree's csrc/bvh_ct.cu (a parent commit unpacked with `git
archive` into a directory that .gitignore lists, or a trial copy) is built
with this tree's nvcc flags into build/measure_ct/ and launched through
K7's wrapper on the same tensors, in turns (other, this, this, other), for
every variant on hall-260K's 1M sorted primaries, bounce rays, ao rays and
the primaries and bounces interleaved ray by ray (2M rays), and on
powerplant-4.3M's primaries; with --prefetch, K7-PF on powerplant's three
distributions. Both bodies' outputs must equal each other bit for bit
(hits, and pops and leaf pops from the counting instantiations; each equals
its plain version, which chip_smoke.py checks). Beside each: this body's
pops per ray, its bound and its share of it. Needs the card.

Usage: python -m rodent_tpu_torch.experiments.measure_ct [--blocks 5]
    [--prefetch] [--against DIR [DIR ...]] [--cpu [--tris 2000 --side 32]]
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..traversal import packet
from . import common

# the share of rays on which a body may keep another hit than K1's
# (chip_smoke.py's TIE_LIMIT)
DIFF_LIMIT = 1e-4
# body -> traverse_packet's carry-top arguments (None: the legacy body, K1)
BODIES = {"legacy": None,
          "ct-fold": {"select": "fold", "fma_slab": True},
          "ct-sort": {"select": "sort", "fma_slab": True},
          "ct-fold-nofma": {"select": "fold", "fma_slab": False}}
# every K7 variant of a closest-hit launch, and of an any-hit launch (whose
# choice is the lowest slot whatever the select)
VARIANTS = {"ct-fold": BODIES["ct-fold"], "ct-sort": BODIES["ct-sort"],
            "ct-fold-nofma": BODIES["ct-fold-nofma"],
            "ct-sort-nofma": {"select": "sort", "fma_slab": False}}
ANY_HIT_VARIANTS = {"ct": {"select": "fold", "fma_slab": True},
                    "ct-nofma": {"select": "fold", "fma_slab": False}}
# the big-scene distributions --prefetch times K7-PF on
PF_DISTS = ("primary", "bounces", "ao")
# --against: (scene, build, distributions) of K7's turns
AGAINST = (("hall", common.TRI8, ("primary", "bounces", "ao", "interleaved")),
           ("powerplant", common.TRI24, ("primary",)))


def call(dev, comps, body, any_hit=False, count_pops=False, lib=None):
    """One launch of BODIES' `body` ({"select", "fma_slab"}, with
    "prefetch" for K7-PF, or None) on the ray components, without
    synchronising; lib: another checkout's "ct" library
    (common.other_library) to launch K7 from."""
    if lib is not None:
        return packet._launch_ct(
            dev, [*comps[2], *comps[0], *comps[1], comps[4], comps[5]],
            any_hit, count_pops, body["select"], body["fma_slab"],
            body.get("prefetch", False), lib)
    kw = {} if body is None else dict(carry_top=True, **body)
    return packet.traverse_packet_components(dev, *comps, any_hit=any_hit,
                                             count_pops=count_pops, **kw)


def differences(out, ref, any_hit, what):
    """(ties, others): the rays where `out` keeps another hit than `ref`
    (K1), closest-hit: ties, a prim_id within 1e-6 of K1's t relative (two
    triangles hit at the same t, or a few ULPs apart through a shared
    edge), and others; any-hit: others, a hit where K1 has none or the
    reverse. Another body may keep another hit than K1's on a grazing ray:
    its slab form rounds a plane otherwise, and its pop order tests a box
    against another running t. Raises where they pass DIFF_LIMIT of the
    rays."""
    if any_hit:
        diff = (out["prim_id"] >= 0) != (ref["prim_id"] >= 0)
        ties = 0
    else:
        diff = out["prim_id"] != ref["prim_id"]
        near = (out["t"] - ref["t"]).abs() <= 1e-6 * ref["t"].abs()
        ties = int((diff & near).sum())
    others = int(diff.sum()) - ties
    if ties + others > DIFF_LIMIT * diff.shape[0]:
        raise RuntimeError(f"{what}: {ties} ties and {others} other "
                           "differences from K1")
    return ties, others


def measure(dev, comps, device, bodies=BODIES, any_hit=False, blocks=5,
            warmup_s=common.WARMUP_S, rows=None):
    """Each body in turns with K1 on these rays: {body: {"ms", "k1_ms",
    "mrays", "ratio", "differences" (from K1's hits), "stats"
    (common.pop_stats), "bound" (ms, what binds), "share"}}. rows: {body:
    (node rows, Tri rows) its plain version read}, where a caller has
    them (else common.rows_read counts them)."""
    n = comps[4].shape[0]

    def k1():
        return call(dev, comps, None, any_hit)
    res = {}
    for i, (name, body) in enumerate(bodies.items()):
        k1_ms, ms, ref, out = common.in_turns(
            k1, lambda body=body: call(dev, comps, body, any_hit), device,
            blocks, warmup_s if i == 0 else 0.0)
        s = common.pop_stats(call(dev, comps, body, any_hit, True))
        read = (rows[name] if rows and name in rows else
                common.rows_read(dev, comps, any_hit, ct=body))
        bound = common.bound_ms(dev, n, s["node"], s["leaf"], read, any_hit,
                                select=body and body["select"])
        res[name] = {"ms": ms, "k1_ms": k1_ms, "mrays": n / ms / 1e3,
                     "ratio": ms / k1_ms,
                     "differences": differences(out, ref, any_hit, name),
                     "stats": s, "bound": bound, "share": bound[0] / ms}
    return res


def measure_pf(dev, comps, device, bodies=VARIANTS, any_hit=False, blocks=5,
               warmup_s=common.WARMUP_S, rows=None):
    """K7-PF on these rays, each of `bodies` (K7 variants) with the
    prefetch: in turns with K7 (the same body without it: K7, K7-PF, K7-PF,
    K7), then in turns with K2 (K2, K7-PF, K7-PF, K2). Raises unless
    K7-PF's hits equal K7's bit for bit. {name: {"ms" (K7-PF, the mean of
    its four turns), "k7_ms", "ratio_k7" (K7-PF over K7 in their turns),
    "k2_ms", "ratio_k2", "differences" (from K2's hits, which are K1's),
    "stats" (common.pop_stats of K7's counters), "bound", "share"}}. rows
    as in measure()."""
    n = comps[4].shape[0]

    def k2():
        return packet.traverse_packet_components(dev, *comps, any_hit=any_hit,
                                                 prefetch=True)
    res = {}
    for i, (name, body) in enumerate(bodies.items()):
        pf_body = dict(body, prefetch=True)

        def k7(body=body):
            return call(dev, comps, body, any_hit)

        def pf(body=pf_body):
            return call(dev, comps, body, any_hit)
        k7_ms, pf1, k7_out, pf_out = common.in_turns(
            k7, pf, device, blocks, warmup_s if i == 0 else 0.0)
        for key in ("t", "u", "v", "prim_id", "geom_id"):
            if not torch.equal(pf_out[key], k7_out[key]):
                raise RuntimeError(f"{name}: K7-PF's {key} differs from K7's")
        k2_ms, pf2, k2_out, _ = common.in_turns(k2, pf, device, blocks)
        s = common.pop_stats(call(dev, comps, body, any_hit, True))
        read = (rows[name] if rows and name in rows else
                common.rows_read(dev, comps, any_hit, ct=body))
        bound = common.bound_ms(dev, n, s["node"], s["leaf"], read, any_hit,
                                select=body["select"])
        ms = (pf1 + pf2) / 2
        res[name] = {"ms": ms, "k7_ms": k7_ms, "ratio_k7": pf1 / k7_ms,
                     "k2_ms": k2_ms, "ratio_k2": pf2 / k2_ms,
                     "differences": differences(pf_out, k2_out, any_hit,
                                                name),
                     "stats": s, "bound": bound, "share": bound[0] / ms}
    return res


def measure_against(dev, comps, device, libs, bodies=VARIANTS,
                    any_hit=False, prefetch=False, blocks=5,
                    warmup_s=common.WARMUP_S):
    """Other checkouts' K7 (libs: {root: library}; K7-PF with prefetch)
    each in turns with this one's on these rays (other, this, this, other),
    each of `bodies`. Raises unless each returns this body's hits bit for
    bit, and (K7) the same pops and leaf pops from their counting
    instantiations. {name: {"stats" (common.pop_stats of this body's
    counters), "bound", root: {"ms" (this body), "other_ms", "ratio"
    (this over the other), "share" (of the bound, this body)}}}."""
    n = comps[4].shape[0]
    res = {}
    for i, (name, body) in enumerate(bodies.items()):
        run = dict(body, prefetch=True) if prefetch else body
        counted = call(dev, comps, body, any_hit, True)
        s = common.pop_stats(counted)
        read = common.rows_read(dev, comps, any_hit, ct=body)
        bound = common.bound_ms(dev, n, s["node"], s["leaf"], read, any_hit,
                                select=body["select"])
        res[name] = {"stats": s, "bound": bound}
        others = {root: (lambda run=run, lib=lib:
                         call(dev, comps, run, any_hit, lib=lib))
                  for root, lib in libs.items()}
        turns = common.against(lambda run=run: call(dev, comps, run, any_hit),
                               others, device, blocks,
                               warmup_s if i == 0 else 0.0, what=name)
        for root, lib in libs.items():
            if not prefetch:
                common.same_outputs(
                    counted, call(dev, comps, body, any_hit, True, lib),
                    f"{name}: {root}'s")
            res[name][root] = dict(turns[root],
                                   share=bound[0] / turns[root]["ms"])
    return res


def report_against(name, r, root):
    s, a = r["stats"], r[root]
    return (f"{name:17s} {a['ms']:.4f} ms; {root} in turns "
            f"{a['other_ms']:.4f} ms: {a['ratio']:.4f}x; pops/ray "
            f"{s['pops_ray']:.4f} (leaf {s['leaf_ray']:.4f}); bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), {a['share']:.1%} of "
            "it")


def run_against(device, roots, prefetch=False, blocks=5, tris=None,
                side=1024):
    """The checkouts at roots each against this one (measure_against) on
    AGAINST's distributions, or K7-PF on powerplant's PF_DISTS with
    prefetch, printed; returns {(scene, kind): measure_against's
    result}."""
    print(f"card: {common.card(device)}", flush=True)
    libs = common.against_libraries("ct", roots)
    plan = ((("powerplant", common.TRI24, PF_DISTS),) if prefetch
            else AGAINST)
    out, first = {}, True
    for scene, cfg, kinds in plan:
        verts, idx, dev, secs = common.load(scene, cfg, device, tris)
        print(common.scene_line(scene, idx, dev, secs), flush=True)
        dists = common.distributions(scene, verts, idx, dev, side, device,
                                     kinds)
        for kind, (comps, any_hit) in dists.items():
            res = measure_against(
                dev, comps, device, libs,
                ANY_HIT_VARIANTS if any_hit else VARIANTS, any_hit, prefetch,
                blocks, common.WARMUP_S if first else 0.0)
            first = False
            out[(scene, kind)] = res
            for name, r in res.items():
                for root in roots:
                    print(f"{scene} {kind} ({comps[4].shape[0]} rays) "
                          + report_against(name + ("-pf" if prefetch
                                                   else ""), r, root),
                          flush=True)
    return out


def report_pf(name, r):
    s = r["stats"]
    return (f"{name + '-pf':17s} {r['ms']:.4f} ms; K7 in turns "
            f"{r['k7_ms']:.4f} ms: {r['ratio_k7']:.4f}x; K2 in turns "
            f"{r['k2_ms']:.4f} ms: {r['ratio_k2']:.4f}x; pops/ray "
            f"{s['pops_ray']:.4f} (leaf {s['leaf_ray']:.4f}); hits other "
            f"than K2's: {r['differences'][0]} ties, {r['differences'][1]} "
            f"others; bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"{r['share']:.1%} of it")


def report(name, r):
    s = r["stats"]
    return (f"{name:14s} {r['ms']:.4f} ms = {r['mrays']:.2f} Mrays/s; K1 in "
            f"turns {r['k1_ms']:.4f} ms: {r['ratio']:.4f}x; pops/ray "
            f"{s['pops_ray']:.4f} (leaf {s['leaf_ray']:.4f}), warp-max "
            f"{s['warp_pops']:.3f}; hits other than K1's: "
            f"{r['differences'][0]} ties, {r['differences'][1]} others; bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"{r['share']:.1%} of it")


def run(device, blocks=5, tris=None, side=1024):
    """The four bodies on hall's sorted primaries, printed; returns
    measure()'s result."""
    print(f"card: {common.card(device)}", flush=True)
    verts, idx, dev, secs = common.load("hall", common.TRI8, device, tris)
    comps, _ = common.distributions("hall", verts, idx, dev, side, device,
                                    ("primary",))["primary"]
    print(f"hall: {len(idx) // 4} tris, {dev['nodes'].shape[0]} BVH8 nodes, "
          f"{dev['tris'].shape[0]} Tri8 rows (built in {secs:.1f} s); "
          f"{comps[4].shape[0]} sorted primaries", flush=True)
    res = measure(dev, comps, device, blocks=blocks)
    for name, r in res.items():
        print(report(name, r), flush=True)
    return res


def run_pf(device, blocks=5, tris=None, side=1024):
    """K7-PF on powerplant's distributions (PF_DISTS), printed; returns
    {kind: measure_pf's result}."""
    print(f"card: {common.card(device)}", flush=True)
    verts, idx, dev, secs = common.load("powerplant", common.TRI24, device,
                                        tris)
    print(common.scene_line("powerplant", idx, dev, secs), flush=True)
    dists = common.distributions("powerplant", verts, idx, dev, side, device,
                                 PF_DISTS)
    out = {}
    for i, (kind, (comps, any_hit)) in enumerate(dists.items()):
        out[kind] = measure_pf(dev, comps, device,
                               ANY_HIT_VARIANTS if any_hit else VARIANTS,
                               any_hit, blocks,
                               common.WARMUP_S if i == 0 else 0.0)
        for name, r in out[kind].items():
            print(f"{kind} ({comps[4].shape[0]} sorted rays) "
                  f"{report_pf(name, r)}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="measure_ct")
    p.add_argument("--tris", type=int, default=None,
                   help="the scenes' size (default: hall 260,000, "
                   "powerplant 5,000,000)")
    p.add_argument("--side", type=int, default=1024,
                   help="side x side rays")
    p.add_argument("--prefetch", action="store_true",
                   help="K7-PF against K7 and K2 on powerplant")
    p.add_argument("--against", nargs="+", metavar="DIR",
                   help="the roots of other checkouts whose K7 body "
                   "(K7-PF with --prefetch) is timed against this one's")
    common.add_args(p)
    args = p.parse_args(argv)
    if args.against and args.cpu:
        p.error("--against times two builds of a CUDA kernel: it needs the "
                "card")
    device = common.device_of(args, "measure_ct")
    if args.against:
        run_against(device, args.against, args.prefetch, args.blocks,
                    args.tris, args.side)
    elif args.prefetch:
        run_pf(device, args.blocks, args.tris, args.side)
    else:
        run(device, args.blocks, args.tris, args.side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
