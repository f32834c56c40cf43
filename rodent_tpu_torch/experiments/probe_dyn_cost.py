"""The cost of a dynamically indexed tile load in a dependent loop, and
whether asynchronous copies in flight overlap (port of
experiments/probe_dyn_cost.py, which asked that of VMEM loads and DMA on
the TPU).

N_IT = 2000 iterations add (8, 128) tiles of a (4096, 128) float32 table
(arange * 1e-9: 2 MB, which stays in the card's L2) to an (8, 128)
accumulator; each tile's row depends on int(acc[0, 0]). Bodies:
  static: tab[0:8] every iteration (kept in the loop by a volatile load);
  dyn1, dyn4: one, or four (64 rows apart), tiles at the index;
  dynrow1: one row broadcast over the 8 rows;
  async4: dyn4's tiles as four bulk copies in flight at once
      (cp.async.bulk global -> shared on one mbarrier, the TMA's bulk
      form), the counterpart of make_async_copy with DMA semaphores.
Each runs at two launch shapes: one copy (one block of 256 threads, the
TPU's one program) and as many copies as fill the card. On main's table
int(acc[0, 0]) stays 0, so check() also holds every body against the
plain version on moving()'s seeded table, on which the index moves.

The card's body (csrc/probes.cu, dyn_cost_kernel): only acc[0, 0] is on
the chain, and each warp keeps its own copy of it from column 0 of the
tiles' first rows, so no block barrier passes it on (loop_barriers: none
in the kernel's loops); each warp loads a tile as soon as the chain gives
its row, into a ring of iterations in flight (async4: shared-memory
stages, an mbarrier each), and adds it while the chain runs ahead.

On a CUDA tensor run() launches the body's kernel; on a CPU tensor it
takes the plain version.

Usage: python -m rodent_tpu_torch.experiments.probe_dyn_cost [--cpu]
    [--blocks 3] [--against DIR [DIR ...]]
--against times this tree's body against each other checkout's (its
rodent_tpu_torch/csrc/probes.cu, built under common.AGAINST_BUILD) in
turns at one copy, at the other's full shape and at this one's, every
output bit for bit equal; it needs the card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import common

N_IT, TAB = 2000, 4096
# body -> the line experiments/probe_dyn_cost.py:88-94 prints
BODIES = {"static": "static (8,128) load", "dyn1": "dyn (8,128) load x1",
          "dyn4": "dyn (8,128) load x4", "dynrow1": "dyn (1,128) load x1",
          "async4": "async copy x4 overlap"}
HEAD = "async4"
launches = 0


def inputs(device="cpu"):
    """main's table (:87): arange(4096 * 128) * 1e-9, float32."""
    tab = np.arange(TAB * 128, dtype=np.float32).reshape(TAB, 128)
    return torch.from_numpy(tab * np.float32(1e-9)).to(device)


def moving(device="cpu", seed=0):
    """A table on which the index moves, for the checks: on main's table
    acc[0, 0] stays below 1, so int(acc[0, 0]) is 0 in every iteration.
    Uniform in [-1, 1) from `seed`, but column 0 in [0, 600), so that
    int(acc[0, 0]) % 64 (% 512) takes most of its values over the 2,000
    iterations, and acc[0, 0] adds non-integer words in the chain's
    order."""
    rng = np.random.default_rng(seed)
    tab = rng.uniform(-1.0, 1.0, (TAB, 128)).astype(np.float32)
    tab[:, 0] = rng.uniform(0.0, 600.0, TAB).astype(np.float32)
    return torch.from_numpy(tab).to(device)


def plain(body, tab):
    """The (8, 128) accumulator of make's loop (:28-42) with the body's
    tiles (:45-83); async4 adds dyn4's tiles in the same order."""
    acc = torch.zeros(8, 128, dtype=torch.float32, device=tab.device)
    for i in range(N_IT):
        if body == "static":
            acc = acc + tab[0:8]
            continue
        a00 = int(acc[0, 0])
        if body == "dynrow1":
            idx = a00 % 512 + i % 64
            acc = acc + tab[idx:idx + 1]
            continue
        idx = a00 % 64 + i % 64
        acc = acc + tab[idx * 8:idx * 8 + 8]
        if body != "dyn1":
            for s in (1, 2, 3):
                acc = acc + tab[idx * 8 + 64 * s:idx * 8 + 64 * s + 8]
    return acc


def launch(lib, body, tab, copies):
    """rt_probe_dyn_cost of the probes library lib (None: this tree's) on
    `copies` copies, on the current stream: (copies, 8, 128)."""
    out = torch.empty(copies, 8, 128, dtype=torch.float32, device=tab.device)
    common.probe_call("rt_probe_dyn_cost", list(BODIES).index(body),
                      tab.data_ptr(), out.data_ptr(), copies, lib=lib)
    return out


def run(body, tab, copies=1):
    """(copies, 8, 128): the kernel on a CUDA table, the plain version on a
    CPU one."""
    global launches
    if tab.device.type == "cpu":
        return plain(body, tab)[None].expand(copies, 8, 128)
    if (tab.device.type != "cuda" or tab.dtype != torch.float32
            or tuple(tab.shape) != (TAB, 128) or not tab.is_contiguous()):
        raise ValueError("probe_dyn_cost takes a contiguous (4096, 128) "
                         f"float32 CUDA table, not {tab.dtype} "
                         f"{tuple(tab.shape)} on {tab.device}")
    out = launch(None, body, tab, copies)
    launches += 1
    return out


def bound(body, copies):
    """The full launch's bound: 1,024 float adds per tile added per
    iteration; the table read once and the outputs written."""
    tiles = 4 if body in ("dyn4", "async4") else 1
    return common.probe_bound_ms(1024 * tiles * N_IT * copies,
                                 TAB * 512 + copies * 4096)


def measure(device, blocks=3):
    """Every body at both launch shapes: {body: common.probe_shapes()'s
    keys, "bound", "iters"}."""
    res, tab = {}, inputs(device)
    for body in BODIES:
        if device.type == "cuda":
            full, per_sm = common.full_copies("dyn_cost",
                                              list(BODIES).index(body))
        else:
            full, per_sm = 1, 1.0
        r = common.probe_shapes(lambda c: run(body, tab, c), device, full,
                                per_sm, N_IT, blocks)
        r.update(bound=bound(body, full), iters=N_IT)
        res[body] = r
    return res


def check(res):
    """{body: True where both shapes' every copy equals the plain version
    bit for bit, on main's table (the measured outputs) and on moving()'s,
    run here at one copy and at the full shape's copies}."""
    device = next(iter(res.values()))["out"].device
    tab, tab2 = inputs(device), moving(device)
    ok = {}
    for body, r in res.items():
        want, want2 = plain(body, tab), plain(body, tab2)
        ok[body] = all(bool(torch.equal(o, w.expand_as(o))) for o, w in (
            (r["out1"], want), (r["out"], want),
            (run(body, tab2, 1), want2),
            (run(body, tab2, r["copies"]), want2)))
    return ok


def loop_barriers(fn):
    """The BAR.SYNC instructions inside any loop of a dyn_cost_kernel (fn:
    its common.Sass): between a backward branch's target and the branch.
    The kernel takes none: each warp keeps its own acc[0, 0]."""
    spans = common.loops(fn)
    return sum(1 for a, text, _ in fn.insns
               if any(t <= a <= b for t, b in spans)
               and common.opcode(text, full=True).startswith("BAR.SYNC"))


def resources(lib_path=None, funcs=None):
    """{body: {"regs", "spills" (bytes stored and loaded), "barriers"
    (loop_barriers)}} of every dyn_cost_kernel of a probes library (this
    tree's by default; common.probe_kernels); funcs: the library's
    common.read_sass, where the caller has read it."""
    names = list(BODIES)
    return {names[b]: {"regs": r["regs"], "spills": r["spills"],
                       "barriers": loop_barriers(r["sass"])}
            for b, r in common.probe_kernels(r"dyn_cost_kernelILi(\d+)EE",
                                             lib_path, funcs).items()}


def against(device, roots, blocks=3):
    """Every body in turns with each other checkout's
    (common.probe_against), every output bit for bit the other's and the
    plain version's. {body: {(root, copies): {"ms", "other_ms",
    "ratio"}}}."""
    tab = inputs(device)
    want = {body: plain(body, tab) for body in BODIES}
    return common.probe_against(
        "dyn_cost", list(BODIES), list(BODIES).index,
        lambda body, c: {"out": run(body, tab, c)},
        lambda lib, body, c: {"out": launch(lib, body, tab, c)},
        lambda body, out: bool(torch.equal(
            out["out"], want[body].expand_as(out["out"]))),
        device, roots, blocks)


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_dyn_cost")
    common.add_args(p)
    p.add_argument("--against", nargs="+", metavar="DIR",
                   help="the roots of other checkouts whose body is timed "
                   "against this one's, every body")
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    if args.cpu and args.against:
        p.error("--against times builds of a CUDA kernel: it needs the "
                "card")
    device = common.device_of(args, "probe_dyn_cost")
    print(f"card: {common.card(device)}", flush=True)
    if args.against:
        libs = {"this tree": None} | {root: common.other_library(
            root, "probes")._name for root in args.against}
        for label, path in libs.items():
            print(f"{label}: " + ", ".join(
                f"{body} {r['regs']} registers, spills {r['spills']}, "
                f"{r['barriers']} BAR.SYNC in loops"
                for body, r in resources(path).items()), flush=True)
        for body, by in against(device, args.against, args.blocks).items():
            print(f"{BODIES[body]:>24}: " + "; ".join(
                f"{root} {c} copies in turns: {r['other_ms']:.4f} -> "
                f"{r['ms']:.4f} ms ({r['ratio']:.4f}x)"
                for (root, c), r in by.items()) + "; equal bit for bit",
                flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    for body, r in res.items():
        print(f"{BODIES[body]:>24}: {r['ns1']:8.1f} ns/iter; "
              f"{r['ns_sm']:.2f} ns/iter per SM with {r['copies']} copies; "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
              f"{r['ms']:.4f} ms, {r['bound'][0] / r['ms']:.1%} of it; "
              f"{'OK' if ok[body] else 'WRONG'}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
