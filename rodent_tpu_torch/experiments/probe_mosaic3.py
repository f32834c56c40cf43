"""The cost of getting words of one table row to every thread (port of
experiments/probe_mosaic3.py, which asked what a lane extracted from a
loaded VMEM row costs the TPU against a lane kept as a vector).

N = 4096 iterations each add K = 24 words of one row of a (1024, 128)
float32 table (lanes j * 5 % 128) to a (64, 128) accumulator. Modes:
  none: + 1.0, no row;
  extract: every thread loads each word itself (K1's per-field __ldg);
  slice: each warp loads the row once with 16-byte loads and passes the
      words on by __shfl_sync (K4's row_loads);
  dep-extract, dep-slice: the same, the next row being the int32 bits of
      lane 0 of this one (a permutation: a pop's dependent chase).
Each mode runs at two launch shapes: one copy (one block: the TPU's one
program) and as many copies as fill the card. The table is arange for the
first three modes and a permutation in column 0 for the dep- modes
(default_rng(0), :103-106).

The card's body (csrc/probes.cu, mosaic3_kernel) is a block of 256
threads a copy, 32 of the 8,192 values each, so that each word loaded or
shuffled feeds 32 float adds; the next row's loads are issued before this
row's adds. With -fmad=false the adds are FADDs, one per lane and cycle:
issue_ms() is that rate's time, half the published-peak bound of bound().

On a CUDA tensor run() launches the mode's kernel; on a CPU tensor it
takes the plain version. Nothing runs at import.

Usage: python -m rodent_tpu_torch.experiments.probe_mosaic3 [--cpu]
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

R, K, N, NN = 64, 24, 4096, 1024
MODES = ("none", "extract", "slice", "dep-extract", "dep-slice")
HEAD = "extract"
LANES = [j * 5 % 128 for j in range(K)]
launches = 0


def inputs(mode, device="cpu"):
    """run's arange table (:55) or run2's permutation table (:103-106)."""
    if mode.startswith("dep"):
        perm = np.random.default_rng(0).permutation(NN).astype(np.int32)
        tab = np.zeros((NN, 128), np.float32)
        tab[:, 0] = perm.view(np.float32)
    else:
        tab = np.arange(NN * 128, dtype=np.float32).reshape(NN, 128)
    return torch.from_numpy(tab).to(device)


def rows_visited(mode, tab):
    """The row of each iteration: (i * 7 + 3) % 1024, or the chase."""
    if not mode.startswith("dep"):
        return [(i * 7 + 3) % NN for i in range(N)]
    col0 = tab[:, 0].contiguous().view(torch.int32).tolist()
    rows, idx = [], 0
    for _ in range(N):
        rows.append(idx)
        idx = col0[idx]
    return rows


def plain(mode, tab):
    """The (64, 128) accumulator of _kernel (:28-51) or _kernel2 (:78-98).
    Every element takes the same adds, so one float32 is stepped through
    them in the JAX body's order and broadcast."""
    acc = torch.zeros(1, dtype=torch.float32, device=tab.device)
    if mode == "none":
        for _ in range(N):
            acc = acc + 1.0
    else:
        idx = torch.tensor(rows_visited(mode, tab), device=tab.device)
        vals = tab[idx][:, LANES]
        for i in range(N):
            for j in range(K):
                acc = acc + vals[i, j]
    return acc.expand(R, 128).contiguous()


def launch(lib, mode, tab, copies):
    """rt_probe_mosaic3 of the probes library lib (None: this tree's) on
    `copies` copies, on the current stream: (copies, 64, 128)."""
    out = torch.empty(copies, R, 128, dtype=torch.float32, device=tab.device)
    common.probe_call("rt_probe_mosaic3", MODES.index(mode), tab.data_ptr(),
                      out.data_ptr(), copies, lib=lib)
    return out


def run(mode, tab, copies=1):
    """(copies, 64, 128): the kernel on a CUDA table, the plain version on
    a CPU one."""
    global launches
    if tab.device.type == "cpu":
        return plain(mode, tab)[None].expand(copies, R, 128)
    if (tab.device.type != "cuda" or tab.dtype != torch.float32
            or tuple(tab.shape) != (NN, 128) or not tab.is_contiguous()):
        raise ValueError("probe_mosaic3 takes a contiguous (1024, 128) "
                         f"float32 CUDA table, not {tab.dtype} "
                         f"{tuple(tab.shape)} on {tab.device}")
    out = launch(None, mode, tab, copies)
    launches += 1
    return out


def adds(mode):
    """One copy's float adds: 8,192 per word (one for none) and
    iteration, whatever the threads a copy."""
    return (1 if mode == "none" else K) * R * 128 * N


def bound(mode, copies):
    """The full launch's bound: adds() of every copy against the published
    float32 peak; the table read once and the outputs written."""
    return common.probe_bound_ms(adds(mode) * copies,
                                 NN * 512 + copies * R * 512)


def issue_ms(mode, copies, sms, mhz):
    """The least time the launch's adds take at one FADD per lane and
    cycle (128 lanes an SM at mhz), the copies spread over `sms` SMs in
    whole waves: half of bound()'s operations time, where the published
    peak counts an FMA as two operations."""
    return -(-copies // sms) * adds(mode) / (128 * mhz * 1e6) * 1e3


def resources(lib_path=None, funcs=None):
    """{mode: {"regs", "spills" (bytes stored and loaded)}} of every
    mosaic3_kernel of a probes library (this tree's by default;
    common.probe_kernels)."""
    return {MODES[m]: {"regs": r["regs"], "spills": r["spills"]}
            for m, r in common.probe_kernels(r"mosaic3_kernelILi(\d+)EE",
                                             lib_path, funcs).items()}


def against(device, roots, blocks=3):
    """Every mode in turns with each other checkout's body
    (common.probe_against), every output bit for bit the other's and the
    plain version's. {mode: {(root, copies): {"ms", "other_ms",
    "ratio"}}}."""
    tabs = {mode: inputs(mode, device) for mode in MODES}
    want = {mode: plain(mode, tab) for mode, tab in tabs.items()}
    return common.probe_against(
        "mosaic3", MODES, MODES.index,
        lambda mode, c: {"out": run(mode, tabs[mode], c)},
        lambda lib, mode, c: {"out": launch(lib, mode, tabs[mode], c)},
        lambda mode, out: bool(torch.equal(
            out["out"], want[mode].expand_as(out["out"]))),
        device, roots, blocks)


def measure(device, blocks=3):
    """Every mode at both launch shapes: {mode: common.probe_shapes()'s
    keys, "bound", "iters"}."""
    res = {}
    for mode in MODES:
        tab = inputs(mode, device)
        if device.type == "cuda":
            full, per_sm = common.full_copies("mosaic3", MODES.index(mode))
        else:
            full, per_sm = 1, 1.0
        r = common.probe_shapes(lambda c: run(mode, tab, c), device, full,
                                per_sm, N, blocks)
        r.update(bound=bound(mode, full), iters=N)
        res[mode] = r
    return res


def check(res):
    """{mode: True where both shapes' every copy equals the plain
    version bit for bit}."""
    device = next(iter(res.values()))["out"].device
    ok = {}
    for mode, r in res.items():
        want = plain(mode, inputs(mode, device))
        ok[mode] = all(bool(torch.equal(o, want.expand_as(o)))
                       for o in (r["out1"], r["out"]))
    return ok


def report(mode, r, clock=None):
    """A mode's line: both shapes' times and the share of the bound; on a
    card (clock: its SMs and SM MHz) also of the FADD issue rate
    (issue_ms) at the full shape."""
    dep = ", dependent chase" if mode.startswith("dep") else ""
    line = (f"{mode:>12}: {r['ns1']:7.1f} ns/iter ({K} lane reads{dep}); "
            f"{r['ns_sm']:.2f} ns/iter per SM with {r['copies']} copies; "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"{r['ms']:.4f} ms, {r['bound'][0] / r['ms']:.1%} of it")
    if clock:
        issue = issue_ms(mode, r["copies"], *clock)
        line += (f", {issue / r['ms']:.1%} of the FADD issue rate at "
                 f"{clock[1]:g} MHz")
    return line


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_mosaic3")
    common.add_args(p)
    p.add_argument("--against", nargs="+", metavar="DIR",
                   help="the roots of other checkouts whose body is timed "
                   "against this one's, every mode")
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    if args.cpu and args.against:
        p.error("--against times builds of a CUDA kernel: it needs the "
                "card")
    device = common.device_of(args, "probe_mosaic3")
    print(f"card: {common.card(device)}", flush=True)
    if args.against:
        libs = {"this tree": None} | {root: common.other_library(
            root, "probes")._name for root in args.against}
        for label, path in libs.items():
            print(f"{label}: " + ", ".join(
                f"{mode} {r['regs']} registers, spills {r['spills']}"
                for mode, r in resources(path).items()), flush=True)
        for mode, by in against(device, args.against, args.blocks).items():
            print(f"{mode:>12}: " + "; ".join(
                f"{root} {c} copies in turns: {r['other_ms']:.4f} -> "
                f"{r['ms']:.4f} ms ({r['ratio']:.4f}x)"
                for (root, c), r in by.items()) + "; equal bit for bit",
                flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    clock = (torch.cuda.get_device_properties(device).multi_processor_count,
             common.sm_clock_mhz()[1]) if device.type == "cuda" else None
    for mode, r in res.items():
        print(f"{report(mode, r, clock)}; {'OK' if ok[mode] else 'WRONG'}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
