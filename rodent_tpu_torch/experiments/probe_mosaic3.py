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
Each mode runs at two launch shapes: one copy (one block of 1,024 threads,
8 of the 8,192 values each: the TPU's one program) and as many copies as
fill the card. The table is arange for the first three modes and a
permutation in column 0 for the dep- modes (default_rng(0), :103-106).

On a CUDA tensor run() launches the mode's kernel (csrc/probes.cu); on a
CPU tensor it takes the plain version. Nothing runs at import.

Usage: python -m rodent_tpu_torch.experiments.probe_mosaic3 [--cpu]
    [--blocks 3]
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
    out = torch.empty(copies, R, 128, dtype=torch.float32, device=tab.device)
    common.probe_call("rt_probe_mosaic3", MODES.index(mode), tab.data_ptr(),
                      out.data_ptr(), copies)
    launches += 1
    return out


def bound(mode, copies):
    """The full launch's bound: 8,192 float adds per word (one for none)
    per iteration; the table read once and the outputs written."""
    ops = (1 if mode == "none" else K) * R * 128 * N * copies
    return common.probe_bound_ms(ops, NN * 512 + copies * R * 512)


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


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_mosaic3")
    common.add_args(p)
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    device = common.device_of(args, "probe_mosaic3")
    print(f"card: {common.card(device)}", flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    for mode, r in res.items():
        dep = ", dependent chase" if mode.startswith("dep") else ""
        print(f"{mode:>12}: {r['ns1']:7.1f} ns/iter ({K} lane reads{dep}); "
              f"{r['ns_sm']:.2f} ns/iter per SM with {r['copies']} copies; "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
              f"{r['ms']:.4f} ms; {'OK' if ok[mode] else 'WRONG'}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
