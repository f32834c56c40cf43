"""Per-element gathers from a table held on chip (port of
experiments/probe_gather.py, which asked whether a TPU lane gather is fast
enough for a traversal in which each ray fetches its own node's fields
from 128-node pages).

The question for the card: does a ray fetch its fields faster from a page
held in shared memory than from global memory through __ldg, as K1 does?
The timed cases run both ways where the table fits a block's 227 KB of
shared memory (the dependent chain, the 56-field block, 1 and 2 pages of
28 fields) and through global memory alone where it does not (4 and 8
pages); each line says which.

Cases, with the JAX file's inputs (RandomState(0) and RandomState(1)):
  axis1, axis0: take_along_axis of an arange table at (8|16|32, 128) and
      (8|64|512, 128), float32 (:38-57); i32: int32 at (8, 128) (:60-75);
      its kernel runs on a grid over the card, one thread per four
      elements; TAKE adds rows 4,096 and 65,536 at both axes, where it is
      timed against torch.gather (take_cases, take_bound);
  chain: K = 2048 dependent int32 lane gathers (:89-108);
  fields: 56 fields of an (8, 128) block per iteration, 256 iterations
      (:110-130);
  pages1..pages8: P pages of 28 fields (:133-162).
The timed cases run at two launch shapes: one copy (one block, 1,024
elements: the TPU's one program) and as many copies as fill the card.
They start from the JAX file's indices, zeros, on which every lane of a
row carries one index; check() also runs each on moving()'s seeded
indices, which differ lane by lane, so that a body that mixed up lanes
would show.

The card's timed body (csrc/probes.cu, gather_kernel) holds 1024 /
threads elements a thread, 256 threads a copy for the chain in shared
memory, 512 for the other shared-memory bodies and 1,024 for the global
ones; its shared-memory copy of the table is word-major, a word's fields
loaded 16 bytes at a time. With -fmad=false
each field is one FADD: issue_ms() is the time of the adds at one a lane
and cycle (of the chain's two integer operations a step).

On a CUDA tensor run() launches the case's kernel (csrc/probes.cu); on a
CPU tensor it takes the plain version.

Usage: python -m rodent_tpu_torch.experiments.probe_gather [--cpu]
    [--blocks 3] [--against DIR [DIR ...]]
--against times this tree's timed bodies against each other checkout's
(its rodent_tpu_torch/csrc/probes.cu, built under common.AGAINST_BUILD) in
turns at one copy, at the other's full shape and at this one's, every
output bit for bit equal; it needs the card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import common

CORRECT = [((8, 128), 1), ((16, 128), 1), ((32, 128), 1),
           ((8, 128), 0), ((64, 128), 0), ((512, 128), 0)]
K_CHAIN, ITERS, F56, F28 = 2048, 256, 56, 28
PAGES = (1, 2, 4, 8)
# timed case -> (body number in csrc/probes.cu, pages, dependent steps)
TIMED = {"chain": (1, 0, K_CHAIN), "fields": (2, 0, ITERS),
         **{f"pages{p}": (3, p, ITERS) for p in PAGES}}
# the take_along_axis cases timed against torch.gather: CORRECT's, then
# the same inputs at 4,096 and 65,536 rows
TAKE = CORRECT + [((r, 128), a) for r in (4096, 65536) for a in (0, 1)]
HEAD = "fields shared"
SHARED_MAX = 232_448             # bytes of shared memory a block may have
launches = 0                     # every kernel launch of this module
take_launches = 0                # those of run_take's kernel


def correct_inputs(shape, axis):
    """probe_correct's table and indices (:41-43)."""
    tbl = np.arange(shape[0] * shape[1], dtype=np.float32).reshape(shape)
    idx = np.random.RandomState(0).randint(0, shape[axis], shape)
    return tbl, idx.astype(np.int32)


def i32_inputs():
    """probe_i32's (:62-63)."""
    tbl = np.arange(1024, dtype=np.int32).reshape(8, 128)
    idx = np.random.RandomState(1).randint(0, 128, (8, 128))
    return tbl, idx.astype(np.int32)


def take_cases():
    """[(name, table, indices, axis)] of every timed take_along_axis
    case: TAKE's float32 arange tables (correct_inputs) and the int32
    (8, 128) one."""
    cases = [(f"axis{a} {s}", *correct_inputs(s, a), a) for s, a in TAKE]
    return cases + [("i32 (8, 128)", *i32_inputs(), 1)]


def take_bound(rows):
    """The least time of a take_along_axis over (rows, 128) 32-bit words:
    the table and int32 indices read once, the output written once."""
    return common.probe_bound_ms(0, 3 * rows * 128 * 4)


def timed_inputs(case):
    """The table and start indices of a timed case (:101-102, :123-124,
    :155-157)."""
    idx = np.zeros((8, 128), np.int32)
    if case == "chain":
        return (np.random.RandomState(0).randint(0, 128, (8, 128))
                .astype(np.int32), idx)
    if case == "fields":
        return np.random.RandomState(0).rand(F56, 8, 128).astype(
            np.float32), idx
    p = TIMED[case][1]
    return np.random.RandomState(0).rand(F28, p, 8, 128).astype(
        np.float32), idx


def moving(case, seed=0):
    """Start indices for the checks that differ lane by lane: seeded,
    uniform in [0, 128), or [0, P * 128) for P pages (timed_inputs' are
    zeros, on which a row's 128 lanes carry one index throughout)."""
    hi = 128 * max(TIMED[case][1], 1)
    return np.random.default_rng(seed).integers(
        0, hi, (8, 128)).astype(np.int32)


def table_bytes(case):
    return {"chain": 4096, "fields": F56 * 4096}.get(
        case, F28 * TIMED[case][1] * 4096)


def fits_shared(case):
    return table_bytes(case) <= SHARED_MAX


def plain_take(tbl, idx, axis):
    """take_along_axis (probe_correct, probe_i32)."""
    return torch.take_along_dim(tbl, idx.long(), dim=axis)


def plain_chain(tbl, idx, trace=None):
    """probe_throughput's chain: idx = (tbl[r, idx] + 1) & 127, K times;
    trace: a list that gets each step's indices."""
    for _ in range(K_CHAIN):
        if trace is not None:
            trace.append(idx)
        idx = (torch.take_along_dim(tbl, idx.long(), dim=1) + 1) & 127
    return idx


def _rows(idx):
    return torch.arange(8, device=idx.device)[:, None].expand(8, 128)


def plain_fields(tbl, idx, trace=None):
    """probe_throughput's 56-field block: each iteration adds the 56
    gathered fields in order and moves idx by the sum's integer part;
    trace: a list that gets each iteration's indices."""
    r = _rows(idx)
    for _ in range(ITERS):
        if trace is not None:
            trace.append(idx)
        vals = tbl[:, r, idx.long()]
        acc = torch.zeros(8, 128, dtype=torch.float32, device=idx.device)
        for f in range(F56):
            acc = acc + vals[f]
        idx = (idx + acc.to(torch.int32)) & 127
    return idx


def plain_pages(tbl, idx, trace=None):
    """probe_pages: field f of idx is word idx & 127 of page idx >> 7 (the
    JAX body's chain of where()s over the pages picks that page); trace:
    a list that gets each iteration's indices."""
    p, r = tbl.shape[1], _rows(idx)
    for _ in range(ITERS):
        if trace is not None:
            trace.append(idx)
        vals = tbl[:, (idx >> 7).long(), r, (idx & 127).long()]
        acc = torch.zeros(8, 128, dtype=torch.float32, device=idx.device)
        for f in range(F28):
            acc = acc + vals[f]
        idx = (idx + acc.to(torch.int32)) & (p * 128 - 1)
    return idx


PLAIN = {1: plain_chain, 2: plain_fields, 3: plain_pages}


def _check(x, dtype, shape, what):
    if (x.device.type != "cuda" or x.dtype != dtype
            or tuple(x.shape) != shape or not x.is_contiguous()):
        raise ValueError(f"probe_gather {what}: a contiguous {dtype} "
                         f"{shape} CUDA tensor, not {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def run_take(tbl, idx, axis):
    """take_along_axis through the kernel (a grid over the card) on CUDA
    tensors, the plain version on CPU ones. The indices must lie in the
    axis' range, as torch.gather's must."""
    global launches, take_launches
    if tbl.device.type == "cpu":
        return plain_take(tbl, idx, axis)
    rows = tbl.shape[0] if tbl.dim() == 2 else 0
    _check(tbl, tbl.dtype, (rows, 128), "table")
    if (tbl.dtype not in (torch.float32, torch.int32) or axis not in (0, 1)
            or not 1 <= rows < 1 << 24):
        raise ValueError(f"probe_gather: {tbl.dtype} table of {rows} rows, "
                         f"axis {axis}")
    _check(idx, torch.int32, (rows, 128), "indices")
    if idx.data_ptr() % 16:
        raise ValueError("probe_gather: the indices are read 16 bytes at a "
                         "time and must start on a 16-byte boundary")
    out = torch.empty_like(tbl)
    common.probe_call("rt_probe_gather", 0, tbl.data_ptr(), idx.data_ptr(),
                      out.data_ptr(), rows, axis, 0, 0, 1)
    launches += 1
    take_launches += 1
    return out


def launch(lib, case, tbl, idx, copies, shared):
    """rt_probe_gather's timed body of the probes library lib (None: this
    tree's) on `copies` copies, on the current stream: (copies, 8, 128)."""
    body, pages, _ = TIMED[case]
    out = torch.empty(copies, 8, 128, dtype=torch.int32, device=tbl.device)
    common.probe_call("rt_probe_gather", body, tbl.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), 8, 1, pages,
                      int(shared), copies, lib=lib)
    return out


def run(case, tbl, idx, copies=1, shared=True):
    """A timed case: (copies, 8, 128) int32, every copy the same indices.
    On CUDA tensors the kernel with the table in shared memory (shared,
    where it fits) or read through __ldg; on CPU tensors the plain
    version."""
    global launches
    body, pages, _ = TIMED[case]
    if tbl.device.type == "cpu":
        return PLAIN[body](tbl, idx)[None].expand(copies, 8, 128)
    want = {1: (8, 128), 2: (F56, 8, 128), 3: (F28, pages, 8, 128)}[body]
    _check(tbl, torch.int32 if body == 1 else torch.float32, want, "table")
    _check(idx, torch.int32, (8, 128), "indices")
    if shared and not fits_shared(case):
        raise ValueError(f"probe_gather {case}: {table_bytes(case)} bytes "
                         "do not fit a block's shared memory")
    out = launch(None, case, tbl, idx, copies, shared)
    launches += 1
    return out


def bound(case, copies):
    """The full launch's bound: per element and dependent step, an int
    add and an and (chain), or the float adds of the fields and the three
    int operations that move idx, over the type's peak; the table and
    indices read once and the outputs written."""
    _, _, steps = TIMED[case]
    if case == "chain":
        ops, dtype = 2 * 1024 * steps * copies, "int32"
    else:
        f = F56 if case == "fields" else F28
        ops, dtype = (f + 3) * 1024 * steps * copies, "float32"
    return common.probe_bound_ms(
        ops, table_bytes(case) + 4096 + copies * 4096, dtype)


def ops(case):
    """One copy's operations on the critical resource: FADDs for the
    fields and pages (one a field, element and iteration), the chain's
    add and and a step and element."""
    body, pages, steps = TIMED[case]
    if case == "chain":
        return 2 * 1024 * steps
    return (F56 if case == "fields" else F28) * 1024 * steps


def issue_ms(case, copies, sms, mhz):
    """The least time of the launch's ops() at one a lane and cycle (128
    lanes an SM at mhz), the copies spread over `sms` SMs in whole waves:
    about half of bound()'s operations time, where the published float32
    peak counts an FMA as two operations."""
    return -(-copies // sms) * ops(case) / (128 * mhz * 1e6) * 1e3


def variants(device):
    """(case, shared) of every timed run: shared memory and global memory
    where the table fits, global memory alone where it does not; only the
    plain version on the CPU."""
    if device.type != "cuda":
        return [(c, False) for c in TIMED]
    return [(c, s) for c in TIMED for s in ((True, False) if fits_shared(c)
                                            else (False,))]


def measure(device, blocks=3):
    """The correctness cases once each, then every timed case at both
    launch shapes. Returns {name: result}: correctness results hold "out";
    timed ones common.probe_shapes()'s keys, "memory", "bound" and
    "iters"."""
    res = {}
    for shape, axis in CORRECT:
        tbl, idx = correct_inputs(shape, axis)
        res[f"axis{axis} {shape}"] = {"out": run_take(
            torch.from_numpy(tbl).to(device), torch.from_numpy(idx).to(device),
            axis)}
    tbl, idx = i32_inputs()
    res["i32 (8, 128)"] = {"out": run_take(torch.from_numpy(tbl).to(device),
                                           torch.from_numpy(idx).to(device),
                                           1)}
    for case, shared in variants(device):
        tbl, idx = (torch.from_numpy(a).to(device) for a in
                    timed_inputs(case))
        body, pages, steps = TIMED[case]
        if device.type == "cuda":
            full, per_sm = common.full_copies("gather", body, int(shared),
                                              pages)
        else:
            full, per_sm = 1, 1.0
        r = common.probe_shapes(lambda c: run(case, tbl, idx, c, shared),
                                device, full, per_sm, steps, blocks)
        r.update(memory=("shared" if shared else "global")
                 if device.type == "cuda" else "plain", iters=steps,
                 bound=bound(case, full))
        res[f"{case} {r['memory']}"] = r
    return res


def plain_outputs(device):
    """{name: the plain version's output} of every case of measure()."""
    out = {}
    for shape, axis in CORRECT:
        tbl, idx = correct_inputs(shape, axis)
        out[f"axis{axis} {shape}"] = plain_take(
            torch.from_numpy(tbl).to(device),
            torch.from_numpy(idx).to(device), axis)
    tbl, idx = i32_inputs()
    out["i32 (8, 128)"] = plain_take(torch.from_numpy(tbl).to(device),
                                     torch.from_numpy(idx).to(device), 1)
    for case in TIMED:
        tbl, idx = (torch.from_numpy(a).to(device) for a in
                    timed_inputs(case))
        out[case] = PLAIN[TIMED[case][0]](tbl, idx)
    return out


def check(res):
    """{name: True where every copy's output equals the plain version's
    bit for bit}: the take_along_axis cases on their inputs; each timed
    body at both shapes on the JAX inputs (the measured outputs) and on
    moving()'s indices, run here at one copy and at the full shape's
    copies."""
    device = next(iter(res.values()))["out"].device
    plain = plain_outputs(device)
    ok, moved = {}, {}
    for name, r in res.items():
        if "ms" not in r:
            ok[name] = bool(torch.equal(r["out"], plain[name]))
            continue
        case = name.split(" ")[0]
        tbl = torch.from_numpy(timed_inputs(case)[0]).to(device)
        idx = torch.from_numpy(moving(case)).to(device)
        if case not in moved:
            moved[case] = PLAIN[TIMED[case][0]](tbl, idx)
        pairs = [(r["out1"], plain[case]), (r["out"], plain[case])] + [
            (run(case, tbl, idx, c, r["memory"] == "shared"), moved[case])
            for c in (1, r["copies"])]
        ok[name] = all(bool(torch.equal(o, w.expand_as(o)))
                       for o, w in pairs)
    return ok


# gather_kernel's first template argument -> its timed case
BODY_CASES = {1: "chain", 2: "fields", 3: "pages"}


def resources(lib_path=None, funcs=None):
    """{(case, "shared" or "global"): {"regs", "spills" (bytes stored and
    loaded)}} of every gather_kernel of a probes library (this tree's by
    default; common.probe_kernels; one kernel serves every page count)."""
    return {(BODY_CASES[b], "shared" if m else "global"):
            {"regs": r["regs"], "spills": r["spills"]}
            for (b, m, _), r in common.probe_kernels(
                r"gather_kernelILi(\d+)ELb(\d)ELi(\d+)EE", lib_path,
                funcs).items()}


def against(device, roots, blocks=3):
    """Every timed body (variants()) in turns with each other checkout's
    (common.probe_against), every output bit for bit the other's and the
    plain version's. {(case, shared): {(root, copies): {"ms", "other_ms",
    "ratio"}}}."""
    ins = {case: tuple(torch.from_numpy(a).to(device)
                       for a in timed_inputs(case)) for case in TIMED}
    want = {}

    def plain_of(case):
        if case not in want:
            want[case] = PLAIN[TIMED[case][0]](*ins[case])
        return want[case]

    return common.probe_against(
        "gather", variants(device),
        lambda v: (TIMED[v[0]][0], int(v[1]), TIMED[v[0]][1]),
        lambda v, c: {"out": run(v[0], *ins[v[0]], c, v[1])},
        lambda lib, v, c: {"out": launch(lib, v[0], *ins[v[0]], c, v[1])},
        lambda v, out: bool(torch.equal(
            out["out"], plain_of(v[0]).expand_as(out["out"]))),
        device, roots, blocks)


def report(name, r, clock=None):
    """A timed body's line: both shapes' times and the share of the bound;
    on a card (clock: its SMs and SM MHz) also of the issue rate
    (issue_ms) at the full shape."""
    line = (f"{name}: {r['ns1']:.1f} ns/iter one copy (1024 rays); "
            f"{r['ns_sm']:.2f} ns/iter per SM with {r['copies']} copies; "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"{r['ms']:.4f} ms, {r['bound'][0] / r['ms']:.1%} of it")
    if clock:
        issue = issue_ms(name.split(" ")[0], r["copies"], *clock)
        line += f", {issue / r['ms']:.1%} of the issue rate"
    return line


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_gather")
    common.add_args(p)
    p.add_argument("--against", nargs="+", metavar="DIR",
                   help="the roots of other checkouts whose timed bodies "
                   "are timed against this one's")
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    if args.cpu and args.against:
        p.error("--against times builds of a CUDA kernel: it needs the "
                "card")
    device = common.device_of(args, "probe_gather")
    print(f"card: {common.card(device)}", flush=True)
    if args.against:
        libs = {"this tree": None} | {root: common.other_library(
            root, "probes")._name for root in args.against}
        for label, path in libs.items():
            print(f"{label}: " + ", ".join(
                f"{c} {m} {r['regs']} registers, spills {r['spills']}"
                for (c, m), r in resources(path).items()), flush=True)
        for (case, shared), by in against(device, args.against,
                                          args.blocks).items():
            what = f"{case} {'shared' if shared else 'global'}"
            print(f"{what:>14}: " + "; ".join(
                f"{root} {c} copies in turns: {r['other_ms']:.4f} -> "
                f"{r['ms']:.4f} ms ({r['ratio']:.4f}x)"
                for (root, c), r in by.items()) + "; equal bit for bit",
                flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    clock = (torch.cuda.get_device_properties(device).multi_processor_count,
             common.sm_clock_mhz()[1]) if device.type == "cuda" else None
    print("== correctness")
    for name, r in res.items():
        if "ms" not in r:
            what, shape = name.split(" ", 1)
            label = (f"i32 lane gather {shape}" if what == "i32" else
                     f"take_along_axis axis={what[-1]} {shape}")
            print(f"  {label}: {'OK' if ok[name] else 'WRONG VALUES'}")
    print("== throughput and page loops (one copy; the card full)")
    for name, r in res.items():
        if "ms" in r:
            print(f"  {report(name, r, clock)}; "
                  f"{'OK' if ok[name] else 'WRONG'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
