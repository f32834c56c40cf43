"""The latency of a dependent load chain, and whether S chains in one loop
overlap (port of experiments/probe_chain.py, which asked that of VMEM
loads inside a Pallas while loop).

A step loads row idx of a (1024, 128) float32 table and takes the int32
bits of its lane 0 as the next idx (a permutation, default_rng(0)): K1's
pop-to-load chain. N = 2048 steps of S = 1, 2, 4 chains interleaved; the
output is the sum of the final indices. Modes:
  chase: the chain alone, one thread per copy (the TPU's scalar chain);
  chase+smem: each step's idx stored to a stack and read back, in
      per-thread local memory as K1's stack;
  chase+smem-shared: the same stack in shared memory (the TPU's SMEM);
  chase+vec: one block per copy: each step's (64, 128) vector stage and
      its minimum over the block feed the next idx (K5's block-synchronous
      pop). On the JAX table the minimum never passes 1e30, so the output
      cannot show it: `aux` carries the fold of every step's minimum
      (fold_minima), and moving()'s table, random in lanes 1-127, moves
      it.
Each runs at two launch shapes: one copy (the TPU's one program; ns per
step) and as many copies as fill the card (ns per step per SM).

The card's bodies (csrc/probes.cu): chase+smem-shared keeps a warp's
stack words in 32 banks; chase+vec is probe_body's step, 256 threads a
copy and one barrier a step. issue_ms() is the time of the work at one
operation a lane and cycle.

On a CUDA tensor run() launches the mode's kernel (csrc/probes.cu); on a
CPU tensor it takes the plain version. Nothing runs at import.

Usage: python -m rodent_tpu_torch.experiments.probe_chain [--cpu]
    [--blocks 3] [--against DIR [DIR ...]]
--against times this tree's bodies against each other checkout's (its
rodent_tpu_torch/csrc/probes.cu, built under common.AGAINST_BUILD) in
turns at one copy, at the other's full shape and at this one's, every
output bit for bit equal (aux where both have it); it needs the card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import common

N, NN = 2048, 1024
MODES = ("chase", "chase+smem", "chase+smem-shared", "chase+vec")
STREAMS = (1, 2, 4)
HEAD = ("chase", 1)
SCALAR_BLOCK = 128           # copies per block of the one-thread modes
launches = 0


def inputs(device="cpu"):
    """run's table (:75-78): a permutation's int32 bits in column 0."""
    perm = np.random.default_rng(0).permutation(NN).astype(np.int32)
    tab = np.zeros((NN, 128), np.float32)
    tab[:, 0] = perm.view(np.float32)
    return torch.from_numpy(tab).to(device)


def moving(device="cpu", seed=0):
    """inputs()'s table with lanes 1-127 seeded uniform in [-1, 1): the
    chases read lane 0 alone and give the same outputs, but chase+vec's
    minimum moves from step to step, so its aux shows a reduction that
    returns the wrong value (on inputs() it is 0 at every step)."""
    tab = inputs().numpy().copy()
    tab[:, 1:] = np.random.default_rng(seed).uniform(
        -1.0, 1.0, (NN, 127)).astype(np.float32)
    return torch.from_numpy(tab).to(device)


FNV_BASIS, FNV_PRIME = 2166136261, 16777619


def fold_minima(mins):
    """chase+vec's aux: FNV-1a over the bits of each step's minimum, step
    by step and stream by stream (mins: (steps, S) float32), as the
    kernel folds them: (1,) int32."""
    h = FNV_BASIS
    for b in np.ascontiguousarray(mins, np.float32).view(
            np.uint32).reshape(-1).tolist():
        h = ((h ^ b) * FNV_PRIME) & 0xFFFFFFFF
    return np.array([h], np.uint32).view(np.int32)


def plain(mode, streams, tab, steps=N):
    """_kernel (:36-70) over `steps` steps: ((1,) int32, the sum of the S
    final indices; (1,) int32 aux, fold_minima of chase+vec's minima, 0
    in the other modes). The smem modes store and reload each idx, which
    changes no value. chase+vec: each stream's (64, 128) stage v =
    min(row * 1.000001 * 1.5, row * 1.000001 + v_last), and its minimum
    over 1e30 adds 1 to the next idx."""
    col = tab[:, 0].contiguous().view(torch.int32)
    idx = torch.tensor([s * 37 % NN for s in range(streams)],
                       dtype=torch.int32, device=tab.device)
    acc = torch.zeros(streams, 64, 128, dtype=torch.float32,
                      device=tab.device)
    c1 = torch.tensor(1.000001, dtype=torch.float32, device=tab.device)
    c2 = torch.tensor(1.5, dtype=torch.float32, device=tab.device)
    mins = []
    for _ in range(steps):
        nxt = col[idx.long()]
        if mode == "chase+vec":
            v = tab[idx.long()][:, None, :].expand(streams, 64, 128) * c1
            v = torch.minimum(v * c2, v + acc)
            acc = v
            m = v.amin(dim=(1, 2))
            mins.append(m)
            nxt = nxt + (m > 1e30).to(torch.int32)
        idx = nxt
    aux = (torch.from_numpy(fold_minima(torch.stack(mins).cpu().numpy()))
           if mins else torch.zeros(1, dtype=torch.int32))
    return idx.sum().to(torch.int32).reshape(1), aux.to(tab.device)


# the one-thread modes' aux (they have no minimum): zeros made once per
# device and copies, so that a timed launch makes none
_ZEROS = {}


def launch(lib, mode, streams, tab, copies):
    """The mode's kernel of the probes library lib (None: this tree's) on
    `copies` copies, on the current stream: ((copies,) int32, (copies,)
    int32 aux, or None where lib's bodies predate it)."""
    lib = lib or common.load_library(kind="probes")
    out = torch.empty(copies, dtype=torch.int32, device=tab.device)
    if mode != "chase+vec" or not hasattr(lib, "rt_probe_chain_aux"):
        common.probe_call("rt_probe_chain", MODES.index(mode), streams,
                          tab.data_ptr(), out.data_ptr(), copies, lib=lib)
        if not hasattr(lib, "rt_probe_chain_aux"):
            return out, None
        key = (tab.device, copies)
        if key not in _ZEROS:
            _ZEROS[key] = torch.zeros(copies, dtype=torch.int32,
                                      device=tab.device)
        return out, _ZEROS[key]
    aux = torch.empty(copies, dtype=torch.int32, device=tab.device)
    common.probe_call("rt_probe_chain_aux", MODES.index(mode), streams,
                      tab.data_ptr(), out.data_ptr(), aux.data_ptr(), copies,
                      lib=lib)
    return out, aux


def run(mode, streams, tab, copies=1):
    """((copies,) int32 out, (copies,) int32 aux): the kernel on a CUDA
    table, the plain version on a CPU one."""
    global launches
    if tab.device.type == "cpu":
        return tuple(x.expand(copies) for x in plain(mode, streams, tab))
    if (tab.device.type != "cuda" or tab.dtype != torch.float32
            or tuple(tab.shape) != (NN, 128) or not tab.is_contiguous()
            or streams not in STREAMS):
        raise ValueError("probe_chain takes a contiguous (1024, 128) float32 "
                         f"CUDA table and S in {STREAMS}, not {tab.dtype} "
                         f"{tuple(tab.shape)} on {tab.device}, S {streams}")
    res = launch(None, mode, streams, tab, copies)
    launches += 1
    return res


def bound(mode, streams, copies):
    """The full launch's bound: per step and stream, one int operation
    (the index) for the chases, and 5 float operations on each of 8,192
    values (two multiplies, an add, a min and the min into the block's
    minimum) for chase+vec; the table read once and the outputs
    written."""
    if mode == "chase+vec":
        ops, dtype = 5 * 64 * 128 * N * streams * copies, "float32"
    else:
        ops, dtype = N * streams * copies, "int32"
    return common.probe_bound_ms(ops, NN * 512 + 4 * copies, dtype)


def issue_ms(mode, streams, copies, sms, mhz):
    """The least time of bound()'s operations at one a lane and cycle
    (128 lanes an SM at mhz), in whole waves: a chase's copy is one
    thread, whose N * S index operations run on one lane; a chase+vec
    copy's 5 * 8,192 operations a step and stream spread over an SM's
    lanes."""
    if mode == "chase+vec":
        cycles = -(-copies // sms) * 5 * 64 * 128 * N * streams / 128
    else:
        cycles = -(-copies // (sms * 128)) * N * streams
    return cycles / (mhz * 1e6) * 1e3


def shape(mode, streams):
    """full_copies' arguments of a mode: (its number, S) and the copies a
    block."""
    return ((MODES.index(mode), streams),
            1 if mode == "chase+vec" else SCALAR_BLOCK)


def measure(device, blocks=3):
    """Every mode and S at both launch shapes: {(mode, S):
    common.probe_shapes()'s keys ("out1", "out": (out, aux)), "bound",
    "iters"}."""
    res = {}
    tab = inputs(device)
    for mode in MODES:
        for s in STREAMS:
            if device.type == "cuda":
                args, per = shape(mode, s)
                full, per_sm = common.full_copies("chain", *args,
                                                  per_block=per)
            else:
                full, per_sm = 1, 1.0
            r = common.probe_shapes(lambda c: run(mode, s, tab, c), device,
                                    full, per_sm, N, blocks)
            r.update(bound=bound(mode, s, full), iters=N)
            res[(mode, s)] = r
    return res


def equal(got, want):
    """Whether every copy of got (out, aux) equals want (plain()'s) bit
    for bit."""
    return all(bool(torch.equal(g, w.expand_as(g)))
               for g, w in zip(got, want))


def check(res):
    """{(mode, S): True where every copy, out and aux, equals the plain
    version bit for bit: both shapes on inputs()'s table (the measured
    outputs), and on moving()'s, run here at one copy and at the full
    shape's copies}."""
    device = next(iter(res.values()))["out"][0].device
    tab, tab2 = inputs(device), moving(device)
    ok = {}
    for (mode, s), r in res.items():
        want, want2 = plain(mode, s, tab), plain(mode, s, tab2)
        ok[(mode, s)] = (equal(r["out1"], want) and equal(r["out"], want)
                         and all(equal(run(mode, s, tab2, c), want2)
                                 for c in (1, r["copies"])))
    return ok


def resources(lib_path=None, funcs=None):
    """{(mode, S): {"regs", "spills" (bytes stored and loaded)}, and for
    chase+vec "barriers" (BAR.SYNC in its step loop,
    probe_body.step_barriers)} of every chain kernel of a probes library
    (this tree's by default; common.probe_kernels)."""
    from .probe_body import step_barriers
    out = {(MODES[m], s): {"regs": r["regs"], "spills": r["spills"]}
           for (m, s), r in common.probe_kernels(
               r"chain_scalar_kernelILi(\d+)ELi(\d+)EE", lib_path,
               funcs).items()}
    out.update({("chase+vec", s): {"regs": r["regs"], "spills": r["spills"],
                                   "barriers": step_barriers(r["sass"])}
                for s, r in common.probe_kernels(
                    r"chain_vec_kernelILi(\d+)EE", lib_path, funcs).items()})
    return out


def against(device, roots, blocks=3):
    """Every mode and S in turns with each other checkout's body
    (common.probe_against), out bit for bit the other's (aux too where
    both have it) and out and aux the plain version's. {(mode, S): {(root,
    copies): {"ms", "other_ms", "ratio"}}}."""
    tab = inputs(device)
    cases = [(mode, s) for mode in MODES for s in STREAMS]
    want = {}

    def plain_of(case):
        if case not in want:
            want[case] = plain(*case, tab)
        return want[case]

    def outputs(got):
        return {"out": got[0]} | ({} if got[1] is None else {"aux": got[1]})

    return common.probe_against(
        "chain", cases, lambda case: shape(*case)[0],
        lambda case, c: outputs(run(*case, tab, c)),
        lambda lib, case, c: outputs(launch(lib, *case, tab, c)),
        lambda case, out: equal((out["out"], out["aux"]), plain_of(case)),
        device, roots, blocks, per_block=lambda case: shape(*case)[1])


def report(mode, s, r, clock=None):
    """A mode's line: both shapes' times and the share of the bound; on a
    card (clock: its SMs and SM MHz) also of the issue rate (issue_ms) at
    the full shape."""
    line = (f"{mode:>17} S={s}: {r['ns1']:7.1f} ns/iter "
            f"({r['ns1'] / s:6.1f} ns/chain-step); {r['ns_sm']:.3f} "
            f"ns/iter per SM with {r['copies']} copies; bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), {r['ms']:.4f} ms, "
            f"{r['bound'][0] / r['ms']:.1%} of it")
    if clock:
        issue = issue_ms(mode, s, r["copies"], *clock)
        line += f", {issue / r['ms']:.1%} of the issue rate"
    return line


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_chain")
    common.add_args(p)
    p.add_argument("--against", nargs="+", metavar="DIR",
                   help="the roots of other checkouts whose bodies are "
                   "timed against this one's, every mode and S")
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    if args.cpu and args.against:
        p.error("--against times builds of a CUDA kernel: it needs the "
                "card")
    device = common.device_of(args, "probe_chain")
    print(f"card: {common.card(device)}", flush=True)
    if args.against:
        libs = {"this tree": None} | {root: common.other_library(
            root, "probes")._name for root in args.against}
        for label, path in libs.items():
            print(f"{label}: " + ", ".join(
                f"{m} S={s} {r['regs']} registers, spills {r['spills']}"
                + (f", {r['barriers']} BAR.SYNC in the step loop"
                   if "barriers" in r else "")
                for (m, s), r in resources(path).items()), flush=True)
        for (mode, s), by in against(device, args.against,
                                     args.blocks).items():
            print(f"{mode:>17} S={s}: " + "; ".join(
                f"{root} {c} copies in turns: {r['other_ms']:.4f} -> "
                f"{r['ms']:.4f} ms ({r['ratio']:.4f}x)"
                for (root, c), r in by.items()) + "; equal bit for bit",
                flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    clock = (torch.cuda.get_device_properties(device).multi_processor_count,
             common.sm_clock_mhz()[1]) if device.type == "cuda" else None
    for (mode, s), r in res.items():
        print(f"{report(mode, s, r, clock)}; "
              f"{'OK' if ok[(mode, s)] else 'WRONG'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
