"""The cost of the traversal loop body, feature by feature (port of
experiments/probe_body.py, which bisected the TPU packet kernel's while
body).

Around probe_chain's chase+vec step (N = 2048 steps; a row of a (1024,
128) float32 table, a (64, 128) vector stage whose minimum feeds the next
row), features compose:
  carry5: five (64, 128) buffers carried through the loop, not one;
  cond: the vector stage inside a data-dependent branch (idx >= 0);
  datacond: the loop also ends on a value of the body (idx < 1024);
  sort: the 19-exchange Batcher network on 8 keys (lanes 8-15) with their
      codes (lanes 16-23), K1's sort_children;
  push8: 8 predicated pushes of lanes 32-39 onto an 8-entry stack (the
      JAX body's SMEM scratch).
The nine feature sets of the JAX file run at two launch shapes: one copy
(one block, each (64, 128) operand spread over its threads: the TPU's one
program) and as many copies as fill the card. The output is idx + i at
the loop's end; `aux` holds each copy's first value of every carried
buffer and a word of the push stack, which the card's kernel writes so
that nvcc keeps them.

The card's body (csrc/probes.cu, body_kernel) takes one barrier a step
and runs the sort and the pushes once per copy, in one warp; a copy is a
block of 256 threads. Its outputs do not read the network's result (a
zero, as in the JAX body), so sort8() runs the network alone, as the
body's warp 0 runs it, for its check.

On a CUDA tensor run() and sort8() launch their kernels; on a CPU tensor
they take the plain version. Nothing runs at import.

Usage: python -m rodent_tpu_torch.experiments.probe_body [--cpu]
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

from ..traversal.api import _SORT_NETWORKS
from . import common

N, NN = 2048, 1024
FEATS = {"carry5": 1, "cond": 2, "datacond": 4, "sort": 8, "push8": 16}
# experiments/probe_body.py:126-136
CASES = [(), ("carry5",), ("cond",), ("datacond",), ("sort",), ("push8",),
         ("cond", "carry5"), ("sort", "push8"),
         ("cond", "carry5", "sort", "push8", "datacond")]
HEAD = ("cond", "carry5", "sort", "push8", "datacond")
launches = 0


def name(feats):
    return "+".join(feats) or "base"


def mask(feats):
    """The C entry's mask: the feature bits."""
    return sum(FEATS[f] for f in feats)


def inputs(device="cpu"):
    """run's table (:99-105): a permutation's int32 bits in lane 0, random
    keys in lanes 8-15, 1.0 in lanes 16-23 and 32-39."""
    rng = np.random.default_rng(0)
    perm = rng.permutation(NN).astype(np.int32)
    tab = np.zeros((NN, 128), np.float32)
    tab[:, 0] = perm.view(np.float32)
    tab[:, 8:16] = rng.random((NN, 8), np.float32)
    tab[:, 16:24] = 1.0
    tab[:, 32:40] = 1.0
    return torch.from_numpy(tab).to(device)


def plain_sort8(keys, kids):
    """The Batcher network (_SORT_NETWORKS[8], :60-68) over (sets, 8) keys
    and their codes, every set at once: (keys, kids) sorted."""
    keys, kids = list(keys.unbind(1)), list(kids.unbind(1))
    for a, b in _SORT_NETWORKS[8]:
        sw = keys[a] > keys[b]
        keys[a], keys[b] = (torch.where(sw, keys[b], keys[a]),
                            torch.where(sw, keys[a], keys[b]))
        kids[a], kids[b] = (torch.where(sw, kids[b], kids[a]),
                            torch.where(sw, kids[a], kids[b]))
    return torch.stack(keys, 1), torch.stack(kids, 1)


def sort8(keys, kids):
    """(keys, kids) of (sets, 8) float32 keys and int32 codes, each set
    sorted: body_kernel's network (csrc/probes.cu, sort8) on CUDA tensors,
    plain_sort8 on CPU ones."""
    if keys.device.type == "cpu":
        return plain_sort8(keys, kids)
    if (keys.device.type != "cuda" or keys.dtype != torch.float32
            or kids.dtype != torch.int32 or keys.shape != kids.shape
            or keys.dim() != 2 or keys.shape[1] != 8
            or kids.device != keys.device or not keys.is_contiguous()
            or not kids.is_contiguous() or keys.shape[0] < 1):
        raise ValueError("sort8 takes contiguous (sets, 8) float32 keys and "
                         f"int32 codes on one CUDA device, not {keys.dtype} "
                         f"{tuple(keys.shape)} on {keys.device}, {kids.dtype} "
                         f"{tuple(kids.shape)} on {kids.device}")
    out_keys, out_kids = torch.empty_like(keys), torch.empty_like(kids)
    common.probe_call("rt_probe_sort8", keys.data_ptr(), kids.data_ptr(),
                      out_keys.data_ptr(), out_kids.data_ptr(),
                      keys.shape[0])
    return out_keys, out_kids


def _sort_zero(tab, rows):
    """kids[0] & 0 of every visited row (a zero): the network over keys
    (lanes 8-15) and codes (lanes 16-23), run on all the rows at once,
    since its result adds nothing to the chase."""
    _, kids = plain_sort8(tab[rows, 8:16],
                          tab[rows, 16:24].contiguous().view(torch.int32))
    return int((kids[:, 0] & 0).sum())


def _push8(tab, rows):
    """The pushes of every visited row (:72-81): (sp & 0 summed, a zero;
    stack word 0 at the end, as float32 bits, 0 if never written). Each
    row pushes its nonzero words of lanes 32-39 at min(sp, 7), the others
    write word 7; sp starts each row at the last row's sp - 8."""
    vals = tab[rows, 32:40].contiguous().view(torch.int32)
    ok = (vals != 0).to(torch.int64)
    cnt = ok.sum(1)
    start = torch.cumsum(cnt - 8, 0) - (cnt - 8)
    sp = start[:, None] + torch.cumsum(ok, 1) - ok
    pos = torch.where(ok.bool(), torch.clamp(sp, max=7), 7).reshape(-1)
    spend = start + cnt
    hit = torch.nonzero(pos == 0)
    word = vals.reshape(-1)[hit[-1, 0]] if hit.numel() else vals.new_zeros(())
    return int((spend & 0).sum()), word.reshape(1).view(torch.float32)


def plain(feats, tab, steps=N):
    """_kernel (:33-95) over at most `steps` steps: ((1,) int32 idx + i at
    the end, (6,) float32 aux: each carried buffer's first value, 0 for
    the buffers not carried, and the push stack's word 0)."""
    nc = 5 if "carry5" in feats else 1
    dev = tab.device
    col = tab[:, 0].contiguous().view(torch.int32).tolist()
    bufs = [torch.full((64, 128), float(k), dtype=torch.float32, device=dev)
            for k in range(nc)]
    c1 = torch.tensor(1.000001, dtype=torch.float32, device=dev)
    c2 = torch.tensor(1.5, dtype=torch.float32, device=dev)
    i, idx, rows = 0, 0, []
    while i < steps and ("datacond" not in feats or idx < NN):
        rows.append(idx)
        if "cond" not in feats or idx >= 0:
            v = tab[idx].expand(64, 128) * c1
            v = torch.minimum(v * c2, v + bufs[0])
            nxt = col[idx] + int(bool(v.min() > 1e30))
            keep = v < 0.5
            bufs = [torch.where(keep, v, b) for b in bufs]
        else:
            nxt = idx + 1
        idx, i = nxt, i + 1
    rows = torch.tensor(rows, device=dev)
    word = torch.zeros(1, dtype=torch.float32, device=dev)
    if "sort" in feats:
        idx += _sort_zero(tab, rows)
    if "push8" in feats:
        zero, word = _push8(tab, rows)
        idx += zero
    aux = torch.cat([b[0, 0:1] for b in bufs]
                    + [torch.zeros(5 - nc, device=dev), word])
    return torch.tensor([idx + i], dtype=torch.int32, device=dev), aux


def launch(lib, m, tab, copies):
    """rt_probe_body of the probes library lib (None: this tree's) with the
    mask m on `copies` copies, on the current stream: ((copies,) int32,
    (copies, 6) float32)."""
    out = torch.empty(copies, dtype=torch.int32, device=tab.device)
    aux = torch.empty(copies, 6, dtype=torch.float32, device=tab.device)
    common.probe_call("rt_probe_body", m, tab.data_ptr(), out.data_ptr(),
                      aux.data_ptr(), 0, copies, lib=lib)
    return out, aux


def run(feats, tab, copies=1):
    """((copies,) int32, (copies, 6) float32 aux): the kernel on a CUDA
    table, the plain version on a CPU one."""
    global launches
    if tab.device.type == "cpu":
        out, aux = plain(feats, tab)
        return out.expand(copies), aux[None].expand(copies, 6)
    if (tab.device.type != "cuda" or tab.dtype != torch.float32
            or tuple(tab.shape) != (NN, 128) or not tab.is_contiguous()
            or tuple(feats) not in CASES):
        raise ValueError("probe_body takes a contiguous (1024, 128) float32 "
                         f"CUDA table and a feature set of {CASES}, not "
                         f"{tab.dtype} {tuple(tab.shape)} on {tab.device}, "
                         f"{feats}")
    res = launch(None, mask(feats), tab, copies)
    launches += 1
    return res


def ops_per_step(feats):
    """The JAX body's float32 operations in one step of one copy: on each
    of the 8,192 values two multiplies, an add, a min, the min into the
    step's minimum, the < 0.5 test and a select per carried buffer; and
    once per copy, as the JAX body runs them on its scalar unit, the
    network's 19 compares and 76 selects and the pushes' 8 x 4
    operations."""
    nc = 5 if "carry5" in feats else 1
    return (64 * 128 * (6 + nc) + (19 * 5 if "sort" in feats else 0)
            + (32 if "push8" in feats else 0))


def bound(feats, copies):
    """The launch's bound: ops_per_step over N steps of every copy, against
    the table read once and the outputs written."""
    return common.probe_bound_ms(ops_per_step(feats) * N * copies,
                                 NN * 512 + copies * 28)


def measure(device, blocks=3):
    """Every feature set at both launch shapes: {feats:
    common.probe_shapes()'s keys, "bound", "iters"}."""
    res, tab = {}, inputs(device)
    for feats in CASES:
        if device.type == "cuda":
            full, per_sm = common.full_copies("body", mask(feats))
        else:
            full, per_sm = 1, 1.0
        r = common.probe_shapes(lambda c: run(feats, tab, c), device, full,
                                per_sm, N, blocks)
        r.update(bound=bound(feats, full), iters=N)
        res[feats] = r
    return res


def equal(got, want):
    """Whether every copy of got (out, aux) equals want (plain()'s) bit for
    bit."""
    (o, a), (out, aux) = got, want
    return (bool(torch.equal(o, out.expand_as(o)))
            and bool(torch.equal(a.view(torch.int32),
                                 aux.view(torch.int32).expand_as(a))))


def check(res):
    """{feats: True where both shapes' every copy, output and aux, equals
    the plain version bit for bit}."""
    tab, ok = inputs(next(iter(res.values()))["out"][0].device), {}
    for feats, r in res.items():
        want = plain(feats, tab)
        ok[feats] = equal(r["out1"], want) and equal(r["out"], want)
    return ok


def step_barriers(fn):
    """The BAR.SYNC instructions in a body_kernel's step loop (fn: its
    common.Sass): the backward branch to the earliest target, from that
    target to its last branch there. A shuffle's out-of-line path for a
    diverged warp also branches back into the loop, from past its end."""
    back = common.loops(fn)
    lo = min((t for t, _ in back), default=0)
    hi = max((a for t, a in back if t == lo), default=-1)
    return sum(1 for a, text, _ in fn.insns if lo <= a <= hi
               and common.opcode(text, full=True).startswith("BAR.SYNC"))


def resources(lib_path=None, funcs=None):
    """{feats: {"regs", "spills" (bytes stored and loaded), "barriers"
    (step_barriers)}} of every body_kernel of a probes library (this
    tree's by default; common.probe_kernels); funcs: the library's
    common.read_sass, where the caller has read it."""
    bits = {mask(f): f for f in CASES}
    return {bits[m]: {"regs": r["regs"], "spills": r["spills"],
                      "barriers": step_barriers(r["sass"])}
            for m, r in common.probe_kernels(r"body_kernelILi(\d+)EE",
                                             lib_path, funcs).items()}


def against(device, roots, blocks=3):
    """Every feature set in turns with each other checkout's body (its
    probes library, with the same mask; common.probe_against), out and aux
    bit for bit the other's and the plain version's. {feats: {(root,
    copies): {"ms", "other_ms", "ratio"}}}."""
    tab = inputs(device)
    want = {feats: plain(feats, tab) for feats in CASES}

    def outputs(got):
        return {"out": got[0], "aux": got[1].view(torch.int32)}

    return common.probe_against(
        "body", CASES, mask,
        lambda feats, c: outputs(run(feats, tab, c)),
        lambda lib, feats, c: outputs(launch(lib, mask(feats), tab, c)),
        lambda feats, out: equal((out["out"], out["aux"].view(
            torch.float32)), want[feats]),
        device, roots, blocks)


def report(feats, r):
    return (f"{name(feats):>32}: {r['ns1']:7.1f} ns/iter; "
            f"{r['ns_sm']:.2f} ns/iter per SM with {r['copies']} copies; "
            f"bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}), {r['ms']:.4f} ms, "
            f"{r['bound'][0] / r['ms']:.1%} of it")


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_body")
    common.add_args(p)
    p.add_argument("--against", nargs="+", metavar="DIR",
                   help="the roots of other checkouts whose body is timed "
                   "against this one's, every feature set")
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    if args.cpu and args.against:
        p.error("--against times builds of a CUDA kernel: it needs the "
                "card")
    device = common.device_of(args, "probe_body")
    print(f"card: {common.card(device)}", flush=True)
    if args.against:
        libs = {"this tree": None} | {root: common.other_library(
            root, "probes")._name for root in args.against}
        for label, path in libs.items():
            print(f"{label}: " + ", ".join(
                f"{name(f)} {r['regs']} registers, spills {r['spills']}, "
                f"{r['barriers']} BAR.SYNC in the step loop"
                for f, r in resources(path).items()), flush=True)
        for feats, by in against(device, args.against, args.blocks).items():
            print(f"{name(feats):>32}: " + "; ".join(
                f"{root} {c} copies in turns: {r['other_ms']:.4f} -> "
                f"{r['ms']:.4f} ms ({r['ratio']:.4f}x)"
                for (root, c), r in by.items()) + "; equal bit for bit",
                flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    for feats, r in res.items():
        print(f"{report(feats, r)}; {'OK' if ok[feats] else 'WRONG'}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
