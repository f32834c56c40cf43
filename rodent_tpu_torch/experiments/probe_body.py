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
  push8: 8 predicated pushes of lanes 32-39 onto an 8-entry stack, in
      per-thread local memory as K1's stack.
The nine feature sets of the JAX file run at two launch shapes: one copy
(one block of 1,024 threads, each (64, 128) operand 8 values a thread: the
TPU's one program) and as many copies as fill the card. The output is
idx + i at the loop's end; `aux` holds each copy's first value of every
carried buffer and a word of the push stack, which the card's kernel
writes so that nvcc keeps them.

On a CUDA tensor run() launches the feature set's kernel (csrc/probes.cu);
on a CPU tensor it takes the plain version. Nothing runs at import.

Usage: python -m rodent_tpu_torch.experiments.probe_body [--cpu]
    [--blocks 3]
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


def _sort_zero(tab, rows):
    """kids[0] & 0 of every visited row (a zero): the Batcher network over
    keys (lanes 8-15) and codes (lanes 16-23), run on all the rows at
    once, since its result adds nothing to the chase."""
    keys = list(tab[rows, 8:16].unbind(1))
    kids = list(tab[rows, 16:24].contiguous().view(torch.int32).unbind(1))
    for a, b in _SORT_NETWORKS[8]:
        sw = keys[a] > keys[b]
        keys[a], keys[b] = (torch.where(sw, keys[b], keys[a]),
                            torch.where(sw, keys[a], keys[b]))
        kids[a], kids[b] = (torch.where(sw, kids[b], kids[a]),
                            torch.where(sw, kids[a], kids[b]))
    return int((kids[0] & 0).sum())


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
    out = torch.empty(copies, dtype=torch.int32, device=tab.device)
    aux = torch.empty(copies, 6, dtype=torch.float32, device=tab.device)
    common.probe_call("rt_probe_body", mask(feats), tab.data_ptr(),
                      out.data_ptr(), aux.data_ptr(), 0, copies)
    launches += 1
    return out, aux


def bound(feats, copies):
    """The full launch's bound, float32 operations per step: on each of
    the 8,192 values two multiplies, an add, a min, the min into the
    block's minimum, the < 0.5 test and a select per carried buffer; per
    thread (1,024), the network's 19 compares and 76 selects and the
    pushes' 8 x 4 operations; the table read once, outputs written."""
    nc = 5 if "carry5" in feats else 1
    per_step = 64 * 128 * (6 + nc)
    per_step += 1024 * ((19 * 5 if "sort" in feats else 0)
                        + (32 if "push8" in feats else 0))
    return common.probe_bound_ms(per_step * N * copies,
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


def check(res):
    """{feats: True where both shapes' every copy, output and aux, equals
    the plain version bit for bit}."""
    tab = inputs(next(iter(res.values()))["out"][0].device)
    ok = {}
    for feats, r in res.items():
        out, aux = plain(feats, tab)
        ok[feats] = all(
            bool(torch.equal(o, out.expand_as(o)))
            and bool(torch.equal(a.view(torch.int32),
                                 aux.view(torch.int32).expand_as(a)))
            for o, a in (r["out1"], r["out"]))
    return ok


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_body")
    common.add_args(p)
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    device = common.device_of(args, "probe_body")
    print(f"card: {common.card(device)}", flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    for feats, r in res.items():
        print(f"{name(feats):>32}: {r['ns1']:7.1f} ns/iter; "
              f"{r['ns_sm']:.2f} ns/iter per SM with {r['copies']} copies; "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
              f"{r['ms']:.4f} ms; {'OK' if ok[feats] else 'WRONG'}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
