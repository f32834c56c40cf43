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
  chase+vec: one block of 1,024 threads per copy: each step's (64, 128)
      vector stage (8 values a thread) and its minimum over the block feed
      the next idx (K5's block-synchronous pop).
Each runs at two launch shapes: one copy (the TPU's one program; ns per
step) and as many copies as fill the card (ns per step per SM).

On a CUDA tensor run() launches the mode's kernel (csrc/probes.cu); on a
CPU tensor it takes the plain version. Nothing runs at import.

Usage: python -m rodent_tpu_torch.experiments.probe_chain [--cpu]
    [--blocks 3]
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


def plain(mode, streams, tab, steps=N):
    """_kernel (:36-70) over `steps` steps: (1,) int32, the sum of the S
    final indices. The smem modes store and reload each idx, which
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
    for _ in range(steps):
        nxt = col[idx.long()]
        if mode == "chase+vec":
            v = tab[idx.long()][:, None, :].expand(streams, 64, 128) * c1
            v = torch.minimum(v * c2, v + acc)
            acc = v
            nxt = nxt + (v.amin(dim=(1, 2)) > 1e30).to(torch.int32)
        idx = nxt
    return idx.sum().to(torch.int32).reshape(1)


def run(mode, streams, tab, copies=1):
    """(copies,) int32: the kernel on a CUDA table, the plain version on a
    CPU one."""
    global launches
    if tab.device.type == "cpu":
        return plain(mode, streams, tab).expand(copies)
    if (tab.device.type != "cuda" or tab.dtype != torch.float32
            or tuple(tab.shape) != (NN, 128) or not tab.is_contiguous()
            or streams not in STREAMS):
        raise ValueError("probe_chain takes a contiguous (1024, 128) float32 "
                         f"CUDA table and S in {STREAMS}, not {tab.dtype} "
                         f"{tuple(tab.shape)} on {tab.device}, S {streams}")
    out = torch.empty(copies, dtype=torch.int32, device=tab.device)
    common.probe_call("rt_probe_chain", MODES.index(mode), streams,
                      tab.data_ptr(), out.data_ptr(), copies)
    launches += 1
    return out


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


def measure(device, blocks=3):
    """Every mode and S at both launch shapes: {(mode, S):
    common.probe_shapes()'s keys, "bound", "iters"}."""
    res = {}
    tab = inputs(device)
    for mode in MODES:
        for s in STREAMS:
            if device.type == "cuda":
                per = 1 if mode == "chase+vec" else SCALAR_BLOCK
                full, per_sm = common.full_copies(
                    "chain", MODES.index(mode), s, 0, per_block=per)
            else:
                full, per_sm = 1, 1.0
            r = common.probe_shapes(lambda c: run(mode, s, tab, c), device,
                                    full, per_sm, N, blocks)
            r.update(bound=bound(mode, s, full), iters=N)
            res[(mode, s)] = r
    return res


def check(res):
    """{(mode, S): True where both shapes' every copy equals the plain
    version}."""
    device = next(iter(res.values()))["out"].device
    tab = inputs(device)
    ok = {}
    for (mode, s), r in res.items():
        want = plain(mode, s, tab)
        ok[(mode, s)] = all(bool(torch.equal(o, want.expand_as(o)))
                            for o in (r["out1"], r["out"]))
    return ok


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_chain")
    common.add_args(p)
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    device = common.device_of(args, "probe_chain")
    print(f"card: {common.card(device)}", flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    for (mode, s), r in res.items():
        print(f"{mode:>17} S={s}: {r['ns1']:7.1f} ns/iter "
              f"({r['ns1'] / s:6.1f} ns/chain-step); {r['ns_sm']:.3f} "
              f"ns/iter per SM with {r['copies']} copies; bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), {r['ms']:.4f} ms; "
              f"{'OK' if ok[(mode, s)] else 'WRONG'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
