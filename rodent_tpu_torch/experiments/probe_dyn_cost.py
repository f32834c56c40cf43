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
TPU's one program) and as many copies as fill the card.

On a CUDA tensor run() launches the body's kernel (csrc/probes.cu); on a
CPU tensor it takes the plain version.

Usage: python -m rodent_tpu_torch.experiments.probe_dyn_cost [--cpu]
    [--blocks 3]
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
    out = torch.empty(copies, 8, 128, dtype=torch.float32, device=tab.device)
    common.probe_call("rt_probe_dyn_cost", list(BODIES).index(body),
                      tab.data_ptr(), out.data_ptr(), copies)
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
    bit for bit}."""
    tab = inputs(next(iter(res.values()))["out"].device)
    ok = {}
    for body, r in res.items():
        want = plain(body, tab)
        ok[body] = all(bool(torch.equal(o, want.expand_as(o)))
                       for o in (r["out1"], r["out"]))
    return ok


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_dyn_cost")
    common.add_args(p)
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    device = common.device_of(args, "probe_dyn_cost")
    print(f"card: {common.card(device)}", flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    for body, r in res.items():
        print(f"{BODIES[body]:>24}: {r['ns1']:8.1f} ns/iter; "
              f"{r['ns_sm']:.2f} ns/iter per SM with {r['copies']} copies; "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
              f"{r['ms']:.4f} ms; {'OK' if ok[body] else 'WRONG'}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
