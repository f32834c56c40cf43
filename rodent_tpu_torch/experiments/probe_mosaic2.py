"""The pair kernel's constructs inside loops on the card (port of
experiments/probe_mosaic2.py): a dot in a fori_loop, a dynamic roll in a
loop, dynamic stores in a while loop (one row, or an (8, 128) tile per
entry), and the pair kernel's skeleton, a stack machine that pops the
argmin lane, reads a code through a roll and pushes under a cond.

The (16, 128) float32 input arange(2048) / 7, a (16, 128) float32 output.
On a CUDA tensor run() launches the body's CUDA kernel (csrc/probes.cu,
one block); on a CPU tensor it takes the plain version. main() runs each
body once and prints the JAX file's line, with OK where the kernel's
output equals the plain version's bit for bit.

Usage: python -m rodent_tpu_torch.experiments.probe_mosaic2 [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

from . import common
from .probe_mosaic import inputs

# body -> the name experiments/probe_mosaic2.py:138-179 prints (main and
# main2)
BODIES = {"dot_in_loop": "dot_in_loop", "dynroll_in_loop": "dynroll_in_loop",
          "dynstore_in_while": "dynstore_in_while",
          "stack_machine": "stack_machine",
          "dynstore8_in_while": "dynstore8_in_while"}
INFV = 3.4e38
HEAD = "stack_machine"
launches = 0


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def plain_dot_in_loop(x):
    """k_dot_in_loop (:30-40): 50 times, acc += (row 0 of x + acc) times
    the 0/1 selector, summed over k in order, times 1e-6."""
    k = torch.arange(128, device=x.device)
    sel = (k[:, None] % 8 == k[None, :] // 16).to(torch.float32)
    acc = torch.zeros_like(x)
    for _ in range(50):
        row = x[0] + acc[0]
        dot = torch.zeros_like(row)
        for i in range(128):
            dot = dot + row[i] * sel[i]
        acc = acc + dot * _f32(1e-6, x)
    return acc


def plain_dynroll_in_loop(x):
    """k_dynroll_in_loop (:43-49): rolled bits times 0, added 50 times."""
    acc = torch.zeros_like(x)
    for i in range(50):
        acc = acc + torch.roll(x.view(torch.int32), i % 8 + 1,
                               1).view(torch.float32) * 0.0
    return acc


def _dynstore_machine(x, h):
    """The machine of k_dynstore_in_while (h = 1, :52-72) and
    k_dynstore8_in_while (h = 8, :153-174): two stack entries of h rows
    (x's rows 0 and 1) popped 3 and 2 times, each pop adding the entry's
    first row and raising the entry by 1."""
    scr = torch.cat([x[0:1].expand(h, 128), x[1:2].expand(h, 128)])
    sm = [2, 3]
    sp, acc = 2, torch.zeros_like(x)
    while sp > 0:
        ent = scr[(sp - 1) * h:sp * h].clone()
        sm[sp - 1] -= 1
        scr[(sp - 1) * h:sp * h] = ent + 1.0
        acc = acc + ent[0:1]
        sp = sp if sm[sp - 1] > 0 else sp - 1
    return acc


def plain_dynstore_in_while(x):
    return _dynstore_machine(x, 1)


def plain_dynstore8_in_while(x):
    return _dynstore_machine(x, 8)


def plain_stack_machine(x):
    """k_stack_machine (:75-135), stepped on the host: a pop takes the
    first lane of the top key row's minimum, strips it, reads the code
    through roll(codes, 8 - lane // 16)[0]; a positive code pushes a row of
    keys (or writes row 7 when the push is refused), another runs the leaf
    loop."""
    iota = torch.arange(128, device=x.device)
    kst = torch.full((8, 128), INFV, dtype=torch.float32, device=x.device)
    nst = torch.zeros((8, 128), dtype=torch.int32, device=x.device)
    kst[0, 0] = 0.0
    nst[0, 120] = 1
    sm = [0] * 8
    sm[0] = 1
    sp, it, acc = 1, 0, torch.zeros_like(x)
    while sp > 0 and it < 64:
        kr = kst[sp - 1].clone()
        lane = int(torch.where(kr <= kr.min(), iota, 128).min())
        code = int(torch.roll(nst[sp - 1], 8 - lane // 16, 0)[0])
        rem = sm[sp - 1] - 1
        kst[sp - 1] = torch.where(iota == lane, _f32(INFV, x), kr)
        sm[sp - 1] = rem
        sp = sp if rem > 0 else sp - 1
        if code > 0:
            krow = torch.where((iota % 16 == 0) & (iota < 32 * code),
                               x[0, 0] * 0.0 + iota.to(torch.float32),
                               _f32(INFV, x))
            nhit = int((krow < _f32(INFV, x)).sum())
            push = nhit > 0 and code < 3
            idx = sp if push else 7
            kst[idx] = krow
            nst[idx] = torch.where(iota == 120, code + 1,
                                   torch.where(iota == 121, -(code + 1), 0))
            sm[idx] = nhit
            acc = acc + 1.0
            sp = sp + 1 if push else sp
        else:
            done, cc, k = False, code, 0
            while not done and k < 4:
                done, cc, k = cc <= -2, cc - 1, k + 1
                acc = acc + 2.0
        it += 1
    return acc


PLAIN = {b: globals()[f"plain_{b}"] for b in BODIES}


def bound(body):
    """One launch's bound: the (16, 128) input read and the output written,
    against dot_in_loop's 50 products of (16, 128) x (128, 128) and the
    other bodies' one add per value and iteration (50 or 64 at most)."""
    ops = (50 * 2 * 16 * 128 * 128 if body == "dot_in_loop"
           else 64 * 16 * 128)
    return common.probe_bound_ms(ops, 2 * 16 * 128 * 4)


def run(body, x):
    """The body's kernel on a CUDA tensor, its plain version on a CPU
    one."""
    global launches
    if x.device.type == "cpu":
        return PLAIN[body](x)
    if (x.device.type != "cuda" or x.dtype != torch.float32
            or tuple(x.shape) != (16, 128) or not x.is_contiguous()):
        raise ValueError("probe_mosaic2 takes a contiguous (16, 128) "
                         f"float32 CUDA tensor, not {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    out = torch.empty_like(x)
    common.probe_call("rt_probe_mosaic2", list(BODIES).index(body),
                      x.data_ptr(), out.data_ptr())
    launches += 1
    return out


def measure(device, blocks=3):
    """Each body once (untimed). Returns {body: {"out"}}."""
    x = inputs(device)
    return {b: {"out": run(b, x)} for b in BODIES}


def check(res):
    """{body: True where the output equals the plain version's bit for
    bit} of a measure() result."""
    x = inputs(next(iter(res.values()))["out"].device)
    return {b: bool(torch.equal(r["out"], PLAIN[b](x)))
            for b, r in res.items()}


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_mosaic2")
    common.add_args(p)
    args = p.parse_args(argv)
    device = common.device_of(args, "probe_mosaic2")
    print(f"card: {common.card(device)}", flush=True)
    res = measure(device)
    for b, ok in check(res).items():
        print(f"{BODIES[b]}: {'OK' if ok else 'WRONG'}  "
              f"{float(res[b]['out'].reshape(-1)[0]):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
