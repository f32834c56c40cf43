"""Correctness probes of the pair kernel's constructs on the card (port of
experiments/probe_mosaic.py, whose bodies asked whether Mosaic compiles
them right on the TPU: a dot broadcast, a dynamic roll, dynamic stores
into scratch, SMEM, a while loop inside a cond, an argmin over lanes).

Every body takes the (16, 128) float32 input arange(2048) / 7 and writes a
(16, 128) float32 output. On a CUDA tensor run() launches the body's CUDA
kernel (csrc/probes.cu: dot one output a thread, the others one block);
on a CPU tensor it takes the plain version. main() runs each body once
and prints the JAX file's line, with OK where the kernel's output equals
the plain version's bit for bit, on that input and on adversarial()'s
(where a NaN's payload is the card's own: same_bits()).

Usage: python -m rodent_tpu_torch.experiments.probe_mosaic [--cpu]
    [--against DIR [DIR ...]]
--against times each body in turns with each other checkout's (its
rodent_tpu_torch/csrc/probes.cu, built under common.AGAINST_BUILD) at one
launch as CUDA-graph replays, every output bit for bit equal; it needs
the card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import common

# body -> the name experiments/probe_mosaic.py:106-115 prints
BODIES = {"dot": "dot_broadcast", "dynroll": "dyn_roll",
          "dynstore": "dyn_store8", "dynstore_odd": "dyn_store34",
          "smem_dyn": "smem_dyn34", "nested": "nested_while_in_cond",
          "argmin_lane": "argmin_lane"}
HEAD = "dot"
launches = 0


def inputs(device="cpu"):
    """The probe's input, arange(2048) / 7 as (16, 128) float32 (:20)."""
    x = np.arange(128 * 16, dtype=np.float32).reshape(16, 128)
    return torch.from_numpy(x / np.float32(7.0)).to(device)


FLT_MAX = float(np.finfo(np.float32).max)


def adversarial(device="cpu"):
    """A seeded (16, 128) float32 input holding what can move a bit: +-inf,
    NaN, -0.0, +0.0, subnormals and values near FLT_MAX at random places
    among normal values (about 15% of them), and in row 0's lanes 32-39,
    one of the 8-lane blocks that dot sums, each of the finite ones once
    (some of row 0's blocks hold an inf or a NaN, others none)."""
    r = np.random.default_rng(24)
    x = (r.standard_normal((16, 128)) * 1e3).astype(np.float32)
    near = np.nextafter(np.float32(FLT_MAX), np.float32(0))
    specials = np.array(
        [np.inf, -np.inf, np.nan, -0.0, 0.0, 1e-45, -1e-45, 1e-40, -3e-39,
         FLT_MAX, -FLT_MAX, near], np.float32)
    mask = r.random((16, 128)) < 0.15
    x[mask] = r.choice(specials, int(mask.sum()))
    x[0, 32:40] = [-0.0, 1e-40, FLT_MAX, 0.0, -1e-45, near, -3e-39,
                   -FLT_MAX]
    return torch.from_numpy(x).to(device)


def same_bits(got, want):
    """Whether got equals want bit for bit where want is not NaN, and is
    NaN where want is (a NaN's payload is the producer's own)."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        torch.where(nan, 0, got.view(torch.int32)),
        torch.where(nan, 0, want.view(torch.int32))))


def _bits(x):
    return x.view(torch.int32)


def plain_dot(x):
    """k_dot (:31-43): the (16, 128) lhs of row 0's lanes 8r..8r+7 times a
    0/1 selector, the products summed over k in order."""
    k = torch.arange(128, device=x.device)
    sel = (k[:, None] % 8 == k[None, :] // 16).to(torch.float32)
    lhs = torch.where(k[None, :] // 8 == torch.arange(16, device=x.device)
                      [:, None], x[0:1, :], 0.0)
    acc = torch.zeros_like(x)
    for i in range(128):
        acc = acc + lhs[:, i:i + 1] * sel[i:i + 1, :]
    return acc


def plain_dot_by_blocks(x):
    """plain_dot as the kernel sums it: out[r, j] over the 8 terms k =
    8r..8r+7 alone, in order (csrc/probes.cu, mosaic_dot_kernel; the other
    120 terms are +0.0 and move no bit). CPU tests only."""
    blocks = x[0].reshape(16, 8)
    sel = (torch.arange(8, device=x.device)[:, None]
           == torch.arange(128, device=x.device)[None, :] // 16).to(x.dtype)
    acc = torch.zeros_like(x)
    for i in range(8):
        acc = acc + blocks[:, i:i + 1] * sel[i:i + 1, :]
    return acc


def plain_dynroll(x):
    """k_dynroll (:46-50): roll the bits by (x[0, 0] bits % 8) + 1 lanes."""
    s = int(_bits(x)[0, 0] % 8) + 1
    return torch.roll(_bits(x), s, 1).view(torch.float32)


def _dynstore(x, n):
    idx = int(_bits(x)[0, 1] % n)
    scr = torch.zeros(n, 128, dtype=x.dtype, device=x.device)
    scr[idx] = x[0] * 2.0
    return scr[idx:idx + 1].expand(16, 128).contiguous()


def plain_dynstore(x):
    """k_dynstore (:53-56): a dynamic row of an (8, 128) scratch."""
    return _dynstore(x, 8)


def plain_dynstore_odd(x):
    """k_dynstore_odd (:59-63): a dynamic row of a (34, 128) scratch."""
    return _dynstore(x, 34)


def plain_smem_dyn(x):
    """k_smem_dyn (:66-69): 7 stored at a dynamic SMEM word, added."""
    sm = torch.zeros(34, dtype=torch.int32, device=x.device)
    idx = int(_bits(x)[0, 1] % 34)
    sm[idx] = 7
    return x + sm[idx].to(torch.float32)


def plain_nested(x):
    """k_nested (:72-95): three adds of x on even steps, + 1 on odd."""
    acc = torch.zeros_like(x)
    for i in range(4):
        if i % 2 == 0:
            for _ in range(3):
                acc = acc + x
        else:
            acc = acc + 1.0
    return acc


def plain_argmin_lane(x):
    """k_argmin_lane (:98-103): the first lane holding row 0's minimum."""
    kr = x[0]
    lane = torch.where(kr <= kr.min(), torch.arange(128, device=x.device),
                       128).min()
    return torch.full_like(x, float(lane))


PLAIN = {b: globals()[f"plain_{b}"] for b in BODIES}


def bound(body):
    """One launch's bound: the (16, 128) input read and the output written,
    against dot's 16 x 128 x 128 products and adds."""
    ops = 2 * 16 * 128 * 128 if body == "dot" else 16 * 128
    return common.probe_bound_ms(ops, 2 * 16 * 128 * 4)


def launch(lib, body, x):
    """rt_probe_mosaic of the probes library lib (None: this tree's), on
    the current stream: (16, 128)."""
    out = torch.empty_like(x)
    common.probe_call("rt_probe_mosaic", list(BODIES).index(body),
                      x.data_ptr(), out.data_ptr(), lib=lib)
    return out


def run(body, x):
    """The body's kernel on a CUDA tensor, its plain version on a CPU
    one."""
    global launches
    if x.device.type == "cpu":
        return PLAIN[body](x)
    if (x.device.type != "cuda" or x.dtype != torch.float32
            or tuple(x.shape) != (16, 128) or not x.is_contiguous()):
        raise ValueError("probe_mosaic takes a contiguous (16, 128) float32 "
                         f"CUDA tensor, not {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    out = launch(None, body, x)
    launches += 1
    return out


def measure(device, blocks=3):
    """Each body once on inputs() and once on adversarial() (untimed; a
    body's time is the launch's, probe_mosaic --against). Returns {body:
    {"out", "adversarial"}}."""
    x, adv = inputs(device), adversarial(device)
    return {b: {"out": run(b, x), "adversarial": run(b, adv)}
            for b in BODIES}


def check(res):
    """{body: True where the output equals the plain version's bit for
    bit, and on adversarial() by same_bits()} of a measure() result."""
    device = next(iter(res.values()))["out"].device
    x, adv = inputs(device), adversarial(device)
    return {b: bool(torch.equal(r["out"], PLAIN[b](x)))
            and same_bits(r["adversarial"], PLAIN[b](adv))
            for b, r in res.items()}


def against(device, roots, blocks=3):
    """Each body in turns with each other checkout's at one launch, as
    CUDA-graph replays (common.against), on inputs(): every output bit for
    bit the other's and the plain version's. {body: {root: {"ms",
    "other_ms", "ratio"}}}."""
    libs = common.against_libraries("probes", roots)
    x = inputs(device)
    res = {}
    for j, body in enumerate(BODIES):
        if not torch.equal(run(body, x), PLAIN[body](x)):
            raise RuntimeError(f"probe_mosaic {body} differs from the plain "
                               "version")
        res[body] = common.against(
            lambda b=body: {"out": run(b, x)},
            {root: lambda b=body, lib=lib: {"out": launch(lib, b, x)}
             for root, lib in libs.items()},
            device, blocks, common.WARMUP_S if j == 0 else 0.0, graphs=True,
            what=f"probe_mosaic {body}")
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="probe_mosaic")
    common.add_args(p)
    p.add_argument("--against", nargs="+", metavar="DIR",
                   help="the roots of other checkouts whose bodies are "
                   "timed against this one's")
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    if args.cpu and args.against:
        p.error("--against times builds of a CUDA kernel: it needs the "
                "card")
    device = common.device_of(args, "probe_mosaic")
    print(f"card: {common.card(device)}", flush=True)
    if args.against:
        for body, by in against(device, args.against, args.blocks).items():
            print(f"{BODIES[body]}: " + "; ".join(
                f"{root} in turns: {r['other_ms']:.5f} -> {r['ms']:.5f} ms "
                f"({r['ratio']:.4f}x)" for root, r in by.items())
                + "; equal bit for bit", flush=True)
    res = measure(device)
    for b, ok in check(res).items():
        print(f"{BODIES[b]}: {'OK' if ok else 'WRONG'}  "
              f"{float(res[b]['out'].reshape(-1)[0]):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
