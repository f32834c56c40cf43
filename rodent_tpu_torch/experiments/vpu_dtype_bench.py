"""The element-wise op rate of the card's CUDA cores per type (port of
experiments/vpu_dtype_bench.py, which asked whether bf16 doubles the TPU
VPU's rate on the slab test's op mix).

ITERS = 2000 rounds of x = min(max(x * c1 - c2, x), c3) (mul, sub, max,
min) on a (rows, 128) array of ones: float32 and bfloat16 at 64 and 256
rows, int32 and int16 at 256. The constants are the JAX file's 1.000001,
0.5 and 100 in the type (1, 0 and 100 in the int types, 1.0, 0.5 and 100
in bfloat16); the kernel takes them as arguments so that nvcc cannot fold
x * 1 or x - 0 away. One thread per 32-bit word: float32 and int32 one
value, bfloat16 a packed __nv_bfloat162, int16 a packed pair (subtract,
max and min through the SIMD intrinsics, the multiply in 32-bit
registers). Each case runs at two launch shapes: one copy (the TPU's one
program) and as many copies as fill the card. Beside each rate stands the
count of instructions per word and iteration read from the kernel's SASS
(cuobjdump -sass of the probes library; the loop is unrolled by 8).

The values stay 1 in every type, so the card's bfloat16 (each operation
rounded once) and torch's (through float32) agree here.

On a CUDA tensor run() launches the type's kernel (csrc/probes.cu); on a
CPU tensor it takes the plain version.

Usage: python -m rodent_tpu_torch.experiments.vpu_dtype_bench [--cpu]
    [--blocks 3]
"""
from __future__ import annotations

import argparse
import re
import sys
from collections import Counter

import torch

from ..kernels import build
from . import common

ITERS, UNROLL = 2000, 8
DTYPES = {"float32": (0, torch.float32), "bfloat16": (1, torch.bfloat16),
          "int32": (2, torch.int32), "int16": (3, torch.int16)}
# experiments/vpu_dtype_bench.py:39-41
CASES = [("float32", 64), ("bfloat16", 64), ("float32", 256),
         ("bfloat16", 256), ("int32", 256), ("int16", 256)]
HEAD = ("float32", 256)
CONSTS = (1.000001, 0.5, 100.0)
launches = 0


def inputs(dtype, rows, device="cpu"):
    """main's input (:42): ones of the type."""
    return torch.ones(rows, 128, dtype=DTYPES[dtype][1], device=device)


def constants(dtype):
    """c1, c2, c3 as 0-d tensors of the type, as jnp.asarray makes them
    (a float to an int type truncates: 1, 0, 100)."""
    t = DTYPES[dtype][1]
    if t.is_floating_point:
        return [torch.tensor(c, dtype=t) for c in CONSTS]
    return [torch.tensor(int(c), dtype=t) for c in CONSTS]


def const_bits(dtype):
    """The constants as the kernel takes them: a 32-bit word each, a
    packed pair for the 16-bit types."""
    out = []
    for c in constants(dtype):
        if c.element_size() == 4:
            out.append(int(c.reshape(1).view(torch.int32)) & 0xFFFFFFFF)
        else:
            h = int(c.reshape(1).view(torch.int16)) & 0xFFFF
            out.append(h | (h << 16))
    return out


def plain(dtype, x):
    """make's loop (:21-27) in the type: each operation in torch's
    arithmetic for it."""
    c1, c2, c3 = (c.to(x.device) for c in constants(dtype))
    for _ in range(ITERS):
        a = x * c1
        b = a - c2
        c = torch.maximum(b, x)
        x = torch.minimum(c, c3)
    return x


def run(dtype, x, copies=1):
    """(copies, rows, 128) of the type: the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    global launches
    if x.device.type == "cpu":
        return plain(dtype, x)[None].expand(copies, *x.shape)
    rows = x.shape[0]
    words = rows * 128 * x.element_size() // 4
    if (x.device.type != "cuda" or x.dtype != DTYPES[dtype][1]
            or x.dim() != 2 or x.shape[1] != 128 or not x.is_contiguous()
            or words % 256):
        raise ValueError(f"vpu_dtype_bench {dtype}: a contiguous (rows, "
                         f"128) CUDA tensor of that type with a multiple of "
                         f"256 words, not {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    out = torch.empty(copies, rows, 128, dtype=x.dtype, device=x.device)
    common.probe_call("rt_probe_vpu", DTYPES[dtype][0], x.data_ptr(),
                      out.data_ptr(), words, copies, *const_bits(dtype))
    launches += 1
    return out


def sass_counts(lib_path=None, funcs=None):
    """{dtype: (instructions per word and iteration, Counter of their
    opcodes)} read from the SASS of the probes library's vpu kernels: the
    instructions of the loop body (between the backward branch and its
    target) less the branch, the loop's compare and the counter's update,
    over the unroll of 8. funcs: the library's common.read_sass, where the
    caller has read it."""
    funcs = funcs or common.read_sass(
        lib_path or build.library_path(kind="probes"))
    out = {}
    for name, fn in funcs.items():
        m = re.search(r"vpu_kernelILi(\d)E", name)
        if not m:
            continue
        dtype = next(d for d, (n, _) in DTYPES.items() if n == int(m[1]))
        back = common.loops(fn)
        if not back:
            raise RuntimeError(f"no loop in the {dtype} kernel's SASS")
        start, end = back[-1]
        loop = [b for a, b, _ in fn.insns if start <= a < end]
        cmp_ = [b for b in loop if common.opcode(b).startswith("ISETP")]
        counter = set(re.findall(r"\bR\d+\b", " ".join(cmp_)))
        ops = Counter()
        for b in loop:
            op = common.opcode(b, full=True)
            dest = re.findall(r"\bR\d+\b", b)[:1]
            if (op.startswith(("ISETP", "BRA", "NOP"))
                    or (dest and dest[0] in counter
                        and op.startswith(("IADD", "VIADD")))):
                continue
            ops[op] += 1
        out[dtype] = (sum(ops.values()) / UNROLL, ops)
    return out


def bound(dtype, rows, copies):
    """The full launch's bound: 4 operations per value and iteration over
    the type's peak (int16 against the int32 rate); the input read once
    and the outputs written."""
    n = rows * 128
    size = DTYPES[dtype][1].itemsize
    return common.probe_bound_ms(4 * ITERS * n * copies,
                                 n * size * (1 + copies), dtype)


def measure(device, blocks=3):
    """Every case at both launch shapes: {(dtype, rows):
    common.probe_shapes()'s keys, "bound", "iters", "tops" (the JAX file's
    4 operations per value over the full launch's time)}."""
    res = {}
    for dtype, rows in CASES:
        x = inputs(dtype, rows, device)
        if device.type == "cuda":
            words = rows * 128 * x.element_size() // 4
            full, per_sm = common.full_copies(
                "vpu", DTYPES[dtype][0], per_block=256 / words)
        else:
            full, per_sm = 1, 1.0
        r = common.probe_shapes(lambda c: run(dtype, x, c), device, full,
                                per_sm, ITERS, blocks)
        ops = 4 * ITERS * rows * 128
        r.update(bound=bound(dtype, rows, full), iters=ITERS,
                 tops1=ops / r["ms1"] / 1e9, tops=ops * full / r["ms"] / 1e9)
        res[(dtype, rows)] = r
    return res


def check(res):
    """{(dtype, rows): True where both shapes' every copy equals the plain
    version bit for bit}."""
    device = next(iter(res.values()))["out"].device
    ok = {}
    for (dtype, rows), r in res.items():
        want = plain(dtype, inputs(dtype, rows, device))
        ok[(dtype, rows)] = all(bool(torch.equal(o, want.expand_as(o)))
                                for o in (r["out1"], r["out"]))
    return ok


def main(argv=None):
    p = argparse.ArgumentParser(prog="vpu_dtype_bench")
    common.add_args(p)
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    device = common.device_of(args, "vpu_dtype_bench")
    print(f"card: {common.card(device)}", flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    sass = sass_counts() if device.type == "cuda" else {}
    for (dtype, rows), r in res.items():
        per = (f"{sass[dtype][0]:g} SASS instructions per word and "
               f"iteration ({dict(sass[dtype][1])})" if dtype in sass
               else "SASS not read (no card build)")
        print(f"{dtype:>9} rows={rows:>4}: {r['ms1'] * 1e3:8.1f} us -> "
              f"{r['tops1']:6.3f} Top/s one copy; {r['tops']:7.3f} Top/s "
              f"with {r['copies']} copies; bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}), {r['ms']:.4f} ms; {per}; "
              f"{'OK' if ok[(dtype, rows)] else 'WRONG'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
