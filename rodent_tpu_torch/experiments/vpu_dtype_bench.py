"""The element-wise op rate of the card's CUDA cores per type (port of
experiments/vpu_dtype_bench.py, which asked whether bf16 doubles the TPU
VPU's rate on the slab test's op mix).

ITERS = 2000 rounds of x = min(max(x * c1 - c2, x), c3) (mul, sub, max,
min) on a (rows, 128) array of ones: float32 and bfloat16 at 64 and 256
rows, int32 and int16 at 256. The constants are the JAX file's 1.000001,
0.5 and 100 in the type (1, 0 and 100 in the int types, 1.0, 0.5 and 100
in bfloat16); the kernel takes them as arguments so that nvcc cannot fold
x * 1 or x - 0 away. float32 and int32 hold one value a 32-bit word,
bfloat16 a packed __nv_bfloat162, int16 a packed pair (subtract, max and
min through the SIMD intrinsics, the multiply in 32-bit registers). Each
case runs at two launch shapes: one copy (the TPU's one program) and as
many copies as fill the card. Beside each rate stands the count of
instructions per word and iteration read from the kernel's SASS
(cuobjdump -sass of the probes library).

The card's body (csrc/probes.cu, vpu_kernel) gives each thread WORDS
words, independent chains whose rounds it interleaves operation by
operation, in blocks of THREADS threads; sass_counts() divides the loop
by the unroll x the words a thread (loop_shape(), read from the source).
A copy is whole blocks of BLOCK_WORDS words, 16 blocks an SM. issue_ms()
is the least time of the type's instructions at the card's issue rate,
from CYCLES, each type's issue floor read from its SASS.

The values stay 1 in every type, so the card's bfloat16 (each operation
rounded once) and torch's (through float32) agree here.

On a CUDA tensor run() launches the type's kernel; on a CPU tensor it
takes the plain version. Nothing runs at import.

Usage: python -m rodent_tpu_torch.experiments.vpu_dtype_bench [--cpu]
    [--blocks 3] [--against DIR [DIR ...]]
--against times this tree's kernel against each other checkout's (its
rodent_tpu_torch/csrc/probes.cu, built under common.AGAINST_BUILD) in
turns at one copy, at the other's full shape and at this one's, every
output bit for bit equal; it needs the card, and first prints each tree's
registers, spills and SASS counts.
"""
from __future__ import annotations

import argparse
import re
import sys
from collections import Counter
from pathlib import Path

import torch

from ..kernels import build
from . import common

ITERS = 2000
# csrc/probes.cu's kVpuWords and kVpuThreads: the launch geometry
WORDS, THREADS = 2, 128
BLOCK_WORDS = WORDS * THREADS
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


def words_of(dtype, rows):
    """The 32-bit words of one (rows, 128) copy of the type."""
    return rows * 128 * DTYPES[dtype][1].itemsize // 4


def launch(lib, dtype, x, copies):
    """rt_probe_vpu of the probes library lib (None: this tree's) on
    `copies` copies, on the current stream: (copies, rows, 128)."""
    out = torch.empty(copies, *x.shape, dtype=x.dtype, device=x.device)
    common.probe_call("rt_probe_vpu", DTYPES[dtype][0], x.data_ptr(),
                      out.data_ptr(), words_of(dtype, x.shape[0]), copies,
                      *const_bits(dtype), lib=lib)
    return out


def run(dtype, x, copies=1):
    """(copies, rows, 128) of the type: the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    global launches
    if x.device.type == "cpu":
        return plain(dtype, x)[None].expand(copies, *x.shape)
    if (x.device.type != "cuda" or x.dtype != DTYPES[dtype][1]
            or x.dim() != 2 or x.shape[1] != 128 or not x.is_contiguous()
            or words_of(dtype, x.shape[0]) % BLOCK_WORDS):
        raise ValueError(f"vpu_dtype_bench {dtype}: a contiguous (rows, "
                         f"128) CUDA tensor of that type with a multiple of "
                         f"{BLOCK_WORDS} words, not {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    out = launch(None, dtype, x, copies)
    launches += 1
    return out


def loop_shape(root=None):
    """(unroll, words a thread) of vpu_kernel in the csrc/probes.cu of
    the checkout at root (this tree's by default): a body from before the
    words had one word a thread."""
    csrc = Path(root) / "rodent_tpu_torch" / "csrc" if root else build.CSRC
    text = (csrc / "probes.cu").read_text()
    words = re.search(r"\bkVpuWords = (\d+)", text)
    return (int(re.search(r"\bkVpuUnroll = (\d+)", text)[1]),
            int(words[1]) if words else 1)


def sass_counts(lib_path=None, funcs=None, shape=None):
    """{dtype: (instructions per word and iteration, Counter of their
    opcodes, the loop's own share)} read from the SASS of the probes
    library's vpu kernels: the instructions of the loop body (between the
    backward branch and its target) less the branch, the loop's compare
    and the counter's update (in a register or a uniform one), over
    shape's unroll x words a thread (loop_shape() of the library's tree,
    this tree's by default); the loop's own share is those three's part
    of the loop's instructions. funcs: the library's common.read_sass,
    where the caller has read it."""
    funcs = funcs or common.read_sass(
        lib_path or build.library_path(kind="probes"))
    shape = shape or loop_shape()
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
        loop = [b for a, b, _ in fn.insns if start <= a <= end]
        cmp_ = [b for b in loop
                if common.opcode(b).startswith(("ISETP", "UISETP"))]
        counter = set(re.findall(r"\bU?R\d+\b", " ".join(cmp_)))
        ops = Counter()
        for b in loop:
            op = common.opcode(b, full=True)
            dest = re.findall(r"\bU?R\d+\b", b)[:1]
            if (op.startswith(("ISETP", "UISETP", "BRA", "NOP"))
                    or (dest and dest[0] in counter
                        and op.startswith(("IADD", "VIADD", "UIADD")))):
                continue
            ops[op] += 1
        n = sum(ops.values())
        out[dtype] = (n / (shape[0] * shape[1]), ops, 1.0 - n / len(loop))
    return out


def resources(lib_path=None, funcs=None):
    """{dtype: {"regs", "spills" (bytes stored and loaded)}} of every
    vpu_kernel of a probes library (this tree's by default;
    common.probe_kernels)."""
    names = {n: d for d, (n, _) in DTYPES.items()}
    return {names[t]: {"regs": r["regs"], "spills": r["spills"]}
            for t, r in common.probe_kernels(r"vpu_kernelILi(\d+)EE",
                                             lib_path, funcs).items()}


def bound(dtype, rows, copies):
    """The full launch's bound: 4 operations per value and iteration over
    the type's peak (int16 against the int32 rate); the input read once
    and the outputs written."""
    n = rows * 128
    size = DTYPES[dtype][1].itemsize
    return common.probe_bound_ms(4 * ITERS * n * copies,
                                 n * size * (1 + copies), dtype)


# Each type's issue floor, SM cycles an SM sub-partition (SMSP, one warp
# instruction a cycle) spends on one warp's word for one iteration, from
# the SASS of each type's loop (sass_counts) and the pipes its opcodes
# issue to: FMUL, FADD, HMUL2, HADD2 and HFMA2 take 1 cycle a warp, IMAD
# and the ALU's FMNMX, HMNMX2, VIMNMX, VIADDMNMX and LOP3 2.
# float32: FMUL, FADD, two FMNMX: 4 issued, the ALU 4 cycles.
# bfloat16: HMUL2 and HADD2 (or HFMA2 for either), two HMNMX2: 4, 4.
# int32: IMAD (the multiply and the subtract), two VIMNMX: 3 issued, the
# ALU 4 cycles.
# int16: two IMAD and two LOP3 (the multiply), VIADDMNMX (the subtract and
# the max), VIMNMX: 6 issued, the ALU 8 cycles.
CYCLES = {"float32": 4, "bfloat16": 4, "int32": 4, "int16": 8}


def issue_ms(dtype, rows, copies, sms, mhz):
    """The least time of the launch's instructions at the type's issue
    floor (CYCLES, SM cycles a warp's word and iteration on one of an
    SM's 4 sub-partitions), its blocks spread over `sms` SMs in whole
    waves and an SM's warps over its sub-partitions, at mhz."""
    blocks = copies * words_of(dtype, rows) // BLOCK_WORDS
    warps = -(-(-(-blocks // sms) * THREADS // 32) // 4)
    return warps * WORDS * ITERS * CYCLES[dtype] / (mhz * 1e3)


def against(device, roots, blocks=3):
    """Every case in turns with each other checkout's kernel
    (common.probe_against), every output bit for bit the other's and the
    plain version's. {(dtype, rows): {(root, copies): {"ms", "other_ms",
    "ratio"}}}."""
    xs = {case: inputs(*case, device) for case in CASES}
    want = {case: plain(case[0], x) for case, x in xs.items()}
    return common.probe_against(
        "vpu", CASES, lambda case: DTYPES[case[0]][0],
        lambda case, c: {"out": run(case[0], xs[case], c)},
        lambda lib, case, c: {"out": launch(lib, case[0], xs[case], c)},
        lambda case, out: bool(torch.equal(
            out["out"], want[case].expand_as(out["out"]))),
        device, roots, blocks,
        per_block=lambda case: BLOCK_WORDS / words_of(*case))


def measure(device, blocks=3):
    """Every case at both launch shapes: {(dtype, rows):
    common.probe_shapes()'s keys, "bound", "iters", "tops" (the JAX file's
    4 operations per value over the full launch's time)}."""
    res = {}
    for dtype, rows in CASES:
        x = inputs(dtype, rows, device)
        if device.type == "cuda":
            full, per_sm = common.full_copies(
                "vpu", DTYPES[dtype][0],
                per_block=BLOCK_WORDS / words_of(dtype, rows))
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


def sass_line(counts):
    """A type's SASS count as printed: per word and iteration, opcodes,
    the loop's own share."""
    per, ops, own = counts
    return (f"{per:g} SASS instructions per word and iteration "
            f"({dict(ops)}), the loop's own {own:.2%}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="vpu_dtype_bench")
    common.add_args(p)
    p.add_argument("--against", nargs="+", metavar="DIR",
                   help="the roots of other checkouts whose kernel is timed "
                   "against this one's, every case")
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    if args.cpu and args.against:
        p.error("--against times builds of a CUDA kernel: it needs the "
                "card")
    device = common.device_of(args, "vpu_dtype_bench")
    print(f"card: {common.card(device)}", flush=True)
    if args.against:
        libs = {"this tree": (None, None)} | {root: (common.other_library(
            root, "probes")._name, root) for root in args.against}
        for label, (path, root) in libs.items():
            funcs = common.read_sass(path or build.library_path(
                kind="probes"))
            res = resources(path, funcs)
            sass = sass_counts(funcs=funcs, shape=loop_shape(root))
            for dtype in DTYPES:
                print(f"{label} {dtype}: {res[dtype]['regs']} registers, "
                      f"spills {res[dtype]['spills']}; "
                      f"{sass_line(sass[dtype])}", flush=True)
        for (dtype, rows), by in against(device, args.against,
                                         args.blocks).items():
            print(f"{dtype:>9} rows={rows:>4}: " + "; ".join(
                f"{root} {c} copies in turns: {r['other_ms']:.4f} -> "
                f"{r['ms']:.4f} ms ({r['ratio']:.4f}x)"
                for (root, c), r in by.items()) + "; equal bit for bit",
                flush=True)
    res = measure(device, args.blocks)
    ok = check(res)
    sass = sass_counts() if device.type == "cuda" else {}
    clock = (torch.cuda.get_device_properties(device).multi_processor_count,
             common.sm_clock_mhz()[1]) if device.type == "cuda" else None
    for (dtype, rows), r in res.items():
        per = (sass_line(sass[dtype]) if dtype in sass
               else "SASS not read (no card build)")
        issue = "" if clock is None else (
            f", {issue_ms(dtype, rows, r['copies'], *clock) / r['ms']:.1%} "
            f"of the issue rate at {clock[1]:g} MHz")
        print(f"{dtype:>9} rows={rows:>4}: {r['ms1'] * 1e3:8.1f} us -> "
              f"{r['tops1']:6.3f} Top/s one copy; {r['tops']:7.3f} Top/s "
              f"with {r['copies']} copies; bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}), {r['ms']:.4f} ms, "
              f"{r['bound'][0] / r['ms']:.1%} of it{issue}; {per}; "
              f"{'OK' if ok[(dtype, rows)] else 'WRONG'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
