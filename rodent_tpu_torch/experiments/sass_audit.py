"""Instruction audit of the traversal kernels in the card's assembly (SASS):
the counterpart of experiments/asm_audit.py, which counted the Mosaic
vector ops of the TPU kernel's pop loop and split them into a fixed part
and a part that grows with the tile's rows.

For each instantiation the renderers and the measuring tools launch (K1,
bvh_traverse_kernel, at arity 8 with Tri8 and Tri24 rows, closest-hit and
any-hit; K2 on Tri24 rows and K3 on Tri8, closest-hit; K4,
bvh_traverse_option_kernel, its base and row_loads, closest-hit Tri8; K7,
bvh_ct_kernel, the carry-top body, closest-hit Tri8 with the fold and the
fused slab and with the sort and the unfused slab, any-hit Tri8 and
closest-hit Tri24 with the fold and the fused slab; K5,
bvh_tile_warp_kernel, at tile_rows 1 and 16; K6, bvh_pair_warp_kernel, at
2,048 rays) this tool prints:

- the opcode histogram of the traversal loop, split as asm_audit splits it:
  for K1-K4 and K7 the pop (the loop's head), the node path and the leaf
  path;
  for K5 and K6 the per-ray part (the loop over a thread's R rays, which
  grows with the tile's rows) against the fixed part of a pop, from the
  counts of the same kernel at R = 1 and R = 4 rays a thread (count = fixed
  + R x per ray);
- registers, the local stack frame and ptxas' spill bytes;
- an issue estimate per pop: the warp instructions a node pop and a leaf
  pop execute (a leaf's lane loop counted M / unroll times; the slab form,
  pure or mixed, that each tile of K5 takes; NOPs, the padding behind a
  branch, left out; a branch that skips code, such as a padded lane's,
  not followed, so the count is an upper bound), over the card's SMs x 4
  schedulers at the SM clock read after the timed runs, against the
  measured time per pop on hall-260K's 1M sorted primaries (ao rays for
  any-hit): K1-K3 and K7 launch time over their pops (as ablate_packet
  reports it; K7's pops from its counting instantiation), K5 and K6
  launched as ab_tile_body launches them, over their tile pops
  (chip_smoke.py phase 12 holds those launches against the plain version
  and K1). A warp runs every pop of its slowest ray (K1, K7: the warp's
  largest node and leaf pop counts) and every warp of a block runs every
  pop of its tile (K5, K6).

How: the "main", "options", "ct" and "tile" libraries are read with
cuobjdump -sass and
-res-usage. A copy of each is built with -lineinfo (which adds line
tables and leaves the code alone: the audit checks that both copies hold
the same instructions, opcode for opcode) and disassembled with nvdisasm
-gi, whose source lines, inlined call sites included, place each
instruction in the kernel's source: the block of `if (code > 0)` is the
node path, its else block the leaf path, the rest of the loop the pop;
in the while-while form of K7 and K4 the inner loops `while (code > 0)`
and `while (code < 0)` are the node and the leaf path, the rest of the
outer loop the pop. For K7 and K4 the issue estimate also counts each
path's runs under the warp model (experiments/ct_warp_model.py: the if-if
loop, the while-while loop and the busiest ray), from the plain version's
record of each ray's pop kinds (K4's: the legacy order's,
ct_warp_model.LEGACY), and the audit lists each region's loops.

Usage: python -m rodent_tpu_torch.experiments.sass_audit [--blocks 3]
    [--cpu [--tris 20000 --side 64]]
--cpu runs the measured side on the CPU at a small size (the plain
versions' pops per ray and per tile), since the CPU has no SASS.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from ..kernels import build
from ..traversal import api, packet
from . import ab_tile_body, common, ct_warp_model, measure_ct

LINEINFO = ("-lineinfo",)
# the libraries of the audited kernels
AUDITED = ("main", "options", "ct", "tile")
AUDIT_DIR = build.BUILD_DIR.parent / "sass_audit"
# Tri24 on hall: the big-scene row width on the scene whose pops the Tri8
# rows are measured on
TRI24_HALL = {"packet": 24, "leaf_threshold": 12}
# K7's default body: the min-fold and the fused slab
FOLD_FMA = {"select": "fold", "fma_slab": True}
# (label, library, kernel, template arguments, what is measured: build,
# any_hit, variant, K7's {"select", "fma_slab"} or (kernel, size)). K1-K3:
# <ANY_HIT, A, M, STACK, VAR> (VAR 0 K1, 1 K2, 2 K3; STACK the hall
# build's stack_cap, None here); K7: <ANY_HIT, A, M, STACK, SORT, FMA,
# COUNT, PF> (PF 0: K7 without the prefetch); K4: <ANY_HIT, M, STACK,
# OPT> (OPT the option's index in packet.OPTIONS; measured as "K4 " and
# the option); K5: <M, ANY_HIT, FRUSTUM, R>; K6: <ANY_HIT, R>
INSTANCES = (
    ("K1 closest Tri8", "main", "bvh_traverse_kernel", (0, 8, 8, None, 0),
     ("tri8", False, "K1")),
    ("K1 any-hit Tri8", "main", "bvh_traverse_kernel", (1, 8, 8, None, 0),
     ("tri8", True, "K1")),
    ("K1 closest Tri24", "main", "bvh_traverse_kernel", (0, 8, 24, None, 0),
     ("tri24", False, "K1")),
    ("K1 any-hit Tri24", "main", "bvh_traverse_kernel", (1, 8, 24, None, 0),
     ("tri24", True, "K1")),
    ("K2 closest Tri24", "main", "bvh_traverse_kernel", (0, 8, 24, None, 1),
     ("tri24", False, "K2")),
    ("K3 closest Tri8", "main", "bvh_traverse_kernel", (0, 8, 8, None, 2),
     ("tri8", False, "K3")),
    ("K4 base closest Tri8", "options", "bvh_traverse_option_kernel",
     (0, 8, None, packet.OPTIONS.index("base")), ("tri8", False, "K4 base")),
    ("K4 row_loads closest Tri8", "options", "bvh_traverse_option_kernel",
     (0, 8, None, packet.OPTIONS.index("row_loads")),
     ("tri8", False, "K4 row_loads")),
    ("K7 closest Tri8 fold fma", "ct", "bvh_ct_kernel",
     (0, 8, 8, None, 0, 1, 0, 0), ("tri8", False, FOLD_FMA)),
    ("K7 closest Tri8 sort nofma", "ct", "bvh_ct_kernel",
     (0, 8, 8, None, 1, 0, 0, 0),
     ("tri8", False, {"select": "sort", "fma_slab": False})),
    ("K7 any-hit Tri8 fma", "ct", "bvh_ct_kernel",
     (1, 8, 8, None, 0, 1, 0, 0), ("tri8", True, FOLD_FMA)),
    ("K7 closest Tri24 fold fma", "ct", "bvh_ct_kernel",
     (0, 8, 24, None, 0, 1, 0, 0), ("tri24", False, FOLD_FMA)),
    ("K5 rows 1", "tile", "bvh_tile_warp_kernel", (8, 0, 0, 1),
     ("tri8", False, ("K5", 1))),
    ("K5 rows 16", "tile", "bvh_tile_warp_kernel", (8, 0, 0, 4),
     ("tri8", False, ("K5", 16))),
    ("K6 tile 2048", "tile", "bvh_pair_warp_kernel", (0, 4),
     ("tri8", False, ("K6", 2048))),
)
# the R = 1 instantiation each tile kernel's per-ray fit takes beside R = 4
FIT_R1 = {"bvh_tile_warp_kernel": (8, 0, 0, 1), "bvh_pair_warp_kernel": (0, 1)}
SOURCES = {"bvh_traverse_kernel": "bvh_traverse.cu",
           "bvh_traverse_option_kernel": "bvh_traverse.cu",
           "bvh_ct_kernel": "bvh_ct.cu",
           "bvh_tile_warp_kernel": "bvh_tile.cu",
           "bvh_pair_warp_kernel": "bvh_tile.cu"}
SCHEDULERS = 4      # warp schedulers per SM, one issue a cycle each
REGIONS = ("pop", "node", "node pure", "node mixed", "leaf")


def demangle(name):
    """(kernel, template arguments) of a mangled name of one of SOURCES'
    kernels, such as
    _ZN12_GLOBAL__N_119bvh_traverse_kernelILb0ELi8ELi8ELi64ELi0EEEvNS_4ArgsE
    (bool and int arguments), or None for another function."""
    for kernel in SOURCES:
        m = re.search(rf"{len(kernel)}{kernel}I((?:L[bi]n?\d+E)+)E", name)
        if m:
            return kernel, tuple(
                -int(v) if neg else int(v)
                for neg, v in re.findall(r"L[bi](n?)(\d+)E", m.group(1)))
    return None


def _match_brace(lines, i):
    """The (0-based) line of the brace that closes the last '{' on line
    i."""
    depth = 0
    col = lines[i].rindex("{")
    for j in range(i, len(lines)):
        text = lines[j][col:] if j == i else lines[j]
        for ch in text:
            depth += (ch == "{") - (ch == "}")
            if depth == 0:
                return j
    raise ValueError(f"no closing brace for line {i + 1}")


def kernel_regions(src_text, kernel):
    """The kernel's blocks in its source, as 1-based inclusive line ranges:
    {"body", "loop", "node", "leaf"}, and the lines of "node pure" and
    "node mixed" (K5's calls of its two slab forms; empty elsewhere). The
    loop is the kernel's outer loop; in the if-if form (`if (code > 0)
    {...} else {...}`) the node and leaf paths are its two blocks, in the
    while-while form (K7: `while (code > 0) {...}` then `while (code < 0)
    {...}`) its two inner loops."""
    lines = src_text.splitlines()
    start = next(i for i, s in enumerate(lines)
                 if re.search(rf"\b{kernel}\(Args a\) {{", s))
    end = _match_brace(lines, start)
    loop = next(i for i in range(start, end)
                if re.search(r"while \((?:sp > 0|code != 0)\) \{|"
                             r"for \(;;\) \{", lines[i]))
    loop_end = _match_brace(lines, loop)
    node = next(i for i in range(loop, loop_end)
                if re.search(r"\b(?:if|while) \(code > 0", lines[i]))
    node_end = _match_brace(lines, node)
    if lines[node].lstrip().startswith("while"):
        leaf = next((i for i in range(node_end + 1, loop_end)
                     if re.search(r"\bwhile \(code < 0\) \{", lines[i])),
                    None)
        if leaf is None:
            raise ValueError(f"{kernel}: the node loop is not followed by a "
                             "leaf loop")
        node_lines = (node + 1, node_end + 1)
    else:
        leaf = node_end
        if "else" not in lines[leaf]:
            raise ValueError(f"{kernel}: the node block is not followed by "
                             "an else block")
        node_lines = (node + 1, leaf)
    leaf_end = _match_brace(lines, leaf)

    def calls(form):
        return {i + 1 for i in range(node, node_end)
                if re.search(rf"node_keys<R, ANY_HIT, {form}>", lines[i])}
    return {"body": (start + 1, end + 1), "loop": (loop + 1, loop_end + 1),
            "node": node_lines, "leaf": (leaf + 1, leaf_end + 1),
            "node pure": calls("true"), "node mixed": calls("false")}


def _constant(src_text, kernel, tok):
    """The value of an unroll or width token: a number or a named
    constexpr int of the source."""
    if tok.isdigit():
        return int(tok)
    c = re.search(rf"constexpr int {tok} = (\d+);", src_text)
    if c is None:
        raise ValueError(f"{kernel}: constant {tok} not found")
    return int(c.group(1))


def lane_unroll(src_text, kernel):
    """The lanes of a row that one trip of the leaf's lane loop tests: the
    unroll of `for (int l = 0; l < M; ++l)` (`#pragma unroll N` or a named
    constant before it), or of a loop over groups of W lanes read by one
    wide load each, `for (int q = 0; q < M / W; ++q)`, times W; within the
    kernel's leaf block if it has such a loop, else the helper's."""
    lines = src_text.splitlines()
    reg = kernel_regions(src_text, kernel)
    pats = (re.compile(r"#pragma unroll (\w+)\s*\n\s*for \(int l = 0; "
                       r"l < M; \+\+l\)"),
            re.compile(r"#pragma unroll (\w+)\s*\n\s*for \(int q = 0; "
                       r"q < M / (\w+); \+\+q\)"))
    lo, hi = reg["leaf"]
    leaf = "\n".join(lines[lo - 1:hi])
    m = next((m for text in (leaf, src_text) for pat in pats
              for m in [pat.search(text)] if m), None)
    if m is None:
        raise ValueError(f"{kernel}: no unrolled loop over a row's lanes")
    out = 1
    for tok in m.groups():
        out *= _constant(src_text, kernel, tok)
    return out


def region_of(frames, src_name, reg):
    """The region of an instruction from its source frames: the frame in
    the kernel's body (the instruction's own line, or the call site a
    helper was inlined at) in the node block ("node pure"/"node mixed" on
    K5's slab-form calls), the leaf block or the rest of the loop ("pop");
    "outside" in the body but not the loop; "unattributed" without such a
    frame."""
    lo, hi = reg["body"]
    line = next((n for f, n in frames
                 if Path(f).name == src_name and lo <= n <= hi), None)
    if line is None:
        return "unattributed"
    for form in ("node pure", "node mixed"):
        if line in reg[form]:
            return form
    for name in ("node", "leaf", "loop"):
        a, b = reg[name]
        if a <= line <= b:
            return "pop" if name == "loop" else name
    return "outside"


def audit_function(fn, src_text, src_name, kernel, m):
    """One instantiation's loop: {"count": {region: instructions},
    "hist": {region: Counter of opcodes}, "weighted": {region: executed
    instructions per pop of that region, NOPs left out}, "lane_loop":
    (instructions in the leaf's lane loop, its trips), "loops": {region:
    backward branches closing in it}, "unattributed":
    instructions without a frame between the loop's first and last
    instruction}. The lane loop is an innermost backward branch whose both
    ends are leaf instructions (in K7's while-while form the leaf loop
    holds it); its body runs M / lane_unroll times a leaf pop (every lane
    taken as valid)."""
    reg = kernel_regions(src_text, kernel)
    regions = [region_of(fr, src_name, reg) for _, _, fr in fn.insns]
    found = common.loops(fn)
    # a loop belongs to the region of its closing branch (its condition's
    # line); an instruction inside it whose line lies in the body outside
    # the kernel's loop (a value of the ray's set-up that the compiler
    # recomputes there) runs with it, innermost loop first
    branch_region = {b: r for (b, _, _), r in zip(fn.insns, regions)}
    for t, b in sorted(found, key=lambda tb: tb[1] - tb[0]):
        if branch_region[b] in REGIONS:
            regions = [branch_region[b] if r == "outside" and t <= a <= b
                       else r for (a, _, _), r in zip(fn.insns, regions)]
    addr_region = {a: r for (a, _, _), r in zip(fn.insns, regions)}
    trips = max(1, m // lane_unroll(src_text, kernel))
    nloops = Counter(addr_region[b] for _, b in found
                     if addr_region[b] in REGIONS)
    leafy = [(t, b) for t, b in found
             if addr_region.get(t) == "leaf" and addr_region.get(b) == "leaf"]
    inner = [(t, b) for t, b in leafy
             if not any(t <= t2 and b2 <= b and (t2, b2) != (t, b)
                        for t2, b2 in leafy)]
    count, hist, weighted = Counter(), {r: Counter() for r in REGIONS}, \
        Counter()
    lane = 0
    for (a, text, _), r in zip(fn.insns, regions):
        if r not in REGIONS:
            continue
        op = common.opcode(text)
        count[r] += 1
        hist[r][op] += 1
        in_lane = any(t <= a <= b for t, b in inner)
        lane += in_lane
        if op != "NOP":     # alignment padding behind a branch, not issued
            weighted[r] += trips if in_lane else 1
    looped = [a for (a, _, _), r in zip(fn.insns, regions) if r in REGIONS]
    lo, hi = (min(looped), max(looped)) if looped else (0, -1)
    stray = sum(1 for (a, _, _), r in zip(fn.insns, regions)
                if r == "unattributed" and lo <= a <= hi)
    return {"count": dict(count), "hist": hist, "weighted": dict(weighted),
            "lane_loop": (lane, trips if inner else 1),
            "loops": {r: nloops[r] for r in REGIONS if nloops[r]},
            "unattributed": stray}


def per_pop(a):
    """Executed warp instructions of a node pop by slab form ("node",
    "node pure", "node mixed": the pop, the node path and that form's
    calls) and of a leaf pop ("leaf"), from audit_function's result."""
    w = a["weighted"]
    pop, node = w.get("pop", 0), w.get("node", 0)
    out = {"node": pop + node + w.get("node pure", 0)
           + w.get("node mixed", 0),
           "leaf": pop + w.get("leaf", 0)}
    if w.get("node pure") or w.get("node mixed"):
        out["node pure"] = pop + node + w.get("node pure", 0)
        out["node mixed"] = pop + node + w.get("node mixed", 0)
    return out


def per_ray_fit(r1, r4):
    """Per-ray and fixed instructions of each region from the counts at
    R = 1 and R = 4 rays a thread (count = fixed + R x per ray), and the
    opcode histograms of both parts."""
    out = {}
    for r in REGIONS:
        c1, c4 = r1["count"].get(r, 0), r4["count"].get(r, 0)
        if not (c1 or c4):
            continue
        ray = (c4 - c1) / 3
        h1, h4 = r1["hist"][r], r4["hist"][r]
        ops = set(h1) | set(h4)
        ray_h = {o: (h4[o] - h1[o]) / 3 for o in ops if h4[o] != h1[o]}
        fix_h = {o: h1[o] - ray_h.get(o, 0.0) for o in ops}
        out[r] = {"per_ray": ray, "fixed": c1 - ray, "per_ray_hist": ray_h,
                  "fixed_hist": {o: v for o, v in fix_h.items() if v}}
    return out


def res_usage(lib_path):
    """{function: {"REG", "STACK", "SHARED", "LOCAL", ...}} of a library,
    from cuobjdump -res-usage."""
    return parse_res_usage(subprocess.run(
        [common.sass_tool("cuobjdump"), "-res-usage", str(lib_path)],
        capture_output=True, text=True, check=True).stdout)


def parse_res_usage(text):
    """{function: {resource: count}} of a cuobjdump -res-usage listing
    ("Function <name>:" then "REG:47 STACK:256 SHARED:0 LOCAL:0 ...")."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            cur = m.group(1)
            continue
        if cur and "REG:" in line:
            out[cur] = {k: int(v) for k, v in
                        re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line)}
            cur = None
    return out


def spills(nvcc_log):
    """{function: (spill store bytes, spill load bytes)} from ptxas -v."""
    out, cur = {}, None
    for line in nvcc_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if cur and m:
            out[cur] = (int(m.group(1)), int(m.group(2)))
            cur = None
    return out


def build_lineinfo(kind):
    """(path, ptxas' output) of the library `kind` built with -lineinfo
    under AUDIT_DIR. The output is kept beside the library, so a build
    made earlier (chip_smoke.py starts it with the others) is read back."""
    path, log = build.build(AUDIT_DIR, kind, LINEINFO)
    return path, build.kept_log(path) if log is None else log


def lineinfo_listing(kind):
    """(nvdisasm -gi listing of the library `kind` built with -lineinfo,
    ptxas' output of that build)."""
    path, log = build_lineinfo(kind)
    work = AUDIT_DIR / f"{path.stem}_cubin"
    work.mkdir(parents=True, exist_ok=True)
    subprocess.run([common.sass_tool("cuobjdump"), "-xelf", "all",
                    str(path)], cwd=work, capture_output=True, check=True)
    cubins = sorted(work.glob("*.cubin"))
    if not cubins:
        raise RuntimeError(f"cuobjdump -xelf found no cubin in {path}")
    text = "\n".join(subprocess.run(
        [common.sass_tool("nvdisasm"), "-gi", str(c)], capture_output=True,
        text=True, check=True).stdout for c in cubins)
    return text, log


def static_audit(stack):
    """The static half for every instantiation and the R = 1 copies of the
    fits: {label: {"name", "audit", "regs", "stack", "spills", "fit"}}.
    stack: {"tri8": cap, "tri24": cap} fills K1-K3's STACK argument."""
    want = {}
    for label, kind, kernel, targs, (bld, _, _) in INSTANCES:
        targs = tuple(stack[bld] if a is None else a for a in targs)
        want[label] = (kind, kernel, targs)
        if kernel in FIT_R1:
            want[f"{kernel} R1"] = (kind, kernel, FIT_R1[kernel])
    out = {}
    for kind in sorted({k for k, _, _ in want.values()}):
        prod_path = build.build(kind=kind)[0]
        prod = common.read_sass(prod_path)
        usage = res_usage(prod_path)
        text, log = lineinfo_listing(kind)
        lined = common.parse_sass(text)
        spill = spills(log)
        by_key = {demangle(n): n for n in prod}
        for label, (k, kernel, targs) in want.items():
            if k != kind:
                continue
            name = by_key.get((kernel, targs))
            if name is None or name not in lined:
                raise RuntimeError(f"{label}: {kernel}<{targs}> is not in "
                                   f"the {kind} library")
            a_ops = [common.opcode(t, True) for _, t, _ in prod[name].insns]
            b_ops = [common.opcode(t, True) for _, t, _ in lined[name].insns]
            if a_ops != b_ops:
                raise RuntimeError(f"{label}: the -lineinfo build's SASS "
                                   "differs from the library's")
            src = build.CSRC / SOURCES[kernel]
            m = targs[2] if kernel in ("bvh_traverse_kernel",
                                       "bvh_ct_kernel") else (
                targs[0] if kernel == "bvh_tile_warp_kernel" else
                targs[1] if kernel == "bvh_traverse_option_kernel" else 8)
            out[label] = {"name": name, "kernel": kernel, "targs": targs,
                          "audit": audit_function(lined[name],
                                                  src.read_text(),
                                                  src.name, kernel, m),
                          "regs": usage.get(name, {}).get("REG"),
                          "stack": usage.get(name, {}).get("STACK"),
                          "spills": spill.get(name)}
    for label, r in out.items():
        if r["kernel"] in FIT_R1 and r["targs"][-1] == 4:
            r["fit"] = per_ray_fit(out[f"{r['kernel']} R1"]["audit"],
                                   r["audit"])
    return out


def issue_ms(warp_instr, mhz, sms):
    """Issue time of warp_instr warp instructions on `sms` SMs of
    SCHEDULERS issues a cycle at mhz, in ms."""
    return warp_instr / (sms * SCHEDULERS * mhz * 1e6) * 1e3


def measure(device, blocks=3, tris=None, side=1024):
    """The measured side on hall (Tri8 and Tri24 builds; sorted primaries,
    ao rays for any-hit): {label: {"ms", "pops", "node", "leaf", and for
    K1-K3 the warps' largest node and leaf pops "warp_node", "warp_leaf"
    and "warps"; for K5/K6 per-tile node pops on pure and mixed tiles,
    leaf pops and the block's warps}}, the SM clock (now, max) read after
    the timed runs (None on the CPU) and each build's stack cap
    (packet.stack_cap, K1-K3's STACK)."""
    scenes, stack = {}, {}
    for bld, cfg in (("tri8", common.TRI8), ("tri24", TRI24_HALL)):
        verts, idx, dev, _ = common.load("hall", cfg, device, tris)
        dists = common.distributions("hall", verts, idx, dev, side, device,
                                     ("primary", "ao"))
        scenes[bld] = (dev, dists)
        stack[bld] = packet.stack_cap(dev)
    res, first, kinds = {}, True, {}
    for label, _, _, _, (bld, any_hit, what) in INSTANCES:
        dev, dists = scenes[bld]
        comps = dists["ao" if any_hit else "primary"][0]
        n = comps[4].shape[0]
        if isinstance(what, tuple):
            kernel, size = what
            tile = 128 * size if kernel == "K5" else size

            def run_tile(dev=dev, comps=comps, kernel=kernel, size=size):
                return ab_tile_body.launch(dev, comps, kernel, any_hit, size)
            ms, out = common.timed(run_tile, device, blocks,
                                   warmup_s=common.WARMUP_S if first else 0.0)
            first = False
            st = common.tile_stats(out, tile, n)
            node = (out["pops"] - out["leaf_pops"]).double()
            pure = (api.tile_purity(comps[2], size) if kernel == "K5"
                    else torch.zeros_like(node, dtype=torch.bool))
            pure = pure.to(node.device)
            res[label] = {
                "ms": ms, "pops": st["pops"], "node": st["node"],
                "leaf": st["leaf"], "node_pure": float(node[pure].sum()),
                "node_mixed": float(node[~pure].sum()),
                "warps": min(tile, 512) // 32}
            continue
        option = (what[3:] if isinstance(what, str)
                  and what.startswith("K4 ") else None)
        if isinstance(what, dict):
            def run(dev=dev, comps=comps, body=what):
                return measure_ct.call(dev, comps, body, any_hit)
        elif option:
            def run(dev=dev, comps=comps, option=option):
                return common.counted(dev, comps, any_hit, option)
        else:
            kw = {"prefetch": what == "K2", "count_pops": what == "K3"}

            def run(kw=kw, dev=dev, comps=comps):
                return packet.traverse_packet_components(
                    dev, *comps, any_hit=any_hit, **kw)
        ms, _ = common.timed(run, device, blocks,
                             warmup_s=common.WARMUP_S if first else 0.0)
        first = False
        st = common.pop_stats(
            measure_ct.call(dev, comps, what, any_hit, True)
            if isinstance(what, dict) else
            common.counted(dev, comps, any_hit, option))
        res[label] = {"ms": ms, "pops": st["pops"], "node": st["node"],
                      "leaf": st["leaf"], "warp_node": st["warp_node"],
                      "warp_leaf": st["warp_leaf"],
                      "warps": -(-n // common.WARP)}
        if isinstance(what, dict) or option:
            # every K4 instance on these rays pops the same sequence
            body = ct_warp_model.LEGACY[any_hit] if option else what
            key = (bld, any_hit, tuple(sorted(body.items())))
            if key not in kinds:
                kinds[key] = ct_warp_model.warp_counts(
                    ct_warp_model.kinds(dev, comps, any_hit, body))
            res[label]["model"] = kinds[key]
    clock = common.sm_clock_mhz() if device.type == "cuda" else None
    return res, clock, stack


def estimate(static, meas, mhz, sms):
    """Warp instructions of the measured run and their issue time:
    {"instr", "issue_ms", "issue_ns_pop", "ns_pop", "share"}."""
    pp = per_pop(static["audit"])
    if "warp_node" in meas:
        instr = meas["warps"] * (meas["warp_node"] * pp["node"]
                                 + meas["warp_leaf"] * pp["leaf"])
    else:
        node = (meas["node_pure"] * pp.get("node pure", pp["node"])
                + meas["node_mixed"] * pp.get("node mixed", pp["node"]))
        instr = meas["warps"] * (node + meas["leaf"] * pp["leaf"])
    iss = issue_ms(instr, mhz, sms)
    out = {"instr": instr, "issue_ms": iss,
           "issue_ns_pop": iss * 1e6 / meas["pops"],
           "ns_pop": meas["ms"] * 1e6 / meas["pops"],
           "share": iss / meas["ms"], "per_pop": pp}
    if "model" in meas:
        # K7, K4: the warp model's path runs under each loop form
        out["rules"] = {}
        for rule, v in ct_warp_model.instructions(
                meas["model"], pp["node"], pp["leaf"]).items():
            ms = issue_ms(v, mhz, sms)
            out["rules"][rule] = {"instr": v, "issue_ms": ms,
                                  "share": ms / meas["ms"]}
    return out


def _top(hist, k=8):
    items = sorted(hist.items(), key=lambda kv: -kv[1])[:k]
    return ", ".join(f"{o} {v:g}" for o, v in items)


def report(label, s, meas=None, est=None, mhz=None):
    """The lines of one instantiation."""
    a = s["audit"]
    sp = s["spills"]
    lines = [f"{label} ({s['kernel']}<{','.join(map(str, s['targs']))}>): "
             f"{s['regs']} registers, {s['stack']} B stack frame (local), "
             + (f"{sp[0]} B spill stores, {sp[1]} B spill loads"
                if sp else "spills not reported")]
    c = a["count"]
    lines.append("  loop instructions: " + ", ".join(
        f"{r} {c[r]}" for r in REGIONS if r in c)
        + f"; leaf lane loop {a['lane_loop'][0]} x {a['lane_loop'][1]} "
        f"trips; {a['unattributed']} without a source line; loops by "
        "region: " + (", ".join(
            f"{r} {k}" for r, k in a["loops"].items()) or "none"))
    if "fit" in s:
        for r, f in s["fit"].items():
            lines.append(f"  {r}: per ray {f['per_ray']:g} ({_top(f['per_ray_hist'])}); "
                         f"fixed {f['fixed']:g} ({_top(f['fixed_hist'])})")
    else:
        for r in REGIONS:
            if a["hist"][r]:
                lines.append(f"  {r}: {_top(a['hist'][r], 10)}")
    pp = per_pop(a)
    lines.append("  warp instructions per pop: " + ", ".join(
        f"{k} {v:g}" for k, v in pp.items()))
    if meas and est:
        lines.append(
            f"  measured: {meas['ms']:.4f} ms, {meas['pops']} pops "
            f"({meas['node']} node, {meas['leaf']} leaf), "
            f"{est['ns_pop']:.4f} ns per pop; issue estimate "
            f"{est['issue_ms']:.4f} ms at {mhz:g} MHz "
            f"({est['issue_ns_pop']:.4f} ns per pop, {est['instr']:.4g} warp "
            f"instructions): {est['share']:.1%} of the time")
    if meas and "model" in meas:
        md, w = meas["model"], meas["model"]["warps"]
        runs = []
        for rule in ct_warp_model.RULES:
            text = (f"{rule} {md[rule]['node'] / w:.3f} / "
                    f"{md[rule]['leaf'] / w:.3f}")
            if est:
                e = est["rules"][rule]
                text += f", issue {e['issue_ms']:.4f} ms ({e['share']:.1%})"
            runs.append(text)
        lines.append("  warp model, path runs a warp (node / leaf): "
                     + "; ".join(runs))
    return lines


def run(device, blocks=3, tris=None, side=1024):
    """The audit: {label: {"static", "measured", "estimate"}}, its report
    lines printed; on the CPU the measured side only."""
    meas, clock, stack = measure(device, blocks, tris, side)
    print(f"card: {common.card(device)}", flush=True)
    if device.type != "cuda":
        for label, m in meas.items():
            print(f"{label}: {m['pops']} pops ({m['node']} node, "
                  f"{m['leaf']} leaf) on the plain version; SASS not read "
                  "(no card)", flush=True)
            if "model" in m:
                for line in ct_warp_model.report(label, m["model"])[1:]:
                    print(line, flush=True)
        return {label: {"measured": m} for label, m in meas.items()}
    mhz = clock[0] if clock[0] > 0 else clock[1]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"SM clock after the timed runs {clock[0]:g} MHz (max "
          f"{clock[1]:g}), {sms} SMs x {SCHEDULERS} schedulers", flush=True)
    static = static_audit(stack)
    out = {}
    for label, *_ in INSTANCES:
        est = estimate(static[label], meas[label], mhz, sms)
        for line in report(label, static[label], meas[label], est, mhz):
            print(line, flush=True)
        out[label] = {"static": static[label], "measured": meas[label],
                      "estimate": est}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="sass_audit")
    common.add_args(p)
    p.set_defaults(blocks=3)
    p.add_argument("--tris", type=int, default=None,
                   help="hall's size (default 260,000)")
    p.add_argument("--side", type=int, default=1024,
                   help="side x side rays")
    args = p.parse_args(argv)
    device = common.device_of(args, "sass_audit")
    run(device, args.blocks, args.tris, args.side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
