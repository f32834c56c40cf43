"""The port's last measuring programs on the CPU: the SASS reader shared by
vpu_dtype_bench and sass_audit on listings written here (the card's
cuobjdump and nvdisasm formats), sass_audit's regions, lane-loop weights,
per-ray fit and issue estimate, tree_stats against the JAX function,
the sort keys of probe_crown_sort and measure_sorts against the JAX
files' own code (parsed, since those files run their work in main), and
each program's --cpu run at a tiny size. Integers, keys and permutations
are held bit for bit; tree_stats' floats exactly, since both run the
same numpy arithmetic on one BVH."""
import ast
import json
import os
import re
from collections import Counter

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rodent_tpu.accel import build_bvh as jbuild_bvh
from rodent_tpu.traversal.sorting import _morton10, ray_octant
from rodent_tpu_torch.accel import build_bvh
from rodent_tpu_torch.experiments import (attribute_crown, common,
                                          measure_sorts, probe_crown_sort,
                                          sass_audit, vpu_dtype_bench)
from rodent_tpu_torch.kernels import build
from rodent_tpu_torch.utils import testscenes

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "/src/rodent_tpu_torch/csrc/bvh_traverse.cu"


def test_parse_sass_both_formats():
    """cuobjdump -sass (a "Function :" header, hex branch targets) and
    nvdisasm -gi (".text." headers, labels, source lines; several line
    records before one instruction add up): instructions, opcodes with
    and without their predicate and modifiers, branch targets, loops."""
    cuobjdump = """
	code for sm_90a
		Function : _Z3fooPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */
        /*0010*/                   FMUL R2, R0, 2 ;
        /*0020*/              @!P0 FSETP.GT.AND P1, PT, R2, R3, PT ;
        /*0030*/               @P1 BRA 0x10 ;
        /*0040*/                   EXIT ;
        /*0050*/                   BRA 0x50;
"""
    f = common.parse_sass(cuobjdump)["_Z3fooPf"]
    assert [a for a, _, _ in f.insns] == [0, 16, 32, 48, 64, 80]
    assert common.opcode(f.insns[2][1]) == "FSETP"
    assert common.opcode(f.insns[2][1], full=True) == "FSETP.GT.AND"
    assert common.branch_target(f, f.insns[3][1]) == 16
    assert common.branch_target(f, f.insns[1][1]) is None
    assert common.loops(f) == [(16, 48)]       # the end's trap is none
    nvdisasm = f"""
.text._Z3barv:
_Z3barv:
	//## File "{SRC}", line 245
        /*0000*/                   S2R R5, SR_CTAID.X ;
.L_x_1:
	//## File "{SRC}", line 183 inlined at "{SRC}", line 247
	//## File "{SRC}", line 247
        /*0010*/                   IMAD.SHL.U32 R22, R2, 0x4, RZ ;
        /*0020*/               @P0 BRA `(.L_x_1) ;
"""
    g = common.parse_sass(nvdisasm)["_Z3barv"]
    assert g.labels == {".L_x_1": 16}
    assert g.insns[0][2] == ((SRC, 245),)
    assert g.insns[1][2] == ((SRC, 183), (SRC, 247), (SRC, 247))
    assert g.insns[2][2] == g.insns[1][2]
    assert common.loops(g) == [(16, 32)]


def test_vpu_sass_counts_on_a_listing(monkeypatch):
    """vpu_dtype_bench.sass_counts on the shared reader: the float32 loop
    body unrolled 8 times, 4 operations a word each, less the loop's
    compare, its counter and the branch: 4 per word and iteration."""
    body = "".join(
        f"        /*{0x100 + 0x40 * i:04x}*/  FMUL R{i}, R{i}, R20 ;\n"
        f"        /*{0x110 + 0x40 * i:04x}*/  FADD R{i}, R{i}, -R21 ;\n"
        f"        /*{0x120 + 0x40 * i:04x}*/  FMNMX R{i}, R{i}, R30, !PT ;\n"
        f"        /*{0x130 + 0x40 * i:04x}*/  FMNMX R{i}, R{i}, R22, PT ;\n"
        for i in range(8))
    listing = ("\t\tFunction : _Z10vpu_kernelILi0EEvPKfPfxijjj\n"
               "        /*0000*/  MOV R9, RZ ;\n" + body +
               "        /*0300*/  IADD3 R9, R9, 0x8, RZ ;\n"
               "        /*0310*/  ISETP.GE.AND P0, PT, R9, 0x7d0, PT ;\n"
               "        /*0320*/  @!P0 BRA 0x100 ;\n"
               "        /*0330*/  EXIT ;\n")
    monkeypatch.setattr(common, "read_sass",
                        lambda path: common.parse_sass(listing))
    counts = vpu_dtype_bench.sass_counts("unused", shape=(8, 1))
    assert counts["float32"][0] == 4
    assert counts["float32"][1] == Counter({"FMUL": 8, "FADD": 8,
                                            "FMNMX": 16})


def _vpu_chains_listing(words, counter):
    """A float32 vpu loop of `words` chains a thread unrolled 8 times, the
    rounds interleaved operation by operation (R0..R{words-1}), closed by a
    counter (counter "R": IADD3 and ISETP on R9; "UR": UIADD3 and UISETP
    on UR4, the uniform datapath)."""
    lines, a = [], 0x100
    for _ in range(8):
        for op, src in (("FMUL", "R20"), ("FADD", "-R21"),
                        ("FMNMX", "R30, !PT"), ("FMNMX", "R22, PT")):
            for w in range(words):
                lines.append(f"        /*{a:04x}*/  {op} R{w}, R{w}, {src} ;")
                a += 0x10
    if counter == "R":
        lines += [f"        /*{a:04x}*/  IADD3 R9, R9, 0x8, RZ ;",
                  f"        /*{a + 0x10:04x}*/  ISETP.GE.AND P0, PT, R9, "
                  "0x7d0, PT ;",
                  f"        /*{a + 0x20:04x}*/  @!P0 BRA 0x100 ;"]
    else:
        lines += [f"        /*{a:04x}*/  UIADD3 UR4, UR4, 0x8, URZ ;",
                  f"        /*{a + 0x10:04x}*/  UISETP.GE.AND UP0, UPT, UR4, "
                  "0x7d0, UPT ;",
                  f"        /*{a + 0x20:04x}*/  @!UP0 BRA 0x100 ;"]
    return ("\t\tFunction : _Z10vpu_kernelILi0EEvPKjPjxjjj\n"
            "        /*0000*/  MOV R9, RZ ;\n" + "\n".join(lines)
            + f"\n        /*{a + 0x30:04x}*/  EXIT ;\n")


@pytest.mark.parametrize("words,counter", [(4, "R"), (4, "UR"), (2, "R")])
def test_vpu_sass_counts_divide_by_the_chains(monkeypatch, words, counter):
    """sass_counts divides the loop by the unroll and by the words a
    thread (its shape), so a loop of `words` interleaved chains unrolled 8
    times still reads as 4 instructions per float32 word and iteration;
    the counter's update, compare and branch are left out whether the
    counter is a register or a uniform one, and are the loop's own share:
    3 of the loop's instructions."""
    listing = _vpu_chains_listing(words, counter)
    monkeypatch.setattr(common, "read_sass",
                        lambda path: common.parse_sass(listing))
    per, ops, own = vpu_dtype_bench.sass_counts("unused", shape=(8, words))[
        "float32"]
    assert per == 4
    assert ops == Counter({"FMUL": 8 * words, "FADD": 8 * words,
                           "FMNMX": 16 * words})
    assert own == pytest.approx(3 / (32 * words + 3), rel=1e-12)
    # read with the one-word shape of the body before the chains
    assert vpu_dtype_bench.sass_counts("unused", shape=(8, 1))[
        "float32"][0] == 4 * words


def test_vpu_loop_shape_reads_each_trees_source(tmp_path):
    """loop_shape reads the unroll and the words a thread from a tree's
    csrc/probes.cu; a body from before the words has one."""
    assert vpu_dtype_bench.loop_shape()[1] == vpu_dtype_bench.WORDS
    csrc = tmp_path / "rodent_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "probes.cu").write_text(
        "constexpr int kVpuIters = 2000, kVpuUnroll = 8;\n")
    assert vpu_dtype_bench.loop_shape(tmp_path) == (8, 1)


def _k1_listing(reg, fname):
    """A fake K1 loop in nvdisasm -gi's form: 2 pop instructions, 5 node
    ones (one of them inlined from a helper), a leaf of 1 instruction
    before a lane loop of 3 (its backward branch among them), 1 NOP, and
    a prologue outside the loop."""
    pop = reg["loop"][0]
    node = reg["node"][0] + 2
    leaf = reg["leaf"][0] + 3
    rows = [(reg["body"][0] + 3, "LDC R1, c[0x0][0x28]", ())]
    rows += [(pop, "ISETP.GT.AND P0, PT, R3, RZ, PT", ()),
             (pop, "LDL R4, [R1]", ())]
    rows += [(node, op, ()) for op in ("FADD R5, R5, R6", "FMUL R5, R5, R7",
                                       "FMNMX R5, R5, R8, PT",
                                       "FMNMX R5, R5, R9, !PT")]
    rows += [(190, "FSETP.GTU.AND P1, PT, R5, R6, PT", (node,))]
    rows += [(leaf, "LDG.E.CONSTANT R10, desc[UR4][R12.64]", ()),
             ("loop", "FMUL R11, R10, R10", ()),
             (leaf, "FADD R11, R11, R10", ()),
             (leaf, "@P2 BRA `(.L_x_9)", ()),
             (leaf, "NOP", ())]
    text = [".text._Zk1:", "_Zk1:"]
    for i, (line, ins, inl) in enumerate(rows):
        if line == "loop":
            text.append(".L_x_9:")
            line = leaf
        if inl:
            text.append(f'\t//## File "{fname}", line {line} inlined at '
                        f'"{fname}", line {inl[0]}')
            text.append(f'\t//## File "{fname}", line {inl[0]}')
        else:
            text.append(f'\t//## File "{fname}", line {line}')
        text.append(f"        /*{0x10 * i:04x}*/  {ins} ;")
    return "\n".join(text)


def test_sass_audit_regions_on_a_listing():
    """sass_audit's regions from the kernel's own source (the loop, the
    block of `if (code > 0)`, its else block; K5's two slab-form calls),
    the leaf's lane loop weighted M / unroll times, NOPs counted but not
    issued, and the warp instructions of a node and a leaf pop."""
    src = (build.CSRC / "bvh_traverse.cu").read_text()
    reg = sass_audit.kernel_regions(src, "bvh_traverse_kernel")
    assert reg["body"][0] < reg["loop"][0] < reg["node"][0] < reg["leaf"][0]
    assert reg["leaf"][1] < reg["loop"][1] < reg["body"][1]
    assert sass_audit.lane_unroll(src, "bvh_traverse_kernel") == 4
    tile = (build.CSRC / "bvh_tile.cu").read_text()
    treg = sass_audit.kernel_regions(tile, "bvh_tile_warp_kernel")
    assert len(treg["node pure"]) == len(treg["node mixed"]) == 1
    assert sass_audit.lane_unroll(tile, "bvh_pair_warp_kernel") == 4
    fname = "/any/path/bvh_traverse.cu"
    fn = common.parse_sass(_k1_listing(reg, fname))["_Zk1"]
    a = sass_audit.audit_function(fn, src, "bvh_traverse.cu",
                                  "bvh_traverse_kernel", 8)
    assert a["count"] == {"pop": 2, "node": 5, "leaf": 5}
    assert a["hist"]["node"] == Counter({"FMNMX": 2, "FADD": 1, "FMUL": 1,
                                         "FSETP": 1})
    assert a["lane_loop"] == (3, 2)
    # leaf: 1 + 3 x 2 trips, the NOP left out
    assert a["weighted"] == {"pop": 2, "node": 5, "leaf": 7}
    assert sass_audit.per_pop(a) == {"node": 7, "leaf": 9}
    a24 = sass_audit.audit_function(fn, src, "bvh_traverse.cu",
                                    "bvh_traverse_kernel", 24)
    assert a24["weighted"]["leaf"] == 1 + 3 * 6


def test_sass_audit_fit_estimate_and_parsers():
    """The per-ray fit (count = fixed + R x per ray from R = 1 and 4), the
    issue estimate of a measured run, the mangled names of the three
    kernels, and the res-usage and ptxas spill lines."""
    r1 = {"count": {"node": 100, "leaf": 50},
          "hist": {r: Counter() for r in sass_audit.REGIONS}}
    r4 = {"count": {"node": 130, "leaf": 110},
          "hist": {r: Counter() for r in sass_audit.REGIONS}}
    r1["hist"]["node"].update({"FMUL": 10, "LDG": 90})
    r4["hist"]["node"].update({"FMUL": 40, "LDG": 90})
    fit = sass_audit.per_ray_fit(r1, r4)
    assert fit["node"]["per_ray"] == 10 and fit["node"]["fixed"] == 90
    assert fit["node"]["per_ray_hist"] == {"FMUL": 10}
    assert fit["node"]["fixed_hist"] == {"LDG": 90}
    assert fit["leaf"]["per_ray"] == 20 and fit["leaf"]["fixed"] == 30
    static = {"audit": {"weighted": {"pop": 10, "node": 290, "leaf": 500}}}
    meas = {"ms": 1.0, "pops": 1_000_000, "warps": 1000,
            "warp_node": 300.0, "warp_leaf": 20.0}
    est = sass_audit.estimate(static, meas, 1000.0, 100)
    assert est["instr"] == 1000 * (300 * 300 + 20 * 510)
    assert est["issue_ms"] == pytest.approx(
        est["instr"] / (100 * 4 * 1e9) * 1e3)
    assert est["share"] == pytest.approx(est["issue_ms"] / 1.0)
    assert est["ns_pop"] == pytest.approx(1.0)
    assert sass_audit.demangle(
        "_ZN48_GLOBAL__N__3306fb65_15_bvh_traverse_cu_9d8585d119bvh_"
        "traverse_kernelILb0ELi8ELi24ELi128ELi2EEEvNS_4ArgsE") == (
        "bvh_traverse_kernel", (0, 8, 24, 128, 2))
    assert sass_audit.demangle(
        "_ZN12_GLOBAL__N_120bvh_tile_warp_kernelILi8ELb1ELb0ELi4EEEvNS_4"
        "ArgsE") == ("bvh_tile_warp_kernel", (8, 1, 0, 4))
    assert sass_audit.demangle("_Z3fooPf") is None
    usage = sass_audit.parse_res_usage(
        " Function _Zk1:\n  REG:47 STACK:256 SHARED:0 LOCAL:0 "
        "CONSTANT[0]:696 TEXTURE:0\n Function _Zk2:\n  REG:128 STACK:0\n")
    assert usage["_Zk1"]["REG"] == 47 and usage["_Zk1"]["STACK"] == 256
    assert usage["_Zk2"] == {"REG": 128, "STACK": 0}
    log = ("ptxas info    : Function properties for _Zk1\n"
           "    256 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\nptxas info    : Used 47 registers\n")
    assert sass_audit.spills(log) == {"_Zk1": (8, 4)}


def _jax_tree_stats():
    """The JAX file's tree_stats (experiments/attribute_crown.py:28),
    compiled from its source (the file's main runs TPU work)."""
    src = open(os.path.join(REPO, "experiments", "attribute_crown.py")).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "tree_stats")
    g = {"np": np}
    exec(compile(ast.Module([fn], []), "attribute_crown.py", "exec"), g)
    return g["tree_stats"]


def test_tree_stats_match_jax():
    """tree_stats on one small crown build (BVH8/Tri8) equals the JAX
    function's on the same build, and on the JAX package's own build of
    the same mesh (the two builders are byte-identical)."""
    verts, idx = testscenes.make_crown(20_000)
    kw = dict(arity=8, packet=8, leaf_threshold=12)
    bvh = build_bvh(verts, idx, **kw)
    jstats = _jax_tree_stats()
    got = attribute_crown.tree_stats(bvh, verts)
    assert got == jstats(bvh, verts)
    assert got == jstats(jbuild_bvh(verts, idx, **kw), verts)
    assert got["max_depth"] > 2 and 0 < got["lane_fill"] <= 1


def _main_node(path, name):
    src = open(os.path.join(REPO, "experiments", path)).read()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return [n for n in main.body if getattr(n, "name", None) == name or (
        isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "")
        == name)]


def test_probe_crown_sort_orders_match_jax():
    """sort_orders equals the JAX file's `orders` (evaluated from its
    source on the same arrays) permutation for permutation, on prim ids
    with misses and repeats and a cone key of uint32 values."""
    r = np.random.RandomState(4)
    n = 50_000
    pid = r.randint(-1, 3000, n).astype(np.int32)
    t = np.where(pid >= 0, r.rand(n) * 40, np.float32(3.4e38)).astype(
        np.float32)
    cone = r.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    (node,) = _main_node("probe_crown_sort.py", "orders")
    want = eval(compile(ast.Expression(node.value), "probe_crown_sort.py",
                        "eval"), {"np": np, "pid": pid, "tt": t,
                                  "cone": cone})
    got = probe_crown_sort.sort_orders(pid, t, cone)
    assert set(got) == set(want) == set(probe_crown_sort.ORDERS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_measure_sorts_keys_match_jax():
    """key_fn of every key equals the JAX file's key_fn (its closure
    compiled from the source, on jnp and the JAX package's _morton10 and
    ray_octant) bit for bit, axis-parallel directions included."""
    fns = _main_node("measure_sorts.py", "qmorton") + _main_node(
        "measure_sorts.py", "key_fn")
    r = np.random.RandomState(5)
    o = (r.rand(20_000, 3) * 10 - 3).astype(np.float32)
    d = r.randn(20_000, 3).astype(np.float32)
    d[:50, 1] = 0.0
    lo = o.min(0)
    hi = o.max(0)
    g = {"jnp": jnp, "np": np, "_morton10": _morton10,
         "ray_octant": ray_octant, "lo": lo, "hi": hi}
    exec(compile(ast.Module(fns, []), "measure_sorts.py", "exec"), g)
    for k in measure_sorts.ALL_KEYS:
        want = np.asarray(g["key_fn"](k, o, d))
        got = measure_sorts.key_fn(k, o, d, lo, hi)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want, err_msg=k)
    with pytest.raises(ValueError, match="unknown key"):
        measure_sorts.key_fn("oct", o, d, lo, hi)


TINY = ["--cpu", "--tris", "10000", "--side", "32", "--blocks", "1"]
PROGRAMS = {
    "sass_audit": (TINY, r"K5 rows 16: \d+ pops"),
    "attribute_crown": (TINY, r"crown: \d+ tris.*\n.*occupancy"),
    "ab_crown_build": (TINY + ["--variants", "q0-lt12-lc0.6"],
                       r"q0-lt12-lc0.6: \d+ nodes"),
    "probe_crown_sort": (TINY + ["--rows", "1", "--orders", "cone,t-bucket"],
                         r"t-bucket rows  1: K5"),
    "measure_sorts": (TINY + ["--rows", "1", "--keys", "oct+org",
                              "--dist", "ao"],
                      r"oct\+org rows  1:"),
    "waterfall_tiled": (TINY + ["--dist", "ao"], r"barebones:.*\n.*sb0-c5"),
    "measure_tiled_iters": (TINY, r"bounces:.*trips"),
    "sweep_arity_tiled": (TINY + ["--grid", "4x4"], r"bounces a4pk4:"),
    "probe_sb_depth": (TINY + ["--subs", "2"], r"sb2  -c5"),
    "bigscene_demo": (["--card"] + TINY, r"\[tiled\] .* hit fraction"),
    "measure_ct": (TINY, r"legacy .* K1 in turns .*\nct-fold .*\n"
                         r"ct-sort .*pops/ray [\d.]+ .*\nct-fold-nofma "),
    "ab_gather_take": (["--cpu", "--blocks", "1"],
                       r"axis0 \(65536, 128\): kernel .* torch\.gather .*"
                       r"\n.*axis1 \(65536, 128\)"),
    "ct_warp_model": (["--cpu", "--tris", "10000", "--side", "32",
                       "--instr", "8=316,775"],
                      r"hall interleaved ct-fold: 2048 rays, 64 warps.*\n"
                      r"  if-if .*\n  while-while .*outer trips/warp .*\n"
                      r"  busiest .*\n.*while-while / if-if [\d.]+\n"
                      r"(?:.*\n)*powerplant ao ct: 1024 rays"),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_cpu_run(name, capsys):
    """Each program's main() with --cpu at a tiny size: it runs the plain
    versions, prints the CPU's line in place of a card's and its report."""
    import importlib
    argv, pattern = PROGRAMS[name]
    mod = importlib.import_module(f"rodent_tpu_torch.experiments.{name}")
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "cpu: the plain torch version" in out
    assert re.search(pattern, out), out


def test_measure_ct_prefetch_cpu_run(capsys):
    """measure_ct --prefetch --cpu at a tiny powerplant: K7-PF's plain
    version (K7's) in turns with K7 and K2 on the three distributions,
    every variant, with pops per ray and the bound."""
    from rodent_tpu_torch.experiments import measure_ct
    assert measure_ct.main(TINY + ["--prefetch"]) == 0
    out = capsys.readouterr().out
    assert "cpu: the plain torch version" in out
    for kind, names in (("primary", measure_ct.VARIANTS),
                        ("bounces", measure_ct.VARIANTS),
                        ("ao", measure_ct.ANY_HIT_VARIANTS)):
        for name in names:
            assert re.search(rf"^{kind} \(1024 sorted rays\) {name}-pf +"
                             r"[\d.]+ ms; K7 in turns [\d.]+ ms: [\d.]+x; "
                             r"K2 in turns [\d.]+ ms: [\d.]+x; pops/ray "
                             r"[\d.]+ .* bound [\d.]+ ms", out, re.M), out


def test_measure_ct_against_refusals(tmp_path, capsys):
    """measure_ct --against takes one or more checkout roots and refuses
    the CPU (it times two builds of a CUDA kernel); other_library refuses
    a root without rodent_tpu_torch/csrc/bvh_ct.cu, naming it; the other
    tree's library name hashes its own source."""
    from rodent_tpu_torch.experiments import measure_ct
    other = tmp_path / "parent" / "rodent_tpu_torch" / "csrc"
    other.mkdir(parents=True)
    for name in ("bvh_ct.cu", *build.HEADERS):
        (other / name).write_bytes((build.CSRC / name).read_bytes())
    root = str(tmp_path / "parent")
    with pytest.raises(SystemExit):
        measure_ct.main(["--cpu", "--against", root])
    assert "needs the card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        measure_ct.main(["--cpu", "--against", root, str(tmp_path / "x")])
    assert "needs the card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        measure_ct.main(["--against"])
    with pytest.raises(FileNotFoundError, match="no K7 source"):
        common.other_library(tmp_path / "absent", "ct")
    here = build.library_path(tmp_path, "ct")
    assert build.library_path(tmp_path, "ct", csrc=other) == here
    with open(other / "bvh_ct.cu", "a") as f:
        f.write("// the parent's body\n")
    assert build.library_path(tmp_path, "ct", csrc=other) != here
    assert [scene for scene, _, _ in measure_ct.AGAINST] == ["hall",
                                                              "powerplant"]


def test_ablate_packet_against_refusals(tmp_path, capsys):
    """ablate_packet --against takes one or more checkout roots and refuses
    the CPU (it times two builds of a CUDA kernel), as measure_ct does;
    other_library(root, "options") refuses a root without
    rodent_tpu_torch/csrc/bvh_traverse.cu, naming K4; the other tree's
    options library name hashes its own source."""
    from rodent_tpu_torch.experiments import ablate_packet
    from rodent_tpu_torch.traversal import packet
    other = tmp_path / "parent" / "rodent_tpu_torch" / "csrc"
    other.mkdir(parents=True)
    for name in ("bvh_traverse.cu", *build.HEADERS):
        (other / name).write_bytes((build.CSRC / name).read_bytes())
    root = str(tmp_path / "parent")
    with pytest.raises(SystemExit):
        ablate_packet.main(["--cpu", "--against", root])
    assert "needs the card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        ablate_packet.main(["--cpu", "--against", root,
                            str(tmp_path / "x")])
    assert "needs the card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        ablate_packet.main(["--against"])
    with pytest.raises(FileNotFoundError, match="no K4 source"):
        common.other_library(tmp_path / "absent", "options")
    here = build.library_path(tmp_path, "options")
    assert build.library_path(tmp_path, "options", csrc=other) == here
    with open(other / "bvh_traverse.cu", "a") as f:
        f.write("// the parent's body\n")
    assert build.library_path(tmp_path, "options", csrc=other) != here
    assert [scene for scene, _ in ablate_packet.AGAINST] == ["hall",
                                                             "powerplant"]
    assert common.options_for(True) == [
        o for o in packet.OPTIONS if o != "nosort"]
    assert common.options_for(False, nonodetest=False) == [
        o for o in packet.OPTIONS if o != "nonodetest"]
    assert "base" in common.options_for(True)


def test_probe_body_against_refusals(tmp_path, capsys):
    """probe_body --against takes one or more checkout roots and refuses
    the CPU (it times two builds of a CUDA kernel), as ablate_packet does;
    other_library(root, "probes") refuses a root without
    rodent_tpu_torch/csrc/probes.cu, naming it; the other tree's probes
    library name hashes its own source."""
    from rodent_tpu_torch.experiments import probe_body
    other = tmp_path / "parent" / "rodent_tpu_torch" / "csrc"
    other.mkdir(parents=True)
    for name in ("probes.cu", *build.HEADERS):
        (other / name).write_bytes((build.CSRC / name).read_bytes())
    root = str(tmp_path / "parent")
    with pytest.raises(SystemExit):
        probe_body.main(["--cpu", "--against", root])
    assert "needs the card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        probe_body.main(["--cpu", "--against", root, str(tmp_path / "x")])
    assert "needs the card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        probe_body.main(["--against"])
    with pytest.raises(FileNotFoundError, match="no probes source"):
        common.other_library(tmp_path / "absent", "probes")
    here = build.library_path(tmp_path, "probes")
    assert build.library_path(tmp_path, "probes", csrc=other) == here
    with open(other / "probes.cu", "a") as f:
        f.write("// the parent's body\n")
    assert build.library_path(tmp_path, "probes", csrc=other) != here


@pytest.mark.parametrize("name", ["probe_mosaic3", "probe_dyn_cost",
                                  "probe_gather", "probe_chain",
                                  "probe_mosaic", "vpu_dtype_bench"])
def test_probe_against_refusals(tmp_path, capsys, name):
    """probe_mosaic3, probe_dyn_cost, probe_gather, probe_chain,
    probe_mosaic and vpu_dtype_bench --against take one or more checkout
    roots and refuse the CPU (they time two builds of a CUDA kernel), as
    probe_body does; against()
    refuses a root without rodent_tpu_torch/csrc/probes.cu, naming it,
    before it times anything."""
    import importlib
    m = importlib.import_module(f"rodent_tpu_torch.experiments.{name}")
    root = tmp_path / "parent"
    (root / "rodent_tpu_torch" / "csrc").mkdir(parents=True)
    for argv in (["--cpu", "--against", str(root)],
                 ["--cpu", "--against", str(root), str(tmp_path / "x")]):
        with pytest.raises(SystemExit):
            m.main(argv)
        assert "needs the card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        m.main(["--against"])
    with pytest.raises(FileNotFoundError, match="no probes source"):
        m.against(torch.device("cpu"), [str(root)])


def test_same_outputs_compares_the_outputs_both_have():
    """same_outputs holds the outputs that both trees give (an older
    body may lack one, as probe_chain's aux before it had one) and
    raises where they differ or share none."""
    x, y = torch.arange(4), torch.arange(4) + 1
    common.same_outputs({"out": x, "aux": y}, {"out": x.clone()}, "old")
    with pytest.raises(RuntimeError, match="old out differs"):
        common.same_outputs({"out": x, "aux": y}, {"out": y}, "old")
    with pytest.raises(RuntimeError, match="none of this body's outputs"):
        common.same_outputs({"aux": y}, {"out": x}, "old")


def test_against_times_in_turns_and_raises_on_a_difference():
    """common.against times each other call in turns with this one
    (other, this, this, other: four calls each) and returns this over the
    other; an output that differs in one bit raises, naming the root and
    the output, and so does same_outputs; scene_line names the Tri width
    from the table."""
    calls = []
    x = torch.arange(8, dtype=torch.float32)

    def run(name, t):
        def fn():
            calls.append(name)
            return {"t": t.clone(), "prim_id": t.to(torch.int32)}
        return fn
    cpu = torch.device("cpu")
    res = common.against(run("this", x), {"a": run("a", x),
                                          "b": run("b", x)}, cpu, blocks=1)
    assert calls == ["a", "this", "this", "a", "b", "this", "this", "b"]
    for root in ("a", "b"):
        assert res[root]["ratio"] == pytest.approx(
            res[root]["ms"] / res[root]["other_ms"])
    y = x.clone()
    y[3] = torch.nextafter(y[3], torch.tensor(9.0))
    with pytest.raises(RuntimeError, match="K4: old's t differs"):
        common.against(run("this", x), {"old": run("old", y)}, cpu,
                       blocks=1, what="K4")
    with pytest.raises(RuntimeError, match="prim_id differs"):
        common.same_outputs({"prim_id": x.to(torch.int32)},
                            {"prim_id": (x + 1).to(torch.int32)}, "K7")
    dev = {"nodes": torch.zeros(3, 56), "tris": torch.zeros(5, 14 * 24)}
    assert common.scene_line("powerplant", [0] * 40, dev, 1.25) == (
        "powerplant: 10 tris, 3 BVH8 nodes, 5 Tri24 rows (built in 1.2 s)")


def test_ct_warp_model_legacy_order(capsys):
    """ct_warp_model --legacy counts the legacy order's pops (K7 with the
    sort and without the fused slab; any-hit without it): on each of
    hall's distributions they are the plain version's K3 counters on the
    same rays, node and leaf pops."""
    from rodent_tpu_torch.experiments import ct_warp_model
    from rodent_tpu_torch.traversal import api
    cpu = torch.device("cpu")
    res = ct_warp_model.run(cpu, ("hall",), tris=10_000, side=32,
                            legacy=True)
    out = capsys.readouterr().out
    assert re.search(r"^hall ao legacy order \(K3\): 1024 rays, 32 warps",
                     out, re.M), out
    verts, idx, dev, _ = common.load("hall", common.TRI8, cpu, 10_000)
    dists = common.distributions("hall", verts, idx, dev, 32, cpu,
                                 ct_warp_model.SCENES["hall"][1])
    for kind, (comps, any_hit) in dists.items():
        k3 = api.traverse_components(dev, comps[0], comps[1], comps[2],
                                     comps[4], comps[5], any_hit=any_hit,
                                     count_pops=True)
        c = res[("hall", kind)]
        assert c["leaf_pops"] == int(k3["leaf_pops"].sum()), kind
        assert c["node_pops"] + c["leaf_pops"] == int(k3["pops"].sum())


def test_sass_audit_reads_k4s_while_while_loop():
    """K4 (bvh_traverse_option_kernel, in bvh_traverse.cu's options build)
    runs the while-while form: its regions are its first loop's node and
    leaf loops, ahead of kPops2's pair loops; a listing reads as K7's; its
    lanes are read four a trip; its mangled names carry the option's
    index (packet.OPTIONS)."""
    from rodent_tpu_torch.traversal import packet
    src = (build.CSRC / "bvh_traverse.cu").read_text()
    kernel = "bvh_traverse_option_kernel"
    reg = sass_audit.kernel_regions(src, kernel)
    lines = src.splitlines()
    assert lines[reg["loop"][0] - 1].strip() == "while (code != 0) {"
    assert lines[reg["node"][0] - 1].strip() == "while (code > 0) {"
    assert lines[reg["leaf"][0] - 1].strip() == "while (code < 0) {"
    assert (reg["body"][0] < reg["loop"][0] < reg["node"][1]
            < reg["leaf"][0] < reg["leaf"][1] < reg["loop"][1]
            < reg["body"][1])
    assert "c0" not in "\n".join(lines[reg["loop"][0]:reg["loop"][1]])
    assert sass_audit.lane_unroll(src, kernel) == 4
    fn = common.parse_sass(_ct_listing(reg, "/x/bvh_traverse.cu"))["_Zk7"]
    a = sass_audit.audit_function(fn, src, "bvh_traverse.cu", kernel, 8)
    assert a["count"] == {"pop": 2, "node": 4, "leaf": 5}
    assert sass_audit.per_pop(a) == {"node": 6, "leaf": 10}
    assert sass_audit.demangle(
        "_ZN12_GLOBAL__N_126bvh_traverse_option_kernelILb0ELi8ELi64ELi7EEEvN"
        "S_4ArgsE") == (kernel, (0, 8, 64, packet.OPTIONS.index("base")))
    labels = [i[0] for i in sass_audit.INSTANCES
              if i[2] == kernel]
    assert labels == ["K4 base closest Tri8", "K4 row_loads closest Tri8"]


def _ct_listing(reg, fname):
    """A fake K7 loop in nvdisasm -gi's form, the while-while form: an
    outer-loop instruction, a node loop of 4 (one of them recomputing a
    value of the ray's set-up, whose line lies before the loop; its
    backward branch last), a leaf loop of 5 holding a lane loop of 3, and
    the outer loop's branch."""
    pop, node, leaf = reg["loop"][0], reg["node"][0] + 2, reg["leaf"][0] + 3
    setup = reg["body"][0] + 20
    assert reg["body"][0] < setup < reg["loop"][0]
    rows = [(pop, None, "ISETP.NE.AND P0, PT, R3, RZ, PT"),
            (node, ".L_x_1", "LDG.E.128.CONSTANT R4, desc[UR4][R12.64]"),
            (setup, None, "FSETP.GE.AND P4, PT, R70, RZ, PT"),
            (node, None, "FMNMX R5, R4, R6, PT"),
            (node, None, "@P1 BRA `(.L_x_1)"),
            (leaf, ".L_x_2", "LDG.E.CONSTANT R10, desc[UR4][R14.64]"),
            (leaf, ".L_x_3", "LDG.E.128.CONSTANT R16, desc[UR4][R14.64]"),
            (leaf, None, "FMUL R11, R16, R17"),
            (leaf, None, "@P2 BRA `(.L_x_3)"),
            (leaf, None, "@P3 BRA `(.L_x_2)"),
            (pop, None, "@P0 BRA `(.L_x_1)")]
    text = [".text._Zk7:", "_Zk7:"]
    for i, (line, label, ins) in enumerate(rows):
        if label:
            text.append(f"{label}:")
        text.append(f'\t//## File "{fname}", line {line}')
        text.append(f"        /*{0x10 * i:04x}*/  {ins} ;")
    return "\n".join(text)


def test_sass_audit_reads_a_while_while_listing():
    """K7's while-while form: the node loop's and the leaf loop's
    instructions count once a pop, a set-up value recomputed in the node
    loop counts with it, only the innermost leaf loop (the lane loop) is
    weighted M / 4 times, and each loop counts in the region of its
    closing branch (the outer loop, a node loop, a leaf loop and its lane
    loop); the issue estimate adds each warp-model rule's
    instructions."""
    from rodent_tpu_torch.experiments import ct_warp_model
    src = (build.CSRC / "bvh_ct.cu").read_text()
    reg = sass_audit.kernel_regions(src, "bvh_ct_kernel")
    fn = common.parse_sass(_ct_listing(reg, "/x/bvh_ct.cu"))["_Zk7"]
    a = sass_audit.audit_function(fn, src, "bvh_ct.cu", "bvh_ct_kernel", 8)
    assert a["count"] == {"pop": 2, "node": 4, "leaf": 5}
    assert a["loops"] == {"pop": 1, "node": 1, "leaf": 2}
    assert a["lane_loop"] == (3, 2)
    assert a["weighted"] == {"pop": 2, "node": 4, "leaf": 2 + 3 * 2}
    assert sass_audit.per_pop(a) == {"node": 6, "leaf": 10}
    k = torch.tensor([[1, -1, 1, -1], [-1, 1, -1, 1]], dtype=torch.int8)
    meas = {"ms": 1.0, "pops": 8, "warps": 1, "warp_node": 2.0,
            "warp_leaf": 2.0, "model": ct_warp_model.warp_counts(k, 2)}
    est = sass_audit.estimate({"audit": a}, meas, 1000.0, 100)
    assert est["instr"] == 2 * 6 + 2 * 10
    assert {r: v["instr"] for r, v in est["rules"].items()} == {
        "if-if": 4 * 6 + 4 * 10, "while-while": 3 * 6 + 2 * 10,
        "busiest": 2 * 6 + 2 * 10}
    assert est["rules"]["busiest"]["issue_ms"] == pytest.approx(
        est["issue_ms"])


def _listing(functions):
    """A cuobjdump -sass listing of {name: [instruction text]}."""
    out = ["\tcode for sm_90a"]
    for name, insns in functions.items():
        out.append(f"\t\tFunction : {name}")
        out += [f"        /*{16 * i:04x}*/                   {t} ;"
                for i, t in enumerate(insns)]
    return common.parse_sass("\n".join(out))


def test_sass_compare_maps_instantiations():
    """sass_compare matches functions by kernel and template arguments
    with the anonymous namespace's hash set aside, K7's instantiations
    that gained PF (0) to the other tree's without it, and finds an
    instantiation that differs by one instruction, one that is missing and
    the ones that were added; without nvcc it refuses."""
    from rodent_tpu_torch.experiments import sass_compare

    def ct(ns, args):
        return (f"_ZN{len(ns)}{ns}13bvh_ct_kernelI"
                + "".join(f"L{'b' if i > 3 else 'i'}{a}E"
                          for i, a in enumerate(args)) + "EEvNS_4ArgsE")

    def k1(ns, args):
        return (f"_ZN{len(ns)}{ns}19bvh_traverse_kernelI"
                + "".join(f"L{'b' if i == 0 else 'i'}{a}E"
                          for i, a in enumerate(args)) + "EEvNS_4ArgsE")
    old_ns = "_GLOBAL__N__1a2b3c4d_9_bvh_ct_cu_0123abcd"
    new_ns = "_GLOBAL__N__9f8e7d6c_9_bvh_ct_cu_fedc9876"
    body = ["LDC R1, c[0x0][0x28]", "FMUL R2, R0, 2", "EXIT"]
    other = _listing({
        ct(old_ns, (0, 8, 8, 64, 0, 1, 0)): body,
        ct(old_ns, (0, 8, 24, 64, 0, 1, 0)): body,
        k1(old_ns, (0, 8, 8, 64, 0)): body,
        k1(old_ns, (0, 8, 4, 64, 1)): body,
        "_Z3fooPf": body})
    mine = _listing({
        ct(new_ns, (0, 8, 8, 64, 0, 1, 0, 0)): body,
        ct(new_ns, (0, 8, 8, 64, 0, 1, 0, 1)): body + ["NOP"],
        ct(new_ns, (0, 8, 12, 64, 0, 1, 0, 0)): body,
        ct(new_ns, (0, 8, 24, 64, 0, 1, 0, 0)): body[:1] + ["FADD R2, R0, 2",
                                                             "EXIT"],
        k1(new_ns, (0, 8, 8, 64, 0)): body,
        k1(new_ns, (0, 8, 12, 64, 0)): body})
    r = sass_compare.compare(mine, other)
    assert (r["other"], r["mine"], r["equal"]) == (4, 6, 2)
    assert r["differ"] == [ct(old_ns, (0, 8, 24, 64, 0, 1, 0))]
    assert r["missing"] == [k1(old_ns, (0, 8, 4, 64, 1))]
    assert r["added"] == {"bvh_ct_kernel": 2, "bvh_traverse_kernel": 1}
    assert sass_compare.instructions(
        _listing({"f": [f"CALL {new_ns}_x"]})["f"]) == ["CALL _GLOBAL__N__x"]
    import unittest.mock
    with unittest.mock.patch.object(build, "find_nvcc", lambda: None):
        with pytest.raises(SystemExit):
            sass_compare.main(["--against", "."])


def test_ab_gather_take_builds_the_other_checkouts_source(tmp_path):
    """ab_gather_take builds another checkout's probes.cu: its library's
    name hashes that source (the same bytes give this checkout's name, an
    edit another), and --against refuses the CPU."""
    from rodent_tpu_torch.experiments import ab_gather_take
    other = tmp_path / "rodent_tpu_torch" / "csrc"
    other.mkdir(parents=True)
    for name in ("probes.cu", *build.HEADERS):
        (other / name).write_bytes((build.CSRC / name).read_bytes())
    here = build.library_path(tmp_path, "probes")
    assert build.library_path(tmp_path, "probes", csrc=other) == here
    with open(other / "probes.cu", "a") as f:
        f.write("// another body\n")
    assert build.library_path(tmp_path, "probes", csrc=other) != here
    with pytest.raises(FileNotFoundError):
        ab_gather_take.other_library(tmp_path / "absent")
    with pytest.raises(SystemExit):
        ab_gather_take.main(["--cpu", "--against", str(tmp_path)])


def test_bigscene_demo_mesh_cpu(capsys):
    """bigscene_demo --mesh on two gloo ranks on the CPU: every rank's
    hits bit for bit equal to one process's."""
    from rodent_tpu_torch.experiments import bigscene_demo
    res = bigscene_demo.run_mesh(torch.device("cpu"), 2, 10_000, 16)
    assert res == {"backend": "gloo", "ranks": 2,
                   "seconds": res["seconds"], "equal": True}


def test_make_goldens_cpu(tmp_path, capsys):
    """make_goldens renders hall in its golden configuration (2 iterations
    here) through the dual-queue engine, writes the film and its meta to
    the directory it is given, holds both renders against tests/golden
    under the gate, and refuses to write tests/golden."""
    from rodent_tpu_torch.experiments import make_goldens
    assert make_goldens.main(["--cpu", "--iters", "2", "--scenes", "hall",
                              "--out", str(tmp_path)]) == 0
    meta = json.loads((tmp_path / "golden_meta.json").read_text())
    assert meta["hall"]["golden_iters"] == 2
    assert meta["hall"]["calib_mse_u8"] == 0.0     # 2 iterations = short
    assert (tmp_path / "hall.png").exists()
    assert "against tests/golden" in capsys.readouterr().out
    with pytest.raises(ValueError, match="JAX package's goldens"):
        make_goldens.run(torch.device("cpu"), ("hall",), 2,
                         os.path.join(REPO, "tests", "golden"))
    assert make_goldens.OUT == make_goldens.REPO / "build" / "goldens"
