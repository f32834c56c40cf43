"""The port's micro-probes (rodent_tpu_torch.experiments.probe_*,
vpu_dtype_bench) against the JAX probes of experiments/ on the CPU.

Each case puts the JAX file's own inputs (its seeds) through the unchanged
JAX body in Pallas interpret mode and through the port's plain version,
and asks for equality, bit for bit, except where a test says that XLA
contracts a multiply into the add after it (ROADMAP C2).

The JAX files are not imported: three of them run their TPU measurements
at import, and all of them point jax's persistent compilation cache at a
directory outside the repository. Each is parsed instead, and its imports,
assignments and function definitions are executed (load_probe); the
bodies are then called through pl.pallas_call with the specs of the file's
own run function plus interpret=True.

On a CUDA card the kernels are held against the plain versions by
tests/test_torch_cuda.py and chip_smoke.py phase 13.
"""
import ast
import functools
import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rodent_tpu_torch.experiments import (common, probe_body, probe_chain,
                                          probe_dyn_cost, probe_gather,
                                          probe_mosaic, probe_mosaic2,
                                          probe_mosaic3, vpu_dtype_bench)
from rodent_tpu_torch.kernels import build
from rodent_tpu_torch.traversal.api import _SORT_NETWORKS

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LOADED = {}


def load_probe(name):
    """The namespace of experiments/<name>.py after its imports,
    assignments and function definitions alone."""
    if name not in _LOADED:
        path = os.path.join(REPO, "experiments", f"{name}.py")
        with open(path) as f:
            tree = ast.parse(f.read())
        keep = [n for n in tree.body
                if isinstance(n, (ast.Import, ast.ImportFrom, ast.Assign,
                                  ast.FunctionDef))]
        ns = {"__name__": f"jax_{name}"}
        exec(compile(ast.Module(keep, []), path, "exec"), ns)
        _LOADED[name] = ns
    return _LOADED[name]


def _mosaic_x():
    return jnp.arange(128 * 16, dtype=jnp.float32).reshape(16, 128) / 7.0


# probe_mosaic.py main (:106-115): body -> (kernel, scratch)
MOSAIC = {"dot": ("k_dot", []), "dynroll": ("k_dynroll", []),
          "dynstore": ("k_dynstore", [pltpu.VMEM((8, 128), jnp.float32)]),
          "dynstore_odd": ("k_dynstore_odd",
                           [pltpu.VMEM((34, 128), jnp.float32)]),
          "smem_dyn": ("k_smem_dyn", [pltpu.SMEM((34,), jnp.int32)]),
          "nested": ("k_nested", []), "argmin_lane": ("k_argmin_lane", [])}


@pytest.mark.parametrize("body", list(probe_mosaic.BODIES))
def test_mosaic_matches_jax(body):
    ns = load_probe("probe_mosaic")
    kern, scratch = MOSAIC[body]
    want = np.asarray(pl.pallas_call(
        ns[kern], out_shape=ns["O"], scratch_shapes=list(scratch),
        interpret=True)(_mosaic_x()))
    x = probe_mosaic.inputs()
    np.testing.assert_array_equal(x.numpy(), np.asarray(_mosaic_x()))
    got = probe_mosaic.run(body, x).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_mosaic_dot_by_blocks_is_plain_dot():
    """plain_dot_by_blocks, the kernel's 8-term sums, equals plain_dot's
    128-term sums bit for bit on arange/7, and on adversarial()'s input
    (+-inf, NaN, -0.0, subnormals, values near FLT_MAX) bit for bit where
    finite and NaN where plain_dot is NaN."""
    x = probe_mosaic.inputs()
    assert torch.equal(probe_mosaic.plain_dot_by_blocks(x).view(torch.int32),
                       probe_mosaic.plain_dot(x).view(torch.int32))
    adv = probe_mosaic.adversarial()
    row = adv[0].numpy()
    blocks = row.reshape(16, 8)
    clean = np.isfinite(blocks).all(1)
    assert clean.any() and not clean.all()
    assert (row == 0).any() and np.signbit(row[row == 0]).any()
    assert (np.abs(row) < np.finfo(np.float32).tiny).any()
    assert (np.abs(row[np.isfinite(row)]) > 3e38).any()
    got = probe_mosaic.plain_dot_by_blocks(adv)
    want = probe_mosaic.plain_dot(adv)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(nan.any(1), torch.from_numpy(~clean))
    assert torch.isinf(want).any()
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    assert probe_mosaic.same_bits(got, want)


def _finite_normal(x):
    """x with every non-finite value and every subnormal made +0.0: XLA's
    CPU backend flushes subnormals (ROADMAP C6), torch and the card keep
    them."""
    x = x.numpy().copy()
    x[~np.isfinite(x) | (np.abs(x) < np.finfo(np.float32).tiny)] = 0.0
    return x


def test_mosaic_dot_matches_jax_on_the_adversarial_inputs_finite_part():
    """JAX's k_dot in interpret mode on adversarial()'s finite part
    (subnormals flushed as XLA's CPU backend flushes them) equals
    plain_dot and plain_dot_by_blocks bit for bit: each output has one
    nonzero product, so no order of summation moves a bit (-0.0 and
    values near FLT_MAX included)."""
    ns = load_probe("probe_mosaic")
    x = _finite_normal(probe_mosaic.adversarial())
    assert (x[0] == 0).any() and (np.abs(x[0]) > 3e38).any()
    want = np.asarray(pl.pallas_call(ns["k_dot"], out_shape=ns["O"],
                                     interpret=True)(jnp.asarray(x)))
    for fn in (probe_mosaic.plain_dot, probe_mosaic.plain_dot_by_blocks):
        got = fn(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_mosaic_argmin_lane_follows_jnp_min_on_a_nan():
    """adversarial()'s row 0 holds a NaN: jnp.min propagates it, no lane
    is <= NaN, and k_argmin_lane in interpret mode gives lane 128, as the
    plain version does (the card's block_min skips a NaN with fminf, so
    mosaic_kernel looks for one apart: tests/test_torch_cuda.py
    test_mosaic_adversarial)."""
    ns = load_probe("probe_mosaic")
    adv = probe_mosaic.adversarial()
    assert torch.isnan(adv[0]).any()
    want = np.asarray(pl.pallas_call(ns["k_argmin_lane"], out_shape=ns["O"],
                                     interpret=True)(jnp.asarray(adv.numpy())))
    got = probe_mosaic.plain_argmin_lane(adv).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 128).all()
    clean = adv.clone()
    clean[0] = torch.nan_to_num(clean[0], nan=5.0)
    assert float(probe_mosaic.plain_argmin_lane(clean)[0, 0]) < 128


def test_mosaic_same_bits_holds_nan_as_nan():
    """same_bits: equal bits where the reference is not NaN, NaN (any
    payload) where it is."""
    a = torch.tensor([1.0, -0.0, float("nan")])
    b = torch.tensor([1.0, -0.0, 0.0]).view(torch.int32)
    b[2] = 0x7FC00001
    assert probe_mosaic.same_bits(b.view(torch.float32), a)
    assert not probe_mosaic.same_bits(torch.tensor([1.0, 0.0, 0.0]), a)
    assert not probe_mosaic.same_bits(torch.tensor([1.0, -0.0, 2.0]), a)


# probe_mosaic2.py main and main2 (:138-179): body -> (kernel, scratch)
MOSAIC2 = {
    "dot_in_loop": ("k_dot_in_loop", []),
    "dynroll_in_loop": ("k_dynroll_in_loop", []),
    "dynstore_in_while": ("k_dynstore_in_while", [
        pltpu.VMEM((8, 128), jnp.float32), pltpu.SMEM((8,), jnp.int32)]),
    "stack_machine": ("k_stack_machine", [
        pltpu.VMEM((8, 128), jnp.float32), pltpu.VMEM((8, 128), jnp.float32),
        pltpu.SMEM((8,), jnp.int32)]),
    "dynstore8_in_while": ("k_dynstore8_in_while", [
        pltpu.VMEM((64, 128), jnp.float32), pltpu.SMEM((8,), jnp.int32)])}


@pytest.mark.parametrize("body", list(probe_mosaic2.BODIES))
def test_mosaic2_matches_jax(body):
    """Bit for bit, but dot_in_loop: XLA's CPU backend may contract the
    dot's products into its sum and `dot * 1e-6` into `acc +` (ROADMAP
    C2), where the port rounds each operation, so it is held to rtol
    1e-6."""
    ns = load_probe("probe_mosaic2")
    kern, scratch = MOSAIC2[body]
    want = np.asarray(pl.pallas_call(
        ns[kern], out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
        scratch_shapes=list(scratch), interpret=True)(_mosaic_x()))
    got = probe_mosaic2.run(body, probe_mosaic.inputs()).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if body == "dot_in_loop":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def _interpret_recording(calls):
    """pl.pallas_call with interpret=True whose calls outside jit append
    their outputs to `calls`."""
    orig = pl.pallas_call

    def call(*a, **k):
        fn = orig(*a, **{**k, "interpret": True})

        def rec(*args):
            out = fn(*args)
            if not isinstance(out, jax.core.Tracer):   # not under jit
                calls.append(np.asarray(out))
            return out
        return rec
    return call


def _jax_gather():
    """Every output of probe_gather.py's probes in order: probe_correct's
    six, probe_i32's, probe_throughput's chain and 56-field block,
    probe_pages' four (its bench() kept to one call)."""
    if "gather" not in _LOADED:
        ns = load_probe("probe_gather")
        calls = []

        def bench(fn, *args, iters=20):
            calls.append(np.asarray(fn(*args)))
            return 1.0
        with mock.patch.object(pl, "pallas_call",
                               _interpret_recording(calls)), \
                mock.patch.dict(ns, {"bench": bench}):
            for probe in ("probe_correct", "probe_i32", "probe_throughput",
                          "probe_pages"):
                ns[probe]()
        _LOADED["gather"] = calls
    return _LOADED["gather"]


GATHER = ([f"axis{a} {s}" for s, a in probe_gather.CORRECT]
          + ["i32 (8, 128)"] + list(probe_gather.TIMED))


@pytest.mark.parametrize("case", GATHER)
def test_gather_matches_jax(case):
    want = _jax_gather()[GATHER.index(case)]
    if case in probe_gather.TIMED:
        tbl, idx = probe_gather.timed_inputs(case)
        got = probe_gather.run(case, torch.from_numpy(tbl),
                               torch.from_numpy(idx), copies=2)
        assert got.shape == (2, 8, 128)
        got = got[1]
    elif case.startswith("i32"):
        tbl, idx = probe_gather.i32_inputs()
        got = probe_gather.run_take(torch.from_numpy(tbl),
                                    torch.from_numpy(idx), 1)
    else:
        shape, axis = probe_gather.CORRECT[GATHER.index(case)]
        tbl, idx = probe_gather.correct_inputs(shape, axis)
        got = probe_gather.run_take(torch.from_numpy(tbl),
                                    torch.from_numpy(idx), axis)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# the timed cases in the order probe_throughput and probe_pages bench them
MOVING_ORDER = ["chain", "fields", "pages1", "pages2", "pages4", "pages8"]


def _jax_gather_moving():
    """{case: the JAX body's output} of probe_throughput's and
    probe_pages' bodies on moving()'s indices: the file's bench(), which
    each body reaches with its zeros, hands it the next case's moving()
    indices in their place."""
    if "gather moving" not in _LOADED:
        ns = load_probe("probe_gather")
        outs, cases = [], iter(MOVING_ORDER)

        def bench(fn, tbl, idx, iters=20):
            assert not np.asarray(idx).any()
            outs.append(np.asarray(fn(tbl, jnp.asarray(
                probe_gather.moving(next(cases))))))
            return 1.0
        with mock.patch.object(pl, "pallas_call",
                               _interpret_recording([])), \
                mock.patch.dict(ns, {"bench": bench}):
            ns["probe_throughput"]()
            ns["probe_pages"]()
        _LOADED["gather moving"] = dict(zip(MOVING_ORDER, outs))
    return _LOADED["gather moving"]


@pytest.mark.parametrize("case", list(probe_gather.TIMED))
def test_gather_matches_jax_where_lanes_differ(case):
    """On moving()'s seeded start indices (in [0, 128), or [0, P * 128)
    for P pages) the lanes of a row hold more than one index at every
    step or iteration, so a body that mixed up lanes would show; the
    plain version equals the JAX body in interpret mode there, bit for
    bit."""
    want = _jax_gather_moving()[case]
    body, pages, steps = probe_gather.TIMED[case]
    tbl = torch.from_numpy(probe_gather.timed_inputs(case)[0])
    idx = probe_gather.moving(case)
    np.testing.assert_array_equal(idx, probe_gather.moving(case))
    assert idx.min() >= 0 and idx.max() < 128 * max(pages, 1)
    trace = []
    got = probe_gather.PLAIN[body](tbl, torch.from_numpy(idx), trace)
    assert len(trace) == steps
    lanes = torch.stack(trace).sort(dim=2).values
    assert bool((lanes[:, :, 1:] != lanes[:, :, :1]).any(dim=2).all())
    np.testing.assert_array_equal(got.numpy(), want)


TAKE_ROWS = (1, 3, 8, 64, 512, 4096, 65536)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("rows", TAKE_ROWS)
def test_plain_take_matches_numpy(rows, axis, dtype):
    """plain_take, which run_take takes on CPU tensors and which the card's
    kernel is held against, equals np.take_along_axis bit for bit at the
    row counts of the card test (tests/test_torch_cuda.py), odd ones
    included; the indices span the axis."""
    r = np.random.RandomState(rows * 4 + axis)
    tbl = (r.randn(rows, 128).astype(np.float32) if dtype == np.float32
           else r.randint(-2 ** 31, 2 ** 31 - 1, (rows, 128)).astype(dtype))
    idx = r.randint(0, (rows, 128)[axis], (rows, 128)).astype(np.int32)
    got = probe_gather.run_take(torch.from_numpy(tbl), torch.from_numpy(idx),
                                axis).numpy()
    want = np.take_along_axis(tbl, idx, axis=axis)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _jax_mosaic3(mode):
    """_kernel (modes none, extract, slice) or _kernel2 (the dep- modes)
    with the specs of run (:56-61) or run2 (:108-113)."""
    ns = load_probe("probe_mosaic3")
    dep = mode.startswith("dep")
    fn = pl.pallas_call(
        functools.partial(ns["_kernel2" if dep else "_kernel"], mode=mode),
        out_shape=jax.ShapeDtypeStruct((ns["R"], 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    return np.asarray(fn(jnp.asarray(probe_mosaic3.inputs(mode).numpy())))


@pytest.mark.parametrize("mode", probe_mosaic3.MODES)
def test_mosaic3_matches_jax(mode):
    """Bit for bit. The dep- modes add lane 0 of the permutation table,
    int32 bits read as float32: subnormals, which XLA's CPU backend
    flushes to zero (ROADMAP C6) and torch and the card keep; the plain
    version runs here with torch's flush on to match (torch's default,
    and the kernel's, is to keep them)."""
    want = _jax_mosaic3(mode)
    tab = probe_mosaic3.inputs(mode)
    flush = mode.startswith("dep")
    if flush:
        assert torch.set_flush_denormal(True)
    try:
        got = probe_mosaic3.run(mode, tab, copies=2).numpy()
    finally:
        torch.set_flush_denormal(False)
    assert got.shape == (2,) + want.shape
    np.testing.assert_array_equal(got[1].view(np.int32), want.view(np.int32))


def _jax_scalar_out(ns, kernel, tab, scratch):
    """A probe whose output is one int32 in SMEM, with run's specs
    (probe_chain.py:80-86, probe_body.py:107-113)."""
    fn = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((1,), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        scratch_shapes=scratch, interpret=True)
    return np.asarray(fn(jnp.asarray(tab.numpy())))


@pytest.mark.parametrize("mode", probe_chain.MODES)
@pytest.mark.parametrize("streams", probe_chain.STREAMS)
def test_chain_matches_jax(mode, streams):
    """All 2,048 steps, bit for bit. chase+smem-shared is the card's second
    form of the JAX mode chase+smem (the stack in shared memory rather
    than per-thread local memory): the same JAX body."""
    ns = load_probe("probe_chain")
    want = _jax_scalar_out(
        ns, functools.partial(ns["_kernel"], streams=streams,
                              mode=mode.replace("-shared", "")),
        probe_chain.inputs(), [pltpu.SMEM((max(streams, 1),), jnp.int32)])
    got, aux = probe_chain.run(mode, streams, probe_chain.inputs(), copies=3)
    assert got.shape == (3,) and got.dtype == torch.int32
    assert aux.shape == (3,) and aux.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[2:], want)


def _numpy_chain_vec(streams, tab):
    """chase+vec of the JAX body (probe_chain.py:43-51) in numpy float32:
    (the sum of the S final indices, (N, S) each step's minimum)."""
    c1, c2 = np.float32(1.000001), np.float32(1.5)
    idxs = [s * 37 % probe_chain.NN for s in range(streams)]
    accs = [np.zeros((64, 128), np.float32) for _ in range(streams)]
    mins = np.empty((probe_chain.N, streams), np.float32)
    for i in range(probe_chain.N):
        for s in range(streams):
            row = tab[idxs[s]:idxs[s] + 1]
            v = np.broadcast_to(row, (64, 128)) * c1
            v = np.minimum(v * c2, v + accs[s])
            m = v.min()
            mins[i, s] = m
            idxs[s] = int(row.view(np.int32)[0, 0]) + int(m > 1e30)
            accs[s] = v
    return sum(idxs), mins


def test_chain_fold_is_fnv1a_over_the_minima_bits():
    """fold_minima: FNV-1a over each minimum's 32 bits, step by step and
    stream by stream, as an int32."""
    mins = np.array([[0.0, -1.5], [2.0, 0.25]], np.float32)
    h = 2166136261
    for b in mins.view(np.uint32).reshape(-1).tolist():
        h = ((h ^ b) * 16777619) % 2 ** 32
    assert probe_chain.fold_minima(mins).tolist() == [
        h - 2 ** 32 if h >= 2 ** 31 else h]


@pytest.mark.parametrize("table", ["inputs", "moving"])
@pytest.mark.parametrize("streams", probe_chain.STREAMS)
def test_chain_vec_aux_is_the_jax_bodys_minima(table, streams):
    """chase+vec's aux, the fold of every step's minimum over the block,
    equals the fold of a numpy loop of the JAX body's arithmetic, and its
    output the loop's indices. On the JAX table the minimum is 0 at every
    step (every lane but 0 is zero), so only moving()'s table, random in
    lanes 1-127 and the same in lane 0, shows a reduction that returns
    another value."""
    tab = getattr(probe_chain, table)()
    np.testing.assert_array_equal(tab[:, 0].numpy(),
                                  probe_chain.inputs()[:, 0].numpy())
    total, mins = _numpy_chain_vec(streams, tab.numpy())
    out, aux = probe_chain.plain("chase+vec", streams, tab)
    assert out.tolist() == [total]
    assert aux.tolist() == probe_chain.fold_minima(mins).tolist()
    distinct = len(np.unique(mins.view(np.int32)))
    assert distinct == 1 if table == "inputs" else distinct > 1000
    for mode in ("chase", "chase+smem"):
        got = probe_chain.plain(mode, streams, tab)
        assert got[0].tolist() == probe_chain.plain(
            mode, streams, probe_chain.inputs())[0].tolist()
        assert got[1].tolist() == [0]


def test_gather_and_chain_issue_ms_count_one_operation_a_lane_and_cycle():
    """issue_ms: the work at one operation a lane and cycle, 128 lanes an
    SM, in whole waves: a gather copy's FADDs (the chain's add and and)
    spread over one SM's lanes; a chase's copy on one lane; a chase+vec
    copy's five operations a value over one SM's lanes."""
    us = 1e3 / 1980e6
    assert probe_gather.issue_ms("fields", 132, 132, 1980) == pytest.approx(
        56 * 1024 * 256 / 128 * us)
    assert probe_gather.issue_ms("pages2", 133, 132, 1980) == pytest.approx(
        2 * 28 * 1024 * 256 / 128 * us)
    assert probe_gather.issue_ms("chain", 1, 132, 1980) == pytest.approx(
        2 * 1024 * 2048 / 128 * us)
    assert probe_chain.issue_ms("chase", 1, 1, 132, 1980) == pytest.approx(
        2048 * us)
    assert probe_chain.issue_ms("chase", 2, 132 * 128 + 1, 132,
                                1980) == pytest.approx(2 * 2 * 2048 * us)
    assert probe_chain.issue_ms("chase+vec", 4, 264, 132,
                                1980) == pytest.approx(
        2 * 5 * 8192 * 2048 * 4 / 128 * us)


def test_gather_and_chain_resources_read_their_kernels(monkeypatch,
                                                        tmp_path):
    """resources() names each gather_kernel by its case and memory and
    each chain kernel by its mode and S from the kernels' mangled names,
    and counts the BAR.SYNC in chase+vec's step loop."""
    from rodent_tpu_torch.experiments import sass_audit
    gather = [f"_ZN12_GLOBAL__N_113gather_kernelILi{b}ELb{m}ELi256EEEvPKfPK"
              f"iPii" for b in (1, 2, 3) for m in (0, 1)]
    scalar = [f"_ZN12_GLOBAL__N_119chain_scalar_kernelILi{m}ELi{s}EEEvPKfPii"
              for m in (0, 1, 2) for s in (1, 2, 4)]
    vec = [f"_ZN12_GLOBAL__N_116chain_vec_kernelILi{s}EEEvPKfPiS2_"
           for s in (1, 2, 4)]
    take = ["_ZN12_GLOBAL__N_118gather_take_kernelILi1EEEvPKiPK4int4PS2_i"]
    loop = ("        /*0000*/                   MOV R1, c[0x0][0x28] ;\n"
            "        /*0010*/                   LDG.E R2, [R4.64] ;\n"
            "        /*0020*/                   BAR.SYNC.DEFER_BLOCKING "
            "0x0 ;\n"
            "        /*0030*/               @P0 BRA 0x10 ;\n"
            "        /*0040*/                   EXIT ;\n")
    listing = "".join(f"\tFunction : {n}\n" + loop
                      for n in gather + scalar + vec + take)
    names = gather + scalar + vec + take
    monkeypatch.setattr(sass_audit, "res_usage",
                        lambda path: {n: {"REG": 40} for n in names})
    monkeypatch.setattr(sass_audit, "spills",
                        lambda log: {n: (0, 0) for n in names})
    monkeypatch.setattr(build, "kept_log", lambda path: "")
    funcs = common.parse_sass(listing)
    res = probe_gather.resources(tmp_path / "lib.so", funcs)
    assert set(res) == {(c, m) for c in ("chain", "fields", "pages")
                        for m in ("shared", "global")}
    assert all(r == {"regs": 40, "spills": (0, 0)} for r in res.values())
    res = probe_chain.resources(tmp_path / "lib.so", funcs)
    assert set(res) == {(m, s) for m in probe_chain.MODES
                        for s in probe_chain.STREAMS}
    assert all(res[("chase+vec", s)]["barriers"] == 1
               for s in probe_chain.STREAMS)
    assert "barriers" not in res[("chase", 1)]


def test_body_sort_network_is_the_jax_bodys():
    """probe_body's network is the port's _SORT_NETWORKS[8], the one the
    JAX body imports from rodent_tpu.traversal.tiled."""
    from rodent_tpu.traversal.tiled import _SORT_NETWORKS
    from rodent_tpu_torch.traversal import api
    assert [tuple(p) for p in api._SORT_NETWORKS[8]] == [
        tuple(p) for p in _SORT_NETWORKS[8]]


@pytest.mark.parametrize("feats", probe_body.CASES,
                         ids=[probe_body.name(f) for f in probe_body.CASES])
def test_body_matches_jax(feats):
    """All 2,048 steps, bit for bit: the output (idx + i) of the JAX body,
    whose buffers and stack the output does not read."""
    ns = load_probe("probe_body")
    want = _jax_scalar_out(ns, functools.partial(ns["_kernel"], feats=feats),
                           probe_body.inputs(),
                           [pltpu.SMEM((16,), jnp.int32)])
    out, aux = probe_body.run(feats, probe_body.inputs(), copies=2)
    assert out.shape == (2,) and aux.shape == (2, 6)
    np.testing.assert_array_equal(out.numpy()[1:], want)


def test_body_bound_counts_the_jax_bodys_work():
    """probe_body's bound counts the JAX body's operations a step: 64 x 128
    values x (6 + carried buffers) for the vector stage, and the network's
    19 exchanges of 5 and the pushes' 8 x 4 once a copy, as the JAX body
    runs them on its scalar unit, whatever the card's mapping; linear in
    the copies, against the published float32 peak."""
    ops = probe_body.ops_per_step
    assert ops(()) == 57_344
    assert ops(probe_body.HEAD) == 90_239
    assert ops(("carry5",)) - ops(()) == 4 * 64 * 128
    n, peak = probe_body.N, common.PROBE_PEAKS["float32"]
    for copies in (1, 132, 528):
        base, by = probe_body.bound((), copies)
        assert by == "operations"
        for feats, extra in ((("sort",), 95), (("push8",), 32),
                             (("sort", "push8"), 127)):
            ms = probe_body.bound(feats, copies)[0]
            assert (ms - base) * 1e-3 * peak == pytest.approx(
                extra * n * copies, rel=1e-9)
    for feats in probe_body.CASES:
        one = probe_body.bound(feats, 1)[0]
        for copies in (132, 528):
            assert probe_body.bound(feats, copies)[0] == pytest.approx(
                copies * one, rel=1e-12)
    assert probe_body.bound(probe_body.HEAD, 132)[0] == pytest.approx(
        0.3646, abs=5e-5)


@pytest.mark.parametrize("feats", probe_body.CASES,
                         ids=[probe_body.name(f) for f in probe_body.CASES])
def test_body_mask_is_a_case_of_the_launch(feats):
    """The C entry's mask is the feature bits of csrc/probes.cu's enum, and
    body_launch takes it to the body_kernel of those bits."""
    src = (build.CSRC / "probes.cu").read_text()
    enum = dict(re.findall(r"k(Carry5|Cond|DataCond|Sort|Push8) = (\d+)",
                           re.search(r"enum \{ kCarry5[^}]*\}", src)[0]))
    bits = {"carry5": "Carry5", "cond": "Cond", "datacond": "DataCond",
            "sort": "Sort", "push8": "Push8"}
    m = probe_body.mask(feats)
    assert m == sum(int(enum[bits[f]]) for f in feats)
    launch = re.search(r"Launch body_launch\(int feats\) \{(.*?)\n\}",
                       src, re.S)[1]
    cases = {}
    for case, kernel in re.findall(
            r"case ([^:]+):\s*return launch_of\(body_kernel<([^>]+)>",
            launch):
        value = eval(re.sub(r"k(\w+)", lambda k: enum[k[1]], case))
        assert value == eval(re.sub(r"k(\w+)", lambda k: enum[k[1]],
                                    kernel))
        cases[value] = kernel
    assert sorted(cases) == sorted(map(probe_body.mask, probe_body.CASES))
    assert m in cases


def test_body_sort8_on_the_cpu_is_the_serial_network():
    """sort8 on CPU tensors takes plain_sort8, launches nothing, and sorts
    each set of 8 keys with ties, and its codes, as the JAX body's serial
    network does, exchange by exchange."""
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 4, (300, 8)).astype(np.float32)
    kids = np.argsort(rng.random((300, 8)), 1).astype(np.int32)
    got_k, got_i = probe_body.sort8(torch.from_numpy(keys),
                                    torch.from_numpy(kids))
    for s in range(len(keys)):
        k, i = keys[s].copy(), kids[s].copy()
        for a, b in _SORT_NETWORKS[8]:
            if k[a] > k[b]:
                k[[a, b]], i[[a, b]] = k[[b, a]], i[[b, a]]
        np.testing.assert_array_equal(got_k[s].numpy(), k)
        np.testing.assert_array_equal(got_i[s].numpy(), i)
    assert np.all(np.diff(got_k.numpy(), axis=1) >= 0)


def _sort_layers():
    """kSortLayers of csrc/probes.cu: six 32-bit words, nibble l of a word
    position l's partner in that layer."""
    src = (build.CSRC / "probes.cu").read_text()
    body = re.search(r"kSortLayers\[6\] = \{([^}]*)\}", src).group(1)
    return [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]


def test_body_sort_layers_are_the_network():
    """body_kernel runs _SORT_NETWORKS[8]'s 19 exchanges in order as 6
    layers of disjoint pairs (kSortLayers): each layer's partners pair up,
    the layers are consecutive runs of the network; and the exchanges run
    lane by lane as the kernel does (lane l keeps the partner's key and
    code where the pair (a, b) has key[a] > key[b]) give the serial
    network's codes on keys with ties."""
    words = _sort_layers()
    assert len(words) == 6
    partners = [[(w >> 4 * l) & 7 for l in range(8)] for w in words]
    for p in partners:
        assert all(p[p[l]] == l for l in range(8))
    pairs = [tuple(p) for p in _SORT_NETWORKS[8]]
    at = 0
    for p in partners:
        layer = sorted((l, p[l]) for l in range(8) if p[l] > l)
        assert sorted(pairs[at:at + len(layer)]) == layer
        at += len(layer)
    assert at == len(pairs) == 19
    rng = np.random.default_rng(0)
    for _ in range(500):
        keys = rng.integers(0, 4, 8).astype(np.float32)
        kids = rng.permutation(8)
        sk, si = keys.copy(), kids.copy()
        for a, b in pairs:
            if sk[a] > sk[b]:
                sk[[a, b]], si[[a, b]] = sk[[b, a]], si[[b, a]]
        lk, li = keys.copy(), kids.copy()
        for p in partners:
            pk, pi = lk[p], li[p]
            sw = np.where(np.arange(8) < p, lk > pk, pk > lk)
            lk, li = np.where(sw, pk, lk), np.where(sw, pi, li)
        np.testing.assert_array_equal(li, si)
        np.testing.assert_array_equal(lk, sk)


def test_body_step_barriers_reads_the_step_loop():
    """step_barriers counts the BAR.SYNC between the step loop's target and
    its closing branch: not the one after the loop, which a shuffle's
    out-of-line path, branching back into the loop from past its end,
    would put in range; two in a loop are two."""
    listing = """
		Function : _ZN12_GLOBAL__N_111body_kernelILi0EEEvPKfPiPfi
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E.CONSTANT R2, desc[UR4][R4.64] ;
        /*0020*/                   BRA.DIV UR4, 0x90 ;
        /*0030*/                   SHFL.BFLY PT, R3, R2, 0x10, 0x1f ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/               @P1 BRA 0x10 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/                   EXIT ;
        /*0080*/                   WARPSYNC.COLLECTIVE R4, 0x90 ;
        /*0090*/                   BRA 0x30 ;
        /*00a0*/                   BRA 0xa0;
"""
    fn = common.parse_sass(listing)[
        "_ZN12_GLOBAL__N_111body_kernelILi0EEEvPKfPiPfi"]
    assert probe_body.step_barriers(fn) == 1
    two = listing.replace("SHFL.BFLY PT, R3, R2, 0x10, 0x1f",
                          "BAR.SYNC.DEFER_BLOCKING 0x0")
    assert probe_body.step_barriers(common.parse_sass(two)[
        "_ZN12_GLOBAL__N_111body_kernelILi0EEEvPKfPiPfi"]) == 2


def _source_constants(*names):
    """csrc/probes.cu's integer constexprs of these names."""
    src = (build.CSRC / "probes.cu").read_text()
    return [int(re.search(rf"\b{n} = (\d+)", src)[1]) for n in names]


@pytest.mark.parametrize("mode", probe_mosaic3.MODES)
def test_mosaic3_bound_counts_the_adds_per_copy(mode):
    """probe_mosaic3's bound counts one copy's adds (8,192 values x 24
    words, 1 for none, x 4,096 iterations) against the published float32
    peak, linear in the copies, whatever the card's threads a copy: the
    kernel's threads hold the 8,192 values between them; issue_ms, one
    FADD per lane and cycle, is half of the bound's operation time on a
    full wave (132 SMs at 1,980 MHz; the published peak counts an FMA as
    two)."""
    vals, threads = _source_constants("kM3Vals", "kM3Threads")
    assert vals * threads == 64 * 128
    words = 1 if mode == "none" else 24
    assert probe_mosaic3.adds(mode) == words * 8192 * 4096
    peak = common.PROBE_PEAKS["float32"]
    for copies in (1, 132, 264, 528):
        ms, by = probe_mosaic3.bound(mode, copies)
        assert by == "operations"
        assert ms * 1e-3 * peak == pytest.approx(
            words * 8192 * 4096 * copies, rel=1e-12)
    assert probe_mosaic3.bound("extract", 264)[0] == pytest.approx(
        3.1779, abs=5e-5)
    full = probe_mosaic3.issue_ms(mode, 264, 132, 1980.0)
    assert full == pytest.approx(
        2 * probe_mosaic3.issue_ms(mode, 1, 132, 1980.0), rel=1e-12)
    assert full == pytest.approx(probe_mosaic3.issue_ms(mode, 133, 132,
                                                        1980.0), rel=1e-12)
    assert probe_mosaic3.bound(mode, 264)[0] / full == pytest.approx(
        132 * 128 * 1980e6 / peak, rel=1e-12)


@pytest.mark.parametrize("body", list(probe_dyn_cost.BODIES))
def test_dyn_cost_bound_counts_the_adds_per_copy(body):
    """probe_dyn_cost's bound counts 1,024 adds per tile added (one tile,
    four for dyn4 and async4) and iteration of each copy, whatever the
    card's threads a copy (they hold the 1,024 values, 4 each), against
    the published float32 peak, or the table's and outputs' bytes where
    those take longer (one copy)."""
    threads, = _source_constants("kDynThreads")
    assert threads * 4 == 8 * 128
    tiles = 4 if body in ("dyn4", "async4") else 1
    peak = common.PROBE_PEAKS["float32"]
    for copies in (1, 132, 1056):
        ms, by = probe_dyn_cost.bound(body, copies)
        ops = 1024 * tiles * 2000 * copies / peak
        nbytes = (4096 * 512 + copies * 4096) / common.PEAK_BYTES
        assert ms * 1e-3 == pytest.approx(max(ops, nbytes), rel=1e-12)
        assert by == ("operations" if ops >= nbytes else "bytes")
    assert probe_dyn_cost.bound(body, 1056)[1] == "operations"
    assert probe_dyn_cost.bound("async4", 1056)[0] == pytest.approx(
        0.1293, abs=5e-5)


def test_dyn_cost_loop_barriers_reads_every_loop():
    """loop_barriers counts the BAR.SYNC inside any loop of the listing
    (between a backward branch's target and the branch, an mbarrier's
    wait loop nested in the iteration loop included): none for the one
    before the loop or after it; one in an inner loop counts."""
    listing = """
		Function : _ZN12_GLOBAL__N_115dyn_cost_kernelILi4EEEvPKfPf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDG.E.CONSTANT R2, desc[UR4][R4.64] ;
        /*0030*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3 ;
        /*0040*/              @!P0 BRA 0x30 ;
        /*0050*/                   FADD R6, R6, R2 ;
        /*0060*/               @P1 BRA 0x20 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90;
"""
    name = "_ZN12_GLOBAL__N_115dyn_cost_kernelILi4EEEvPKfPf"
    fn = common.parse_sass(listing)[name]
    assert common.loops(fn) == [(0x30, 0x40), (0x20, 0x60)]
    assert probe_dyn_cost.loop_barriers(fn) == 0
    inner = listing.replace(
        "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3",
        "BAR.SYNC.DEFER_BLOCKING 0x0")
    assert probe_dyn_cost.loop_barriers(common.parse_sass(inner)[name]) == 1
    outer = listing.replace("FADD R6, R6, R2", "BAR.SYNC.DEFER_BLOCKING 0x1")
    assert probe_dyn_cost.loop_barriers(common.parse_sass(outer)[name]) == 1


def _interpret(*a, _orig=pl.pallas_call, **k):
    return _orig(*a, **{**k, "interpret": True})


# probe_dyn_cost.py main (:86-94): body -> (body function, scratch)
DYN = {"static": ("b_static", []), "dyn1": ("b_dyn1", []),
       "dyn4": ("b_dyn4", []), "dynrow1": ("b_dynrow1", []),
       "async4": ("b_async4", [pltpu.VMEM((32, 128), jnp.float32),
                               pltpu.SemaphoreType.DMA((4,))])}


@pytest.mark.parametrize("body", list(probe_dyn_cost.BODIES))
def test_dyn_cost_matches_jax(body):
    """All 2,000 iterations, bit for bit (adds only, in the same order)."""
    ns = load_probe("probe_dyn_cost")
    fn, scratch = DYN[body]
    tab = probe_dyn_cost.inputs()
    with mock.patch.object(pl, "pallas_call", _interpret):
        want = np.asarray(ns["make"](ns[fn], scratch)(jnp.asarray(
            tab.numpy())))
    np.testing.assert_array_equal(
        tab.numpy(), np.asarray(jnp.arange(4096 * 128, dtype=jnp.float32)
                                .reshape(4096, 128) * 1e-9))
    got = probe_dyn_cost.run(body, tab, copies=2).numpy()
    assert got.shape == (2, 8, 128)
    np.testing.assert_array_equal(got[1].view(np.int32), want.view(np.int32))


def _dyn_chain(body, tab):
    """The tiles' indices of a dyn body's 2,000 iterations and the last
    acc[0, 0], from column 0 alone (make's index :45-83, apart from
    plain(); the kernel's per-warp chain)."""
    col0, a00, out = tab[:, 0].numpy(), np.float32(0), []
    for i in range(probe_dyn_cost.N_IT):
        idx = int(a00) % (512 if body == "dynrow1" else 64) + i % 64
        out.append(idx)
        rows = ([idx] if body == "dynrow1" else
                [idx * 8 + 64 * s for s in range(
                    4 if body in ("dyn4", "async4") else 1)])
        for r in rows:
            a00 = np.float32(a00 + col0[r])
    return out, a00


@pytest.mark.parametrize("body", list(probe_dyn_cost.BODIES))
def test_dyn_cost_matches_jax_where_the_index_moves(body):
    """On moving()'s table (seeded; column 0 in [0, 600)) int(acc[0, 0])
    takes most of its residues, so the tiles' rows follow the chain; all
    2,000 iterations bit for bit the JAX body's in interpret mode, its
    floor-mod index included, and acc[0, 0] the chain of column 0
    alone."""
    ns = load_probe("probe_dyn_cost")
    fn, scratch = DYN[body]
    tab = probe_dyn_cost.moving()
    assert torch.equal(tab, probe_dyn_cost.moving())
    if body != "static":
        idx, a00 = _dyn_chain(body, tab)
        wrap = 512 if body == "dynrow1" else 64
        moved = {(x - i % 64) % wrap for i, x in enumerate(idx)}
        assert len(moved) > wrap // 2, sorted(moved)
    with mock.patch.object(pl, "pallas_call", _interpret):
        want = np.asarray(ns["make"](ns[fn], scratch)(jnp.asarray(
            tab.numpy())))
    got = probe_dyn_cost.run(body, tab, copies=2).numpy()
    assert got.shape == (2, 8, 128)
    np.testing.assert_array_equal(got[1].view(np.int32), want.view(np.int32))
    if body != "static":
        assert got[1, 0, 0].view(np.int32) == a00.view(np.int32)


@pytest.mark.parametrize("dtype,rows", vpu_dtype_bench.CASES)
def test_vpu_matches_jax(dtype, rows):
    """All 2,000 rounds, bit for bit. On this input every value stays 1 in
    every type (x * c1 - c2 is 1.000001 - 0.5 or 1 - 0, below x, and x is
    below 100), so torch's bfloat16, which rounds each operation through
    float32, and the card's __hmul2 family, which rounds once, agree."""
    ns = load_probe("vpu_dtype_bench")
    jdt = getattr(jnp, dtype)
    with mock.patch.object(pl, "pallas_call", _interpret):
        want = np.asarray(ns["make"](jdt, rows)(jnp.ones((rows, 128), jdt)))
    assert [float(c) for c in vpu_dtype_bench.constants(dtype)] == [
        float(jnp.asarray(c, jdt)) for c in vpu_dtype_bench.CONSTS]
    got = vpu_dtype_bench.run(dtype, vpu_dtype_bench.inputs(dtype, rows),
                              copies=2)
    assert got.shape == (2, rows, 128)
    got = got[1].float().numpy() if dtype == "bfloat16" else got[1].numpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_vpu_shape_is_the_kernels():
    """loop_shape() is csrc/probes.cu's kVpuUnroll and kVpuWords, WORDS
    and THREADS its kVpuWords and kVpuThreads; the unroll divides the
    2,000 rounds, and a
    copy of every case is whole blocks. At 16 blocks an SM the copies that
    fill 132 SMs are whole waves but for 256 rows of a 32-bit type, whose
    16 copies leave 64 of the 2,112 blocks' room (16.5 copies)."""
    unroll, words, threads = _source_constants("kVpuUnroll", "kVpuWords",
                                               "kVpuThreads")
    assert vpu_dtype_bench.loop_shape() == (unroll, words)
    assert (vpu_dtype_bench.WORDS, vpu_dtype_bench.THREADS) == (words,
                                                                threads)
    assert vpu_dtype_bench.ITERS % unroll == 0
    slots = 132 * 2048 // vpu_dtype_bench.THREADS
    idle = {}
    for dtype, rows in vpu_dtype_bench.CASES:
        words = vpu_dtype_bench.words_of(dtype, rows)
        blocks = words // vpu_dtype_bench.BLOCK_WORDS
        assert blocks * vpu_dtype_bench.BLOCK_WORDS == words
        idle[(dtype, rows)] = slots % blocks
    assert idle == {c: 64 if c in (("float32", 256), ("int32", 256)) else 0
                    for c in vpu_dtype_bench.CASES}


@pytest.mark.parametrize("dtype", list(vpu_dtype_bench.DTYPES))
def test_vpu_issue_ms_against_a_hand_count(dtype):
    """issue_ms: CYCLES per warp's word and iteration on one of an SM's 4
    sub-partitions, the blocks spread over the SMs in whole waves. Counted
    by hand at 128 threads and 2 words a thread, 1,980 MHz, 132 SMs: 256
    rows of float32 or int32 (32,768 words, 128 blocks a copy) at 16
    copies are 16 blocks an SM (2,048 blocks; some SMs 15), 64 warps, 16 a
    sub-partition, each 2 words x 2,000 rounds; one copy is one block an
    SM, 4 warps, 1 a sub-partition; the 16-bit types hold half the
    words."""
    us = 1e3 / 1980e6
    c = vpu_dtype_bench.CYCLES[dtype]
    full = 16 if dtype in ("float32", "int32") else 33
    assert vpu_dtype_bench.issue_ms(dtype, 256, full, 132,
                                    1980) == pytest.approx(
        16 * 2 * 2000 * c * us, rel=1e-12)
    assert vpu_dtype_bench.issue_ms(dtype, 256, 1, 132,
                                    1980) == pytest.approx(
        2 * 2000 * c * us, rel=1e-12)
    # a copy more: some SM runs a 17th block, one more warp a sub-partition
    assert vpu_dtype_bench.issue_ms(dtype, 256, full + 1, 132,
                                    1980) == pytest.approx(
        17 * 2 * 2000 * c * us, rel=1e-12)
    assert vpu_dtype_bench.CYCLES == {"float32": 4, "bfloat16": 4,
                                      "int32": 4, "int16": 8}


MODULES = (probe_mosaic, probe_mosaic2, probe_gather, probe_mosaic3,
           probe_chain, probe_body, probe_dyn_cost, vpu_dtype_bench)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors every wrapper returns its plain version's output and
    launches nothing: each module's counter stays 0."""
    for m in MODULES:
        m.launches = 0
    x = probe_mosaic.inputs()
    for b in probe_mosaic.BODIES:
        assert torch.equal(probe_mosaic.run(b, x), probe_mosaic.PLAIN[b](x))
    for b in probe_mosaic2.BODIES:
        assert torch.equal(probe_mosaic2.run(b, x),
                           probe_mosaic2.PLAIN[b](x))
    tbl, idx = probe_gather.i32_inputs()
    probe_gather.run_take(torch.from_numpy(tbl), torch.from_numpy(idx), 1)
    tbl, idx = probe_gather.timed_inputs("pages4")
    out = probe_gather.run("pages4", torch.from_numpy(tbl),
                           torch.from_numpy(idx), copies=2, shared=False)
    assert torch.equal(out[0], probe_gather.plain_pages(
        torch.from_numpy(tbl), torch.from_numpy(idx)))
    probe_mosaic3.run("none", probe_mosaic3.inputs("none"))
    out, aux = probe_chain.run("chase+vec", 1, probe_chain.inputs(),
                               copies=2)
    assert (out.shape, aux.shape) == ((2,), (2,))
    probe_chain.run("chase", 1, probe_chain.inputs())
    probe_dyn_cost.run("dyn1", probe_dyn_cost.inputs())
    vpu_dtype_bench.run("int16", vpu_dtype_bench.inputs("int16", 256))
    assert [m.launches for m in MODULES] == [0] * len(MODULES)


def test_mosaic_main_on_the_cpu(capsys):
    """main() --cpu runs the plain versions and prints the JAX file's
    lines (the cheaper probes; the others' plain versions take seconds at
    their full sizes)."""
    assert probe_mosaic.main(["--cpu"]) == 0
    assert probe_mosaic2.main(["--cpu"]) == 0
    assert probe_dyn_cost.main(["--cpu", "--blocks", "1"]) == 0
    out = capsys.readouterr().out
    assert "dot_broadcast: OK" in out and "stack_machine: OK  19.000" in out
    assert "async copy x4 overlap:" in out and "WRONG" not in out
