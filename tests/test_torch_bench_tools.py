"""The port's last host modules and tools against the JAX package's on the
CPU: light.sample_emission with the sampling helpers it needs, the
shading and texture-interface benchmarks, the independent engine
RefTracer (native/ref_bvh.cpp) with tools/bench_ref, and
utils/checkpoint.

Tolerances: RNG state bit-exact; the emission sample's fields within atol
1e-6 (sin/cos/sqrt may round an ULP apart between XLA and torch); the
benchmarks' checksum lines equal as printed (4 digits); RefTracer against
the brute-force oracle as the JAX package's own test holds it (prim_id
exact, t within 2e-5); files byte for byte.
"""
import io
import os
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodent_tpu.core import sampling as jsampling
from rodent_tpu.render import light as jlight
from rodent_tpu.tools import bench_interface as jbench_interface
from rodent_tpu.tools import bench_ref as jbench_ref
from rodent_tpu.tools import bench_shading as jbench_shading
from rodent_tpu.utils import checkpoint as jcheckpoint
from rodent_tpu_torch import native
from rodent_tpu_torch.accel import build_bvh
from rodent_tpu_torch.core import sampling
from rodent_tpu_torch.io import formats
from rodent_tpu_torch.render import light
from rodent_tpu_torch.tools import bench_interface, bench_ref, bench_shading
from rodent_tpu_torch.traversal import api
from rodent_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tables():
    """The triangle and point light cases of tests/test_parity.py:54-110,
    with a textureless second triangle so that the index picks rows."""
    tri = {"kind": [light.TRIANGLE, light.TRIANGLE],
           "v0": [[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
           "v1": [[1.0, 0.0, 0.0], [0.0, 1.0, 2.0]],
           "v2": [[0.0, 1.0, 0.0], [3.0, 1.0, 0.0]],
           "n": [[0.0, 0.0, 1.0], [0.0, -1.0, 0.0]],
           "inv_area": [2.0, 1.0 / 3.0],
           "color": [[3.0, 2.0, 1.0], [1.0, 1.0, 1.0]]}
    point = {"kind": [light.POINT], "v0": [[1.0, 2.0, 3.0]],
             "v1": [[0.0] * 3], "v2": [[0.0] * 3],
             "n": [[0.0, 0.0, 1.0]], "inv_area": [1.0],
             "color": [[4.0 * np.pi, 0.0, 0.0]]}
    return {"triangle": (tri, 512, 1), "point": (point, 256, 7)}


@pytest.mark.parametrize("case", ["triangle", "point"])
def test_sample_emission_matches_jax(case):
    rows, n, first = _tables()[case]
    n_lights = len(rows["kind"])
    idx = np.arange(n) % n_lights
    rnd = np.arange(first, first + n, dtype=np.uint32)
    jtab = {k: jnp.asarray(np.asarray(v, np.int32 if k == "kind"
                                      else np.float32))
            for k, v in rows.items()}
    ttab = {k: torch.tensor(np.asarray(v)) for k, v in jtab.items()}
    want, jrnd = jlight.sample_emission(
        jtab, jnp.asarray(idx.reshape(-1, 128), jnp.int32),
        jnp.asarray(rnd.reshape(-1, 128)))
    got, trnd = light.sample_emission(ttab, torch.as_tensor(idx),
                                      torch.as_tensor(rnd.astype(np.int64)))
    np.testing.assert_array_equal(trnd.numpy(),
                                  np.asarray(jrnd).ravel().astype(np.int64))
    assert set(got) == set(want)
    for key in want:
        w, g = want[key], got[key]
        for wc, gc in (zip(w, g) if isinstance(w, tuple) else [(w, g)]):
            np.testing.assert_allclose(gc.numpy(), np.asarray(wc).ravel(),
                                       rtol=0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", [
    "sample_uniform_sphere", "sample_cosine_hemisphere", "dir_from_polar",
    "sample_triangle", "sample_cosine_power_hemisphere"])
def test_sampling_helpers_match_jax(name):
    r = np.random.RandomState(3)
    u, v = (r.rand(1000).astype(np.float32) for _ in range(2))
    k = (r.rand(1000) * 40).astype(np.float32)
    tris = [r.randn(1000, 3).astype(np.float32) for _ in range(3)]
    args = {"sample_uniform_sphere": (u, v), "sample_cosine_hemisphere":
            (u, v), "dir_from_polar": (u, v, v * 6.0),
            "sample_triangle": (u, v, *tris),
            "sample_cosine_power_hemisphere": (k, u, v)}[name]
    want = getattr(jsampling, name)(*map(jnp.asarray, args))
    got = getattr(sampling, name)(*map(torch.as_tensor, args))
    for w, g in (zip(want, got) if isinstance(want, tuple)
                 else [(want, got)]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert sampling.uniform_sphere_pdf() == float(
        jsampling.uniform_sphere_pdf())


def _out(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("tool,mode", [
    ("shading", []), ("shading", ["--sorted"]), ("shading", ["--mono"]),
    ("interface", []), ("interface", ["--opaque"])])
def test_bench_tools_checksum_matches_jax(tool, mode):
    """--count 4096 --cpu: the checksum line equals the JAX tool's, and the
    rate line has the JAX tool's shape."""
    port, jax_tool = {"shading": (bench_shading, jbench_shading),
                      "interface": (bench_interface, jbench_interface)}[tool]
    argv = ["--count", "4096", "--cpu", "--bench", "3", *mode]
    got, want = _out(port.main, argv), _out(jax_tool.main, argv)
    assert got[0] == want[0]
    unit = want[1].split()[-1]
    assert got[1].endswith(unit) and float(got[1].split()[0]) > 0


def _soup(n, seed=0):
    r = np.random.RandomState(seed)
    base = r.randn(n, 3).astype(np.float32) * 2.0
    verts = np.concatenate(
        [base, base + r.randn(n, 3).astype(np.float32) * 0.5,
         base + r.randn(n, 3).astype(np.float32) * 0.5]).astype(np.float32)
    idx4 = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n,
                     np.zeros(n, np.int64)], 1).astype(np.int32)
    return verts, idx4


def _rays(n, seed=1):
    r = np.random.RandomState(seed)
    org = r.randn(n, 3).astype(np.float32) * 3.0
    d = r.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def test_ref_tracer_matches_bruteforce_oracle():
    """tests/test_bench_ref.py:42-65 on the port: RefTracer against the
    port's brute-force oracle."""
    verts, idx4 = _soup(300)
    org, d = _rays(400)
    tr = native.RefTracer(verts, idx4)
    t, pid, secs = tr.traverse(org, d, 0.0, 1e9)
    assert secs > 0 and tr.num_nodes > 1
    dev = api.bvh_to_device(build_bvh(verts, idx4.reshape(-1), arity=4,
                                      packet=4), "cpu")
    oracle = api.intersect_bruteforce(dev, api.make_rays(org, d, 0.0, 1e9))
    opid, ot = oracle["prim_id"].numpy(), oracle["t"].numpy()
    assert np.array_equal(pid >= 0, opid >= 0)
    both = pid >= 0
    assert np.array_equal(pid[both], opid[both])
    np.testing.assert_allclose(t[both], ot[both], rtol=2e-5, atol=2e-5)


def test_ref_tracer_matches_plain_traversal():
    """tests/test_bench_ref.py:68-83 on the port: the any-hit occlusion bit
    against the port's plain traversal (BVH8/Tri8), and the closest hits
    against it as well."""
    verts, idx4 = _soup(250, seed=3)
    org, d = _rays(300, seed=4)
    tr = native.RefTracer(verts, idx4)
    _, pid, _ = tr.traverse(org, d, 1e-3, 5.0, any_hit=True)
    dev = api.bvh_to_device(build_bvh(verts, idx4.reshape(-1), arity=8,
                                      packet=8), "cpu")
    rays = api.make_rays(org, d, 1e-3, 5.0)
    hit = api.traverse(dev, rays, any_hit=True)
    assert np.array_equal(pid >= 0, hit["prim_id"].numpy() >= 0)
    t, pid, _ = tr.traverse(org, d, 1e-3, 5.0)
    hit = api.traverse(dev, rays)
    np.testing.assert_array_equal(pid, hit["prim_id"].numpy())
    np.testing.assert_allclose(t, hit["t"].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dist", ["primary", "ao", "bounces"])
def test_bench_ref_fbuf_equals_jax(tmp_path, dist):
    """--scene hall --tris 20000 --width 64 --height 64: the .fbuf the
    port's tool writes equals the JAX tool's byte for byte (ao as any-hit
    occlusion flags, the others as hit distances), and its output has
    bench_embree's shape."""
    argv = ["--scene", "hall", "--tris", "20000", "--width", "64",
            "--height", "64", "--dist", dist, "--bench", "1"]
    lines = _out(bench_ref.main, argv + ["-o", str(tmp_path / "p.fbuf")])
    _out(jbench_ref.main, argv + ["-o", str(tmp_path / "j.fbuf")])
    assert (tmp_path / "p.fbuf").read_bytes() == \
        (tmp_path / "j.fbuf").read_bytes()
    assert lines[0].endswith("iteration(s)")
    assert lines[1].endswith("Mrays/sec")
    hits = int(lines[-1].split()[0])
    assert lines[-1].endswith("intersection(s)") and hits > 0
    vals = formats.read_fbuf(str(tmp_path / "p.fbuf"))
    assert len(vals) == 64 * 64
    if dist == "ao":
        assert set(np.unique(vals)) <= {0.0, 1.0}
        assert int(vals.sum()) == hits


def test_ref_bvh_source_is_the_jax_copy():
    """native/ref_bvh.cpp is a byte copy of the JAX package's: the
    independent engine is the same on both sides."""
    with open(os.path.join(REPO, "rodent_tpu_torch", "native",
                           "ref_bvh.cpp"), "rb") as a, \
            open(os.path.join(REPO, "rodent_tpu", "native", "ref_bvh.cpp"),
                 "rb") as b:
        assert a.read() == b.read()


def test_render_checkpoints_read_across_packages(tmp_path):
    """A checkpoint written by either package, from a torch film or an
    array, reads back through the other's loader unchanged."""
    film = torch.as_tensor(np.random.RandomState(2).rand(48, 3)
                           .astype(np.float32))
    checkpoint.save_render_checkpoint(tmp_path / "port.npz", film, 7,
                                      scene="hall", spp=4)
    jcheckpoint.save_render_checkpoint(tmp_path / "jax.npz",
                                       jnp.asarray(film.numpy()), 7,
                                       scene="hall", spp=4)
    for path in ("port.npz", "jax.npz"):
        for load in (checkpoint.load_render_checkpoint,
                     jcheckpoint.load_render_checkpoint):
            f, it, meta = load(tmp_path / path)
            assert f.dtype == np.float32
            np.testing.assert_array_equal(f, film.numpy())
            assert it == 7 and meta == {"scene": "hall", "spp": 4}


def test_build_bvh_cached_files_equal_jax(tmp_path):
    """build_bvh_cached writes the JAX function's file, under the same
    name, and reads it back as the tree it built."""
    verts, idx4 = _soup(200, seed=9)
    idx = idx4.reshape(-1)
    bvh = checkpoint.build_bvh_cached(verts, idx, cache_dir=tmp_path / "p")
    jcheckpoint.build_bvh_cached(verts, idx, cache_dir=tmp_path / "j")
    names = os.listdir(tmp_path / "p")
    assert names == os.listdir(tmp_path / "j") and len(names) == 1
    assert (tmp_path / "p" / names[0]).read_bytes() == \
        (tmp_path / "j" / names[0]).read_bytes()
    again = checkpoint.build_bvh_cached(verts, idx, cache_dir=tmp_path / "p")
    a = api.bvh_to_device(bvh, "cpu")
    b = api.bvh_to_device(again, "cpu")
    for key in ("nodes", "tris"):
        assert a[key].numpy().tobytes() == b[key].numpy().tobytes()
