"""The port's own host modules against the JAX package's on the CPU.

rodent_tpu_torch keeps copies of the jax-free host code it needs
(native/, io/, accel/, utils/testscenes.py). Held here: the BVH builds give
node and Tri tables byte-identical to rodent_tpu.accel.build_bvh after
bvh_to_device, the procedural scenes and ray fixtures are equal arrays,
LZ4 round-trips across both codecs, .bvh files read back alike through
both formats modules, and PNG bytes are equal. The port's native library
raises where it cannot be built (the JAX package falls back to numpy).
"""
import numpy as np
import pytest
import torch

from rodent_tpu.accel import build_bvh as jbuild
from rodent_tpu.io import formats as jformats
from rodent_tpu.io import png as jpng
from rodent_tpu.traversal import api as japi
from rodent_tpu.utils import testscenes as jscenes
from rodent_tpu_torch import native
from rodent_tpu_torch.accel import WideBvh, build_bvh
from rodent_tpu_torch.io import formats, png
from rodent_tpu_torch.traversal import api as tapi
from rodent_tpu_torch.utils import testscenes
from test_traversal import random_tri_soup

torch.set_num_threads(1)


def _same_tables(verts, idx, **kw):
    want = japi.bvh_to_device(jbuild(verts, idx, **kw))
    got = tapi.bvh_to_device(build_bvh(verts, idx, **kw), "cpu")
    for key in ("nodes", "tris"):
        a, b = np.asarray(want[key]), got[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key
    assert (got["meta"].shared_stack, got["meta"].node_stack) == (
        want["meta"].shared_stack, want["meta"].node_stack)
    return got


@pytest.mark.parametrize("arity", [2, 4, 8])
@pytest.mark.parametrize("packet", [1, 4, 8, 16, 24])
def test_build_bvh_soup_byte_identical(arity, packet):
    verts, idx = random_tri_soup(700, seed=arity * 31 + packet)
    _same_tables(verts, idx, arity=arity, packet=packet)


def test_build_bvh_hall_byte_identical():
    """hall-20K, the SBVH tier (quality 1) with the hall build's leaf
    threshold."""
    verts, idx = testscenes.make_hall(20_000)
    got = _same_tables(verts, idx, arity=8, packet=8, quality=1,
                       leaf_threshold=12)
    assert got["nodes"].shape[0] > 100


def test_build_bvh_powerplant_byte_identical():
    """The big-scene build (binned SAH, Tri24, leaf_cost 0.45) on a small
    powerplant."""
    verts, idx = testscenes.make_powerplant(60_000)
    got = _same_tables(verts, idx, arity=8, packet=24, quality=0,
                       leaf_threshold=12, leaf_cost=0.45)
    assert got["tris"].shape[1] == 14 * 24


@pytest.mark.parametrize("name,size", [("hall", 30_000), ("crown", 20_000),
                                       ("powerplant", 40_000)])
def test_scenes_and_primary_rays_equal(name, size):
    for suffix, args in ((f"make_{name}", (size,)),
                         (f"{name}_primary_rays", (48, 32))):
        want = getattr(jscenes, suffix)(*args)
        got = getattr(testscenes, suffix)(*args)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_secondary_rays_equal():
    verts, idx = testscenes.make_hall(5_000)
    org, dirs = testscenes.hall_primary_rays(32, 16)
    dev = tapi.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8),
                             "cpu")
    hit = tapi.traverse(dev, tapi.make_rays(org, dirs, 0.0, 1e30))
    t, pid = hit["t"].numpy(), hit["prim_id"].numpy()
    for kind in ("ao", "bounces"):
        want = jscenes.secondary_rays_from_trace(
            kind, org, dirs, t, pid, verts, idx.reshape(-1, 4))
        got = testscenes.secondary_rays_from_trace(
            kind, org, dirs, t, pid, verts, idx.reshape(-1, 4))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        hp = org + dirs
        nrm = np.tile(np.float32([[0.0, 1.0, 0.0]]), (len(org), 1))
        for a, b in zip(testscenes.hall_secondary_rays(kind, hp, nrm),
                        jscenes.hall_secondary_rays(kind, hp, nrm)):
            np.testing.assert_array_equal(a, b)


def test_lz4_round_trip_across_codecs(tmp_path):
    from rodent_tpu import native as jnative
    r = np.random.RandomState(9)
    data = np.concatenate([np.zeros(5000, np.uint8),
                           r.randint(0, 4, 20_000).astype(np.uint8),
                           r.randint(0, 256, 3000).astype(np.uint8)])
    raw = data.tobytes()
    comp = native.lz4_compress(raw)
    assert len(comp) < len(raw)
    assert comp == jnative.lz4_compress(raw)
    assert native.lz4_decompress(comp, len(raw)) == raw
    assert jnative.lz4_decompress(comp, len(raw)) == raw
    with pytest.raises(ValueError):
        native.lz4_decompress(comp, len(raw) + 1)
    path = tmp_path / "b.bin"
    formats.write_lz4_buffer(path, data)
    np.testing.assert_array_equal(jformats.read_lz4_buffer(path), data)
    np.testing.assert_array_equal(formats.read_lz4_buffer(path), data)


def test_bvh_files_read_alike(tmp_path):
    verts, idx = random_tri_soup(400, seed=3)
    blocks = [build_bvh(verts, idx, arity=a, packet=m).to_block()
              for a, m in ((8, 4), (4, 4), (2, 1))]
    path = str(tmp_path / "s.bvh")
    formats.write_bvh(path, blocks)
    for btype in (formats.BVH8_TRI4, formats.BVH4_TRI4, formats.BVH2_TRI1):
        a = formats.read_bvh(path, btype)
        b = jformats.read_bvh(path, btype)
        assert a.type == b.type == btype
        assert a.nodes.tobytes() == b.nodes.tobytes()
        assert a.tris.tobytes() == b.tris.tobytes()
        back = WideBvh.from_block(a)
        assert back.num_packets == len(a.tris)


def test_png_bytes_equal(tmp_path):
    img = (np.arange(40 * 24 * 3) % 253).astype(np.uint8).reshape(24, 40, 3)
    png.write_png(tmp_path / "a.png", img)
    jpng.write_png(tmp_path / "b.png", img)
    assert (tmp_path / "a.png").read_bytes() == (
        tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(png.read_png(tmp_path / "b.png"), img)


def test_native_library_without_a_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build(build_dir=tmp_path)
    assert not any(tmp_path.iterdir())


def test_native_library_is_keyed_by_the_host_cpu(tmp_path, monkeypatch):
    """The library is built with -march=native, so its file name carries
    the host CPU: a library built on one CPU is not loaded on another."""
    here = native.library_path(tmp_path)
    assert native.library_path(tmp_path) == here
    assert native.cpu_identity()
    monkeypatch.setattr(native, "cpu_identity",
                        lambda: "vendor_id: OtherVendor\nflags: fpu")
    other = native.library_path(tmp_path)
    assert other != here and other.parent == here.parent
