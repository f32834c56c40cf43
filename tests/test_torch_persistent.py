"""The port's big-scene path on the CPU: the tier rule and render policy of
rodent_tpu_torch.render.compiler against rodent_tpu.render.compiler, and
the persistent wavefront renderer against the JAX package's and against
itself.

Films of the two packages differ by the FMA-contraction ULPs of ROADMAP
C2, which flip a few Russian-roulette draws, so the cross-package check has
a pixel-share tolerance (stated in the test). Inside the port, the
persistent film keys every sample by its id, so it must not change in a
single bit with the pool, the retirement period, the sort, the kernel
route (K1 and K2 run the same plain version on the CPU) or the sharding
hooks: spp is 2 and the film starts at zero, so each pixel's sum has two
terms and its order cannot matter.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodent_tpu.render import compiler as jcomp
from rodent_tpu.render.camera import Camera as JCamera
from rodent_tpu.render.integrator import render_debug as jdebug
from rodent_tpu.render.integrator import (
    render_iteration_persistent as jpersistent)
from rodent_tpu.utils import testscenes
from rodent_tpu_torch.render import compiler as tcomp
from rodent_tpu_torch.render import film as film_mod
from rodent_tpu_torch.render import integrator
from rodent_tpu_torch.render.camera import Camera
from rodent_tpu_torch.traversal import packet

HALL_CAM = ((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0)
W, H, SPP = 32, 24, 2
BIG_BVH = {"packet": 24, "quality": 0, "leaf_threshold": 12,
           "leaf_cost": 0.45}

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hall():
    """hall-20K compiled by the JAX package, and the port's copy of its
    tables (test_torch_render.py holds the two byte for byte)."""
    verts, idx = testscenes.make_hall(20_000)
    jscene = jcomp.compile_mesh(verts, idx, max_path_len=4,
                                emitter="inside")
    scene = tcomp.from_jax_device(
        jax.tree_util.tree_map(np.asarray, jscene.device), "cpu")
    return jscene, scene


@pytest.fixture(scope="module")
def base_film(hall):
    """The port's persistent film with the JAX package's defaults."""
    return _persistent(hall[1], pool=256)


def _persistent(scene, **kw):
    return integrator.render_iteration_persistent(
        scene, Camera.make(*HALL_CAM, W, H), film_mod.new_film(W, H, "cpu"),
        W, H, SPP, 0, **kw).numpy()


def _scenes():
    """(name, verts, idx, bvh_kwargs): a 40-triangle soup (dense tier),
    hall-20K, and powerplant-20K built as the big scene is (Tri24)."""
    r = np.random.RandomState(5)
    soup_v = r.randn(120, 3).astype(np.float32)
    soup_i = np.concatenate([np.arange(120).reshape(40, 3),
                             np.zeros((40, 1), int)], 1).astype(np.int32)
    yield "soup", soup_v, soup_i.reshape(-1), None
    yield ("hall", *testscenes.make_hall(20_000), None)
    yield ("powerplant", *testscenes.make_powerplant(20_000), BIG_BVH)


def test_tiers_match_jax():
    """packet_mode, packet_ok and shell_coverage equal the JAX package's
    at the default limit (80 MiB for tables on the CPU) and at limits
    chosen around each scene's table sizes, so that every tier occurs:
    dense (the soup), hybrid, hybrid-hbm and hybrid-giga. select_packet
    is the JAX package's TPU branch, and select_render_policy gives the
    port's dicts."""
    seen = set()
    for name, verts, idx, kw in _scenes():
        jdev = jcomp.compile_mesh(verts, idx, bvh_kwargs=kw).device
        dev = tcomp.compile_mesh(verts, idx, "cpu", bvh_kwargs=kw).device
        nodes_b = dev["bvh"]["nodes"].numel() * 4
        both_b = nodes_b + dev["bvh"]["tris"].numel() * 4
        assert tcomp.fast_memory_bytes(dev) == 80 * 1024 * 1024
        assert tcomp.shell_coverage(dev) == jcomp.shell_coverage(jdev)
        for limit in (None, both_b, both_b - 1, nodes_b, nodes_b - 1):
            lim = {} if limit is None else {"limit_bytes": limit}
            mode = tcomp.packet_mode(dev, **lim)
            assert mode == jcomp.packet_mode(jdev, **lim), (name, limit)
            assert tcomp.packet_ok(dev, **lim) == jcomp.packet_ok(jdev,
                                                                  **lim)
            assert tcomp.select_packet(dev, **lim) == (
                True if mode == "dense" else mode)
            pol = tcomp.select_render_policy(dev, **lim)
            if mode == "dense":
                assert pol == {"packet": True, "retire_every": 2}
            elif mode == "hybrid":
                assert pol == ({"packet": True, "pool": 1 << 16}
                               if tcomp.shell_coverage(dev) >= 0.5
                               else {"packet": True})
            else:
                assert pol == {"packet": mode[len("hybrid-"):],
                               "sort": "pool"}
            seen.add(mode)
        if name == "hall":
            assert tcomp.select_render_policy(dev)["pool"] == 1 << 16
        if name == "powerplant":
            assert tcomp.select_render_policy(
                dev, limit_bytes=nodes_b) == {"packet": "hbm",
                                              "sort": "pool"}
    assert seen == {"dense", "hybrid", "hybrid-hbm", "hybrid-giga"}


def test_persistent_matches_jax(hall, base_film):
    """hall-20K, 32x24, spp 2, mpl 4, pool 256 (six pool generations):
    the port's persistent renderer against the JAX package's with its
    dual-queue traversal, on the same tables. Measured: 760 of 768 pixels
    (98.96%) within rtol 1e-4 / atol 1e-5, 174 bit-identical, mean
    radiance 2.1e-5 apart (relative). The eight others are Russian-roulette
    flips from XLA's contracted multiply-adds (ROADMAP C2); PR 1's spp 1
    film had 6 of 768, and spp 2 doubles the draws, so the bound is 98.5%
    of pixels and the mean within 0.5%."""
    jscene, _ = hall
    want = np.asarray(jpersistent(
        jscene.device, JCamera.make(*HALL_CAM, W, H),
        jnp.zeros((W * H, 3), jnp.float32), W, H, SPP, 0, pool=256,
        packet=False))
    got = base_film
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.985, close.mean()
    assert abs(got.mean() / want.mean() - 1.0) < 5e-3
    assert np.isfinite(got).all() and got.min() >= 0.0


@pytest.mark.parametrize("kw", [
    dict(pool=256, retire_every=3),
    dict(pool=256, sort=True),
    dict(pool=256, sort="pool"),
    dict(pool=1024),
    dict(pool=256, packet="hbm"),
    dict(pool=256, packet="hybrid-hbm", sort="pool", retire_every=3),
    dict(pool=256, bounce_packet="hbm", depth_split=True, sort="pool"),
    dict(pool=200, shadow_packet="giga", sort="pool", retire_every=2),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_persistent_film_bit_identical(hall, base_film, kw):
    """Pool size, deferred retirement, per-call and pool sorts, the depth
    split and the kernel route leave the film unchanged bit for bit."""
    np.testing.assert_array_equal(_persistent(hall[1], **kw), base_film)


def test_persistent_matches_progressive(hall, base_film):
    """The persistent film against the progressive renderer's
    (test_render.py:101-113: rtol 1e-5 / atol 1e-6). Measured: equal bit
    for bit."""
    prog = integrator.render_iteration(
        hall[1], Camera.make(*HALL_CAM, W, H),
        film_mod.new_film(W, H, "cpu"), W, H, SPP, 0).numpy()
    np.testing.assert_allclose(base_film, prog, rtol=1e-5, atol=1e-6)
    assert base_film.mean() > 0.0


def test_sharding_hooks(hall, base_film):
    """pixel_lo / n_pixels strips rendered into strip-sized films
    concatenate to the full film, and a split of the samples (sample_lo,
    spp_weight) sums to it; return_steps reports the step count."""
    scene = hall[1]
    cam = Camera.make(*HALL_CAM, W, H)
    half = W * H // 2
    strips = [integrator.render_iteration_persistent(
        scene, cam, film_mod.new_film(W, H // 2, "cpu"), W, H, SPP, 0,
        pool=256, pixel_lo=lo, n_pixels=half).numpy()
        for lo in (0, half)]
    np.testing.assert_array_equal(np.concatenate(strips), base_film)
    film = film_mod.new_film(W, H, "cpu")
    steps = []
    for s in range(SPP):
        film, n = integrator.render_iteration_persistent(
            scene, cam, film, W, H, 1, 0, pool=256, sample_lo=s,
            spp_weight=1.0 / SPP, return_steps=True)
        steps.append(n)
    np.testing.assert_array_equal(film.numpy(), base_film)
    assert all(n > 0 for n in steps)


def test_unported_engines_raise(hall, monkeypatch):
    """The arguments that raised until the dual-queue engine (packet=False,
    compact, sub) and the dense engine (packet="dense") were ported now run
    in both renderers on the CPU: each reaches its own engine, with no
    fallback to the packet route, launches no kernel, and gives the packet
    route's film bit for bit (the engines share the slab test and the
    Moller-Trumbore float operations). The dense engine, which tests every
    Tri packet, runs on a dense-tier scene (the 40-triangle soup) instead
    of hall-20K's thousands of packets. compact and sub with the packet
    route change nothing, as in the JAX package. An unknown engine still
    raises."""
    soup_v, soup_i = next(_scenes())[1:3]
    scenes = {"tiled": hall[1],
              "dense": tcomp.compile_mesh(soup_v, soup_i, "cpu",
                                          max_path_len=4,
                                          emitter="inside").device}
    assert tcomp.packet_mode(scenes["dense"]) == "dense"
    cams = {"tiled": Camera.make(*HALL_CAM, 8, 8),
            "dense": Camera.make((0, 0, 4), (0, 0, -1), (0, 1, 0), 60.0, 8,
                                 8)}
    calls = {"tiled": 0, "dense": 0}

    def spy(name, fn):
        def counted(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return counted

    monkeypatch.setattr(integrator, "traverse_components",
                        spy("tiled", integrator.traverse_components))
    monkeypatch.setattr(integrator, "traverse_dense_components",
                        spy("dense", integrator.traverse_dense_components))
    packet.reset_launches()

    def film(render, engine, **kw):
        engine = engine or "tiled"
        return render(scenes[engine], cams[engine],
                      film_mod.new_film(8, 8, "cpu"), 8, 8, 1, 0,
                      **kw).numpy()

    for render, cases in (
            (integrator.render_iteration_persistent,
             ((dict(packet=False), "tiled"), (dict(packet="dense"), "dense"),
              (dict(bounce_packet=False), "tiled"),
              (dict(shadow_packet="dense"), "dense"),
              (dict(compact=5), None), (dict(sub=2), None))),
            (integrator.render_iteration,
             ((dict(packet=False), "tiled"),
              (dict(packet="dense"), "dense")))):
        for kw, engine in cases:
            want = film(render, engine)
            assert want.mean() > 0.0
            before = dict(calls)
            np.testing.assert_array_equal(film(render, engine, **kw), want)
            assert {k: calls[k] > before[k] for k in calls} == {
                k: k == engine for k in calls}, kw
    with pytest.raises(ValueError, match="unknown packet engine"):
        integrator.render_debug(hall[1], cams["tiled"],
                                film_mod.new_film(8, 8, "cpu"), 8, 8, 0,
                                packet="tiled")
    assert set(packet.launches.values()) == {0}


def test_render_debug_matches_jax(hall):
    """The eye-light debug renderer against the JAX package's on the same
    tables: one traversal and a clamped cosine per pixel, within the
    cross-package film tolerance rtol 1e-4 / atol 1e-5 (ROADMAP). There is
    no random draw to flip, so every pixel is held to it. Measured: max
    abs difference 2.1e-6 (XLA's contracted multiply-adds in the
    normal)."""
    jscene, scene = hall
    want = np.asarray(jdebug(jscene.device, JCamera.make(*HALL_CAM, W, H),
                             jnp.zeros((W * H, 3), jnp.float32), W, H, 0))
    got = integrator.render_debug(scene, Camera.make(*HALL_CAM, W, H),
                                  film_mod.new_film(W, H, "cpu"), W, H,
                                  0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got.mean() > 0.1
