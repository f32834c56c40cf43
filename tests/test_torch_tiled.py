"""rodent_tpu_torch.traversal.tiled (the dual-queue engine with staged
compaction) against rodent_tpu.traversal.tiled on the CPU, and the
renderers on it against the JAX renderer.

Traversal (tests/test_traversal.py pattern): random triangle soups of 257
and 300 triangles, BVH4/8 with Tri4/8 rows, 300 and 1,500 rays with
axis-parallel and dead ones: prim_id/geom_id exact, t/u/v within atol
1e-5 and rtol 1e-6, any-hit hit/miss exact, and the engine's trip
counters (iters, leaf_iters, live_sum) exactly equal, since the port keeps
the JAX engine's lockstep schedule. Staged compaction is exactly equal to
the single-stage loop (and the stages are seen to run, on 4,000 sorted
rays: 32 rows halve to 16 and 8); sub_batches=2 equals the JAX engine's.

Films: under `jit` XLA contracts multiply-adds (ROADMAP C2), which flips a
few Russian-roulette draws of the JAX film: on hall-20K at 32x32, spp 2,
the port's dual-queue film held 98.5% of its pixels within the North
star's rule. Op by op (`jax.disable_jit()`) nothing is contracted, so the
JAX persistent film here is rendered op by op at 16x12, spp 1, mpl 4,
and the port's films are held to the North star's rule: at least 99% of
pixels within rtol 1e-4 / atol 1e-5 and the mean within 0.5%. The same
JAX film holds the port's K1 film (test_persistent_matches_jax asserts
98.5% under `jit`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodent_tpu.accel import build_bvh
from rodent_tpu.render import compiler as jcomp
from rodent_tpu.render.camera import Camera as JCamera
from rodent_tpu.render.integrator import render_iteration as jprogressive
from rodent_tpu.render.integrator import (
    render_iteration_persistent as jpersistent)
from rodent_tpu.traversal import api as japi
from rodent_tpu.traversal.sorting import sort_rays as jsort_rays
from rodent_tpu.traversal.tiled import traverse_tiled as jtiled
from rodent_tpu.utils import testscenes
from rodent_tpu_torch.render import compiler as tcomp
from rodent_tpu_torch.render import film as film_mod
from rodent_tpu_torch.render import integrator
from rodent_tpu_torch.render.camera import Camera
from rodent_tpu_torch.traversal import api as tapi
from rodent_tpu_torch.traversal import packet, tiled
from test_traversal import random_rays as jrandom_rays
from test_traversal import random_tri_soup

# soup triangles, rays, arity, Tri packet
CASES = [(257, 300, 4, 4), (257, 300, 8, 8), (300, 1500, 4, 8),
         (300, 1500, 8, 4)]
HALL_CAM = ((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0)
W, H, SPP, POOL = 16, 12, 1, 192

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)


def soup_rays(n, seed, tmax):
    """Random rays with axis-parallel ones and every seventh dead."""
    r = np.random.RandomState(seed)
    org = r.randn(n, 3).astype(np.float32) * 3.0
    d = r.randn(n, 3).astype(np.float32)
    d[:8, 0] = 0.0
    d[8:16, 1:] = 0.0
    tm = np.full(n, tmax, np.float32)
    tm[::7] = -1.0
    return org, d, tm


def assert_hits(got, want, any_hit=False):
    got = {k: v.numpy() for k, v in got.items() if k != "counters"}
    want = {k: np.asarray(v) for k, v in want.items() if k != "counters"}
    if any_hit:
        np.testing.assert_array_equal(got["prim_id"] >= 0,
                                      want["prim_id"] >= 0)
        return
    for k in ("prim_id", "geom_id"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("ntri,nray,arity,m", CASES)
def test_tiled_matches_jax(ntri, nray, arity, m):
    verts, idx = random_tri_soup(ntri, seed=47)
    bvh = build_bvh(verts, idx, arity=arity, packet=m)
    jdev = japi.bvh_to_device(bvh)
    tdev = tapi.bvh_to_device(bvh, "cpu")
    for any_hit, tmax in ((False, 1e30), (True, 2.0)):
        org, d, tm = soup_rays(nray, 49, tmax)
        want = jtiled(jdev, japi.make_rays(org, d, np.zeros(nray, np.float32),
                                           tm),
                      any_hit=any_hit, debug_counters=True)
        got = tiled.traverse_tiled(tdev, tapi.make_rays(org, d, 0.0, tm),
                                   any_hit=any_hit, debug_counters=True)
        assert_hits(got, want)
        assert 0.0 < (got["prim_id"] >= 0).float().mean() < 1.0
        assert {k: float(v) for k, v in got["counters"].items()} == {
            k: float(v) for k, v in want["counters"].items()}
        assert got["counters"]["iters"] > got["counters"]["leaf_iters"] > 0
        dead = tm < 0
        assert (got["prim_id"].numpy()[dead] == -1).all()
        np.testing.assert_array_equal(got["t"].numpy()[dead], tm[dead])


@pytest.fixture(scope="module")
def sorted_soup():
    """300 triangles and 4,000 sorted rays (every seventh dead): 32 rows
    of 128 slots, so compaction halves them twice."""
    verts, idx = random_tri_soup(300, seed=47)
    bvh = build_bvh(verts, idx, arity=8)
    rays = jrandom_rays(4000, seed=53)
    rays["tmax"] = rays["tmax"].at[::7].set(-1.0)
    rays = jsort_rays(rays, verts.min(0), verts.max(0))[0]
    trays = {k: torch.from_numpy(np.array(v)) for k, v in rays.items()}
    return japi.bvh_to_device(bvh), tapi.bvh_to_device(bvh, "cpu"), rays, \
        trays


def _spy_stages(monkeypatch):
    """Records the stop_rows of every lockstep loop the engine runs."""
    stops = []
    loop = tiled._stage_loop

    def spy(*args, **kw):
        stops.append(args[3])
        return loop(*args, **kw)

    monkeypatch.setattr(tiled, "_stage_loop", spy)
    return stops


def test_tiled_staged_compaction_matches(sorted_soup, monkeypatch):
    """compact_stages=6 is exactly equal to the single-stage loop
    (tests/test_traversal.py:210-232), closest- and any-hit, on a bundle
    where the cascade runs: loops that stop at 16 and 8 live rows, then
    the drain. The single-stage loop equals the JAX engine (closest-hit;
    test_tiled_sub_batches_match_jax holds any-hit on these rays)."""
    jdev, tdev, rays, trays = sorted_soup
    stops = _spy_stages(monkeypatch)
    for any_hit in (False, True):
        base = tiled.traverse_tiled(tdev, trays, any_hit=any_hit)
        if not any_hit:
            assert_hits(base, jtiled(jdev, rays))
        del stops[:]
        got = tiled.traverse_tiled(tdev, trays, any_hit=any_hit,
                                   compact_stages=6)
        assert stops == [16, 8, 0]
        for k in ("t", "u", "v", "prim_id", "geom_id"):
            assert torch.equal(got[k], base[k]), k
    assert (base["prim_id"] >= 0).float().mean() > 0.1


def test_tiled_sub_batches_match_jax(sorted_soup, monkeypatch):
    """sub_batches=2 traces the 32 rows as two chunks of 16, each with its
    own leaf gate and, with compact_stages=5, its own compaction, as the
    JAX engine's lax.map does: any-hit hits equal the JAX engine's, and
    closest-hit hits the single chunk's."""
    jdev, tdev, rays, trays = sorted_soup
    stops = _spy_stages(monkeypatch)
    got = tiled.traverse_tiled(tdev, trays, any_hit=True, sub_batches=2,
                               compact_stages=5)
    assert stops == [8, 0, 8, 0]
    assert_hits(got, jtiled(jdev, rays, any_hit=True, sub_batches=2,
                            compact_stages=5), any_hit=True)
    assert 0.0 < (got["prim_id"] >= 0).float().mean() < 1.0
    del stops[:]
    got = tiled.traverse_tiled(tdev, trays, sub_batches=2)
    assert stops == [0, 0]
    base = tiled.traverse_tiled(tdev, trays)
    for k in ("t", "u", "v", "prim_id", "geom_id"):
        assert torch.equal(got[k], base[k]), k


@pytest.fixture(scope="module")
def hall():
    """hall-20K compiled by the JAX package, and the port's copy of its
    tables."""
    verts, idx = testscenes.make_hall(20_000)
    jscene = jcomp.compile_mesh(verts, idx, max_path_len=4,
                                emitter="inside")
    scene = tcomp.from_jax_device(
        jax.tree_util.tree_map(np.asarray, jscene.device), "cpu")
    return jscene, scene


@pytest.fixture(scope="module")
def jax_persistent_film(hall):
    """The JAX persistent film on its dual-queue engine with staged
    compaction (packet=False, compact=5: the golden images'
    configuration), op by op."""
    with jax.disable_jit():
        return np.asarray(jpersistent(
            hall[0].device, JCamera.make(*HALL_CAM, W, H),
            jnp.zeros((W * H, 3), jnp.float32), W, H, SPP, 0, pool=POOL,
            packet=False, compact=5))


def assert_film_rule(got, want):
    """ROADMAP's North star rule for films against the JAX renderer."""
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() / want.mean() - 1.0) < 5e-3
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.mean() > 0.0


def _port_film(render, scene, **kw):
    return render(scene, Camera.make(*HALL_CAM, W, H),
                  film_mod.new_film(W, H, "cpu"), W, H, SPP, 0,
                  **kw).numpy()


def test_persistent_tiled_matches_jax(hall, jax_persistent_film):
    """The port's persistent renderer on its dual-queue engine, with
    staged compaction, against the JAX renderer in the same configuration
    (hall-20K, 16x12, spp 1, mpl 4, a pool of all 192 samples), launching
    no kernel. Measured: every pixel within the rule, 175 of 192 bit for
    bit, the mean equal."""
    packet.reset_launches()
    got = _port_film(integrator.render_iteration_persistent, hall[1],
                     pool=POOL, packet=False, compact=5)
    assert set(packet.launches.values()) == {0}
    assert_film_rule(got, jax_persistent_film)


def test_persistent_matches_jax_op_by_op(hall, jax_persistent_film):
    """ROADMAP C2: the port's persistent renderer with its default engine
    (K1's plain version on the CPU) against the JAX dual-queue film with
    XLA's contraction out of the way (op by op) holds the North star's 99%
    of pixels, where test_persistent_matches_jax (under `jit`) holds
    98.5%. Measured: every pixel within the rule, 175 of 192 bit for bit,
    the mean equal."""
    assert_film_rule(_port_film(integrator.render_iteration_persistent,
                                hall[1], pool=POOL), jax_persistent_film)


def test_progressive_tiled_matches_jax(hall):
    """The progressive renderer on the dual-queue engine against the JAX
    renderer's (packet=False) under the North star's rule. The JAX film is
    rendered under `jit` (op by op it takes 32 s here, three times as
    long). Measured: 191 of 192 pixels within the rule (one draw flips),
    82 bit for bit, the mean 1.1e-6 apart (relative)."""
    want = np.asarray(jprogressive(
        hall[0].device, JCamera.make(*HALL_CAM, W, H),
        jnp.zeros((W * H, 3), jnp.float32), W, H, SPP, 0, packet=False))
    assert_film_rule(_port_film(integrator.render_iteration, hall[1],
                                packet=False), want)


def test_persistent_compaction_film_bit_identical(hall, monkeypatch):
    """A pool of 2,048 slots (16 rows), where the renderer's dual-queue
    traversals compact: its film equals the single-stage film and the
    packet route's bit for bit (the engines are exact-parity), and the
    cascade is seen to run."""
    stops = _spy_stages(monkeypatch)
    cam = Camera.make(*HALL_CAM, 32, 32)

    def film(**kw):
        return integrator.render_iteration_persistent(
            hall[1], cam, film_mod.new_film(32, 32, "cpu"), 32, 32, 2, 0,
            pool=2048, **kw).numpy()

    got = film(packet=False, compact=5)
    assert 8 in stops
    np.testing.assert_array_equal(got, film(packet=False))
    np.testing.assert_array_equal(got, film())
    assert got.mean() > 0.0
