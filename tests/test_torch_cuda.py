"""The CUDA kernels K1, K2 (prefetch) and K3 (pop counters) and the port's
slices on a CUDA card.

Every test here is marked `cuda` and skips where torch sees no card. The
file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest skips tests/conftest.py, which imports jax.)
"""
import numpy as np
import pytest
import torch

from rodent_tpu.accel import build_bvh
from rodent_tpu.utils import testscenes
from rodent_tpu_torch.render import film as film_mod
from rodent_tpu_torch.render.camera import Camera
from rodent_tpu_torch.render.compiler import compile_mesh
from rodent_tpu_torch.render.integrator import (
    render_iteration, render_iteration_persistent)
from rodent_tpu_torch.traversal import api, packet

pytestmark = pytest.mark.cuda

CASES = [(a, m) for a in (2, 4, 8) for m in (1, 4, 8, 16, 24)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _soup(n, seed):
    r = np.random.RandomState(seed)
    base = r.randn(n, 3).astype(np.float32) * 2.0
    v1 = base + r.randn(n, 3).astype(np.float32) * 0.5
    v2 = base + r.randn(n, 3).astype(np.float32) * 0.5
    verts = np.concatenate([base, v1, v2]).astype(np.float32)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n,
                    r.randint(0, 5, n)], axis=1).astype(np.int32)
    return verts, idx.reshape(-1)


def _rays(n, seed, device, tmax):
    r = np.random.RandomState(seed)
    org = r.randn(n, 3).astype(np.float32) * 3.0
    d = r.randn(n, 3).astype(np.float32)
    d[:32, 0] = 0.0                     # axis-parallel rays
    d[32:64, 1:] = 0.0
    tm = np.full(n, tmax, np.float32)
    tm[64:96] = -1.0                    # dead rays
    return api.make_rays(org, d, 0.0, tm, device=device)


def _cpu(hit):
    return {k: v.cpu().numpy() for k, v in hit.items()}


@pytest.mark.parametrize("arity,width", CASES)
def test_kernel_matches_plain(card, arity, width):
    """K1 against its plain version on the same card: closest-hit ids
    identical and t/u/v within atol 1e-5 / rtol 1e-6; any-hit hit/miss
    identical; one launch per call."""
    verts, idx = _soup(2000, seed=arity * 100 + width)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=arity,
                                      packet=width), card)
    for any_hit, tmax in ((False, 1e30), (True, 2.0)):
        rays = _rays(4096, width, card, tmax)
        packet.reset_launches()
        k = _cpu(packet.traverse_packet(dev, rays, any_hit=any_hit))
        assert packet.launches["bvh_traverse"] == 1
        p = _cpu(api.traverse(dev, rays, any_hit=any_hit))
        assert packet.launches["bvh_traverse"] == 1
        if any_hit:
            np.testing.assert_array_equal(k["prim_id"] >= 0,
                                          p["prim_id"] >= 0)
            continue
        np.testing.assert_array_equal(k["prim_id"], p["prim_id"])
        np.testing.assert_array_equal(k["geom_id"], p["geom_id"])
        for key in ("t", "u", "v"):
            np.testing.assert_allclose(k[key], p[key], atol=1e-5, rtol=1e-6)


def test_kernel_refuses_bad_inputs(card):
    verts, idx = _soup(200, seed=1)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8), card)
    rays = _rays(256, 2, card, 1e30)
    comps = [tuple(rays[k].unbind(-1)) for k in ("org", "dir", "inv_dir",
                                                 "inv_org")]
    with pytest.raises(ValueError, match="contiguous"):
        packet.traverse_packet_components(dev, *comps, rays["tmin"],
                                          rays["tmax"])
    comps = [tuple(c.contiguous() for c in v) for v in comps]
    with pytest.raises(ValueError, match="float32"):
        packet.traverse_packet_components(dev, *comps, rays["tmin"],
                                          rays["tmax"].double())
    with pytest.raises(ValueError, match="shape"):
        packet.traverse_packet_components(dev, *comps, rays["tmin"],
                                          rays["tmax"][:100])


def test_render_on_card_matches_cpu(card):
    """The slice through K1 on the card against the same slice through the
    plain traversal on the CPU: hall-20K, 32x24, spp 2, mpl 4. torch's
    CPU and CUDA sqrt/sin/cos/pow differ by ULPs, which can flip a Russian
    roulette draw, so the film is held to rtol 1e-4 / atol 1e-5 on >= 99%
    of pixels and its mean to 0.5%."""
    verts, idx = testscenes.make_hall(20_000)
    cam = Camera.make((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0,
                      32, 24)
    films = []
    for device in ("cpu", card):
        scene = compile_mesh(verts, idx, device, max_path_len=4,
                             emitter="inside")
        packet.reset_launches()
        film = render_iteration(scene.device, cam,
                                film_mod.new_film(32, 24, device), 32, 24,
                                2, 0)
        films.append(film.cpu().numpy())
    assert packet.launches["bvh_traverse"] > 0
    cpu, gpu = films
    close = np.isclose(gpu, cpu, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(gpu.mean() / cpu.mean() - 1.0) < 5e-3


@pytest.mark.parametrize("width", [8, 16, 24])
def test_prefetch_and_count_kernels(card, width):
    """K2 returns K1's hits bit for bit and K3 K1's hits plus counters
    equal to the plain version's, closest-hit and any-hit, on BVH8 soups
    with Tri8/16/24 rows; one launch of each per call."""
    verts, idx = _soup(3000, seed=7 * width)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=width),
                            card)
    for any_hit, tmax in ((False, 1e30), (True, 2.0)):
        rays = _rays(8192, width + 1, card, tmax)
        packet.reset_launches()
        k1 = packet.traverse_packet(dev, rays, any_hit=any_hit)
        k2 = packet.traverse_packet(dev, rays, any_hit=any_hit,
                                    prefetch=True)
        k3 = packet.traverse_packet(dev, rays, any_hit=any_hit,
                                    count_pops=True)
        p = api.traverse(dev, rays, any_hit=any_hit, count_pops=True)
        assert packet.launches == {"bvh_traverse": 1,
                                   "bvh_traverse_prefetch": 1,
                                   "bvh_traverse_count": 1}
        for key in ("t", "u", "v", "prim_id", "geom_id"):
            assert torch.equal(k2[key], k1[key]), key
            assert torch.equal(k3[key], k1[key]), key
        for key in ("pops", "leaf_pops"):
            assert torch.equal(k3[key], p[key]), key
        np.testing.assert_array_equal(k1["prim_id"].cpu().numpy() >= 0,
                                      p["prim_id"].cpu().numpy() >= 0)


def test_prefetch_refusals(card):
    """K2 and K3 exist for BVH8 only; CPU tensors never launch them."""
    verts, idx = _soup(500, seed=3)
    dev4 = api.bvh_to_device(build_bvh(verts, idx, arity=4, packet=8), card)
    rays = _rays(256, 4, card, 1e30)
    for kw in (dict(prefetch=True), dict(count_pops=True)):
        with pytest.raises(ValueError, match="built for BVH8"):
            packet.traverse_packet(dev4, rays, **kw)
    cpu = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8), "cpu")
    packet.reset_launches()
    packet.traverse_packet(cpu, _rays(256, 4, "cpu", 1e30), prefetch=True)
    assert set(packet.launches.values()) == {0}


def test_persistent_films_through_k1_and_k2(card):
    """hall-20K, 32x24, spp 2, pool 256: the persistent film through K1
    (packet=True) and through K2 (packet="hbm") on the card. The film
    splat sums each pixel in slot order (deterministic index_put_), and
    K2's hits are K1's, so the two films are equal bit for bit; against
    the CPU film (plain traversal) they are held to rtol 1e-4 / atol 1e-5
    on >= 99% of pixels and the mean to 0.5% (CPU and CUDA sqrt/sin/cos
    differ by ULPs, test_render_on_card_matches_cpu)."""
    verts, idx = testscenes.make_hall(20_000)
    cam = Camera.make((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0,
                      32, 24)
    films = {}
    for device, pk in (("cpu", True), (card, True), (card, "hbm")):
        scene = compile_mesh(verts, idx, device, max_path_len=4,
                             emitter="inside")
        packet.reset_launches()
        films[(str(device), pk)] = render_iteration_persistent(
            scene.device, cam, film_mod.new_film(32, 24, device), 32, 24,
            2, 0, pool=256, packet=pk, sort="pool").cpu().numpy()
    assert packet.launches["bvh_traverse_prefetch"] > 0
    assert packet.launches["bvh_traverse"] == 0
    k1, k2 = films[("cuda", True)], films[("cuda", "hbm")]
    np.testing.assert_array_equal(k2, k1)
    cpu = films[("cpu", True)]
    close = np.isclose(k1, cpu, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(k1.mean() / cpu.mean() - 1.0) < 5e-3
