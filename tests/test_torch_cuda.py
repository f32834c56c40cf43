"""The CUDA kernels K1, K2 (prefetch), K3 (pop counters), each in both
bodies (the group stack and the first body), K4 (the options of the
legacy Pallas body), K5 (the tile-shared stack), K6 (the
pair layout) and the micro-probes (csrc/probes.cu) and the port's slices
on a CUDA card.

Every test here is marked `cuda` and skips where torch sees no card. The
file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest skips tests/conftest.py, which imports jax.)
"""
import numpy as np
import pytest
import torch

from rodent_tpu_torch.accel import build_bvh
from rodent_tpu_torch.experiments import (ab_body, ab_tile_body, common,
                                          probe_body,
                                          probe_chain, probe_dyn_cost,
                                          probe_gather, probe_mosaic,
                                          probe_mosaic2, probe_mosaic3,
                                          vpu_dtype_bench)
from rodent_tpu_torch.render import film as film_mod
from rodent_tpu_torch.render import integrator, texture
from rodent_tpu_torch.render.camera import Camera
from rodent_tpu_torch.render.compiler import compile_mesh
from rodent_tpu_torch.render.integrator import (
    render_iteration, render_iteration_persistent)
from rodent_tpu_torch.traversal import api, packet, pair
from rodent_tpu_torch.utils import testscenes

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


@pytest.mark.parametrize("flt", ["nearest", "bilinear"])
@pytest.mark.parametrize("border", ["clamp", "repeat"])
def test_sample_bank_on_card_equals_cpu(card, border, flt):
    """texture.sample_bank and the integrator's bank lookup on the card
    give the CPU's values bit for bit (one elementwise torch op at a time:
    nothing to contract)."""
    r = np.random.RandomState(21)
    imgs = [r.rand(*s, 3).astype(np.float32) for s in ((7, 5), (64, 32))]
    bank, hw = texture.build_bank(imgs)
    uv = r.uniform(-3, 3, (100_000, 2)).astype(np.float32)
    tid = r.randint(-1, 2, 100_000).astype(np.int32)
    out = []
    for device in ("cpu", card):
        b, h, t, u = (torch.from_numpy(x).to(device)
                      for x in (bank, hw, tid, uv))
        got = texture.sample_bank(b, h, t, u, border, flt)
        scene = {"textures": b, "tex_hw": h}
        lookup = integrator._sample_bank(scene, t, (u[:, 0], u[:, 1]))
        out.append([got.cpu().numpy()] + [c.cpu().numpy() for c in lookup])
    for a, b in zip(*out):
        np.testing.assert_array_equal(b, a)


def test_textured_render_on_card_matches_cpu(card):
    """mathall-6K (textures, every BSDF kind) through K1 on the card
    against the plain traversal on the CPU, with the rule of
    test_render_on_card_matches_cpu."""
    verts, idx = testscenes.make_hall(6_000, rich_mats=True)
    mats, texs = testscenes.mat_hall_materials()
    cam = Camera.make((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0,
                      32, 24)
    films = []
    for device in ("cpu", card):
        scene = compile_mesh(verts, idx, device, max_path_len=4,
                             emitter="inside", materials=mats,
                             tex_images=texs)
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
                                   "bvh_traverse_count": 1,
                                   "bvh_traverse_option": 0,
                                   "bvh_traverse_tile": 0,
                                   "bvh_traverse_pair": 0,
                                   "tile_v1 bvh_traverse_tile": 0,
                                   "tile_v1 bvh_traverse_pair": 0}
        for key in ("t", "u", "v", "prim_id", "geom_id"):
            assert torch.equal(k2[key], k1[key]), key
            assert torch.equal(k3[key], k1[key]), key
        for key in ("pops", "leaf_pops"):
            assert torch.equal(k3[key], p[key]), key
        np.testing.assert_array_equal(k1["prim_id"].cpu().numpy() >= 0,
                                      p["prim_id"].cpu().numpy() >= 0)


@pytest.mark.parametrize("arity,width", CASES)
def test_both_bodies_match_plain(card, arity, width):
    """K1's two bodies (the group stack and the first body) against the
    plain version bit for bit on the soups of test_kernel_matches_plain,
    closest-hit and any-hit; where K2 and K3 are built (BVH8, Tri4-24),
    K2 equal to K1 and K3's counters equal to the plain counters."""
    verts, idx = _soup(2000, seed=arity * 100 + width)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=arity,
                                      packet=width), card)
    for any_hit, tmax in ((False, 1e30), (True, 2.0)):
        rays = _rays(4096, width, card, tmax)
        ab_body.check_bodies(dev, api.components(rays), any_hit,
                             f"A{arity} M{width}")


def test_both_bodies_on_ties(card):
    """Both bodies keep the first of two coincident triangles, in one Tri
    row and in two leaves, as the plain version does."""
    assert ab_body.check_ties(card) == {"row": 177, "leaves": 177}


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
    adds each pixel's samples in sample order, and K2's hits are K1's, so
    the two films are equal bit for bit; against
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


@pytest.mark.parametrize("width", [8, 24])
def test_option_kernels_match_plain(card, width):
    """K4, every option, against its plain version on the same card: per
    ray, pops, leaf pops, prim_id and geom_id equal, t/u/v within atol
    1e-5 / rtol 1e-6 (as K1's test), closest-hit and any-hit, on BVH8
    soups whose leaves span up to several Tri rows; noleaftest leaves every
    ray missing; row_loads returns K3's outputs bit for bit; one launch per
    call."""
    verts, idx = _soup(3000, seed=70 + width)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=width,
                                      leaf_threshold=32, leaf_cost=0.2),
                            card)
    for any_hit, tmax in ((False, 1e30), (True, 2.0)):
        rays = _rays(8192, width + 3, card, tmax)
        k3 = packet.traverse_packet(dev, rays, any_hit=any_hit,
                                    count_pops=True)
        for name, kw in packet.OPTION_ARGS.items():
            if any_hit and name == "nosort":
                continue
            packet.reset_launches()
            k = packet.traverse_packet(dev, rays, any_hit=any_hit,
                                       count_pops=True, **kw)
            assert packet.launches["bvh_traverse_option"] == 1
            plain = {a: b for a, b in kw.items() if a != "row_loads"}
            p = api.traverse(dev, rays, any_hit=any_hit, count_pops=True,
                             **plain)
            for key in ("prim_id", "geom_id", "pops", "leaf_pops"):
                assert torch.equal(k[key], p[key]), (name, key)
            for key in ("t", "u", "v"):
                np.testing.assert_allclose(k[key].cpu().numpy(),
                                           p[key].cpu().numpy(), atol=1e-5,
                                           rtol=1e-6, err_msg=name)
            if name == "noleaftest":
                assert bool((k["prim_id"] < 0).all())
            if name == "row_loads":
                for key in k3:
                    assert torch.equal(k[key], k3[key]), key
            uncounted = packet.traverse_packet(dev, rays, any_hit=any_hit,
                                               **kw)
            assert set(uncounted) == {"t", "u", "v", "prim_id", "geom_id"}
            assert torch.equal(uncounted["prim_id"], k["prim_id"])


def test_option_refusals(card):
    """K4 exists for BVH8 with Tri8/Tri24 rows and one option at a time;
    options on CPU tensors never launch it."""
    verts, idx = _soup(500, seed=5)
    rays = _rays(256, 6, card, 1e30)
    for arity, width in ((4, 8), (8, 16)):
        dev = api.bvh_to_device(build_bvh(verts, idx, arity=arity,
                                          packet=width), card)
        with pytest.raises(ValueError, match="built for BVH8"):
            packet.traverse_packet(dev, rays, pops=2)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8), card)
    with pytest.raises(ValueError, match="one at a time"):
        packet.traverse_packet(dev, rays, leaf_chain=2, row_loads=True)
    with pytest.raises(ValueError, match="prefetch"):
        packet.traverse_packet(dev, rays, prefetch=True, row_loads=True)
    cpu = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8), "cpu")
    packet.reset_launches()
    for kw in packet.OPTION_ARGS.values():
        packet.traverse_packet(cpu, _rays(256, 6, "cpu", 1e30), **kw)
    assert set(packet.launches.values()) == {0}


def _coherent(n, seed, device, tmax):
    """Rays from near one point with directions in one octant: their tiles
    are octant pure, where K5 takes the pure slab test or the frustum."""
    r = np.random.RandomState(seed)
    org = (np.array([[-1.0, -1.0, -9.0]], np.float32)
           + r.randn(n, 3).astype(np.float32) * 0.05)
    d = np.stack([r.uniform(0.01, 0.2, n), r.uniform(0.01, 0.2, n),
                  np.ones(n)], 1).astype(np.float32)
    tm = np.full(n, tmax, np.float32)
    tm[64:96] = -1.0
    return api.make_rays(org, d, 0.0, tm, device=device)


def _equal(k, p, what):
    for key in p:
        assert torch.equal(k[key], p[key]), (what, key)


def _tile_kw(mode):
    return {"frustum": mode == "frustum",
            "ablate": ("nopure",) if mode == "nopure" else ()}


def _tile_launch(schedule, dev, rays, kernel, any_hit, size, mode="plain",
                 ablate=()):
    """K5 or K6 in `schedule` with its counters: the wrapped schedule
    through the wrappers, the other through ab_tile_body.launch; one
    launch each, counted under its library's key."""
    if schedule != ab_tile_body.WRAPPED:
        packet.reset_launches()
        out = ab_tile_body.launch(dev, api.components(rays), kernel,
                                  schedule, any_hit, size, mode, ablate)
        assert ab_tile_body.launch_count(schedule, kernel) == 1
        assert sum(packet.launches.values()) == 1
        return out
    packet.reset_launches()
    if kernel == "K5":
        out = packet.traverse_packet(dev, rays, any_hit=any_hit,
                                     count_pops=True, tile_rows=size,
                                     **_tile_kw(mode))
        assert packet.launches["bvh_traverse_tile"] == 1
    else:
        out = pair.traverse_pair(dev, rays, any_hit=any_hit, tile_rays=size,
                                 ablate=ablate, count_pops=True)
        assert packet.launches["bvh_traverse_pair"] == 1
    return out


@pytest.mark.parametrize("schedule", ab_tile_body.SCHEDULES)
@pytest.mark.parametrize("width", [8, 24])
def test_tile_kernel_matches_plain(card, width, schedule):
    """K5 in each schedule against its plain version on the card, bit for
    bit: hits and per-tile pops and leaf pops, modes plain, frustum and
    nopure, closest-hit and any-hit, tile_rows 1, 2, 16 and 32, on coherent
    (octant pure) and random rays whose count fills no whole number of
    tiles; its closest hits equal K1's; one launch per call."""
    verts, idx = _soup(3000, seed=90 + width)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=width,
                                      leaf_threshold=32, leaf_cost=0.2),
                            card)
    for any_hit, tmax in ((False, 1e30), (True, 2.0)):
        for rays in (_coherent(5000, width, card, tmax),
                     _rays(5000, width + 1, card, tmax)):
            k1 = packet.traverse_packet(dev, rays, any_hit=any_hit)
            for rows in (1, 2, 16, 32):
                for mode in packet.TILE_MODES:
                    k = _tile_launch(schedule, dev, rays, "K5", any_hit,
                                     rows, mode)
                    p = api.traverse(dev, rays, any_hit=any_hit,
                                     count_pops=True, tile_rows=rows,
                                     **_tile_kw(mode))
                    _equal(k, p, (rows, mode, any_hit))
                    assert k["pops"].shape == (-(-5000 // (128 * rows)),)
                    if any_hit:
                        assert torch.equal(k["prim_id"] >= 0,
                                           k1["prim_id"] >= 0)
                    else:
                        assert torch.equal(k["prim_id"], k1["prim_id"])


@pytest.mark.parametrize("schedule", ab_tile_body.SCHEDULES)
def test_pair_kernel_matches_plain(card, schedule):
    """K6 in each schedule against its plain version on the card, bit for
    bit: hits and per-tile pops and leaf pops, tiles of 128, 256, 1024 and
    2048 rays, each ablation, closest-hit and any-hit; its closest hits
    equal K1's."""
    verts, idx = _soup(3000, seed=97)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8,
                                      leaf_threshold=32, leaf_cost=0.2),
                            card)
    for any_hit, tmax in ((False, 1e30), (True, 2.0)):
        rays = _rays(5000, 98, card, tmax)
        k1 = packet.traverse_packet(dev, rays, any_hit=any_hit)
        for tile in (128, 256, 1024, 2048):
            for ab in ((), *((a,) for a in pair.ABLATIONS)):
                k = _tile_launch(schedule, dev, rays, "K6", any_hit, tile,
                                 ablate=ab)
                p = pair.traverse_pair_components(
                    dev, *api.components(rays)[:3], rays["tmin"],
                    rays["tmax"], any_hit, tile, ab, count_pops=True)
                _equal(k, p, (tile, ab, any_hit))
                if ab:
                    continue
                if any_hit:
                    assert torch.equal(k["prim_id"] >= 0, k1["prim_id"] >= 0)
                else:
                    assert torch.equal(k["prim_id"], k1["prim_id"])


@pytest.mark.parametrize("schedule", ab_tile_body.SCHEDULES)
def test_tile_and_pair_refusals(card, schedule):
    """K5 is built for BVH8 with Tri8/Tri24 rows, K6 for BVH8 with Tri8, in
    either schedule."""
    verts, idx = _soup(500, seed=11)
    rays = _rays(256, 12, card, 1e30)
    comps = api.components(rays)
    dev4 = api.bvh_to_device(build_bvh(verts, idx, arity=4, packet=8), card)
    dev16 = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=16),
                              card)
    if schedule == ab_tile_body.WRAPPED:
        with pytest.raises(ValueError, match="built for BVH8"):
            packet.traverse_packet(dev4, rays, tile_rows=2)
        with pytest.raises(ValueError, match="built for BVH8"):
            packet.traverse_packet(dev16, rays, tile_rows=2)
        with pytest.raises(ValueError, match="Tri8 rows only"):
            pair.traverse_pair(dev16, rays)
    for dev in (dev4, dev16):
        with pytest.raises(ValueError, match="built for BVH8"):
            ab_tile_body.launch(dev, comps, "K5", schedule, size=2)
    with pytest.raises(ValueError, match="Tri8 rows only"):
        ab_tile_body.launch(dev16, comps, "K6", schedule, size=256)


@pytest.mark.parametrize("kernel,size", [("K5", 1), ("K5", 16),
                                         ("K6", 256), ("K6", 2048)])
def test_tile_stops_agree(card, kernel, size):
    """A stack (K5) or a guard (K6) too small for some tiles: both schedules
    stop the same tiles with pops -1 and agree in every output; the other
    tiles keep the plain version's pops."""
    verts, idx = _soup(3000, seed=91)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8,
                                      leaf_threshold=32, leaf_cost=0.2),
                            card)
    for any_hit, tmax in ((False, 1e30), (True, 2.0)):
        comps = api.components(_rays(5000, 92, card, tmax))
        assert ab_tile_body.check_stops(dev, comps, any_hit, kernel,
                                        size) > 0


def test_tile_frustum_rows32_deep_stack(card):
    """At tile_rows 32 in frustum mode the warp schedule launches on a
    stack of TILE_FRUSTUM_R32_STACK_MAX entries, equal to the first
    schedule and the plain version, and refuses one more by name; the
    first schedule launches on the largest stack."""
    verts, idx = _soup(3000, seed=93)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8,
                                      leaf_threshold=32, leaf_cost=0.2),
                            card)
    rays = _coherent(5000, 8, card, 1e30)
    comps = api.components(rays)
    cap = packet.TILE_FRUSTUM_R32_STACK_MAX
    p = api.traverse(dev, rays, count_pops=True, tile_rows=32, frustum=True)
    for schedule, stack in (("warp", cap), ("v1", cap),
                            ("v1", packet.TILE_STACK_MAX)):
        k = ab_tile_body.launch(dev, comps, "K5", schedule, False, 32,
                                "frustum", stack_cap=stack)
        _equal(k, p, (schedule, stack))
    with pytest.raises(ValueError, match="frustum mode at tile_rows 32"):
        ab_tile_body.launch(dev, comps, "K5", "warp", False, 32, "frustum",
                            stack_cap=cap + 1)


def test_tile_resources(card):
    """Both schedules' resource queries for the headline instances: a block
    of 512 threads fits on an SM, and the warp schedule keeps its rays out
    of shared memory up to 2,048 rays a tile."""
    for kernel, size in (("K5", 16), ("K6", 2048)):
        for schedule in ab_tile_body.SCHEDULES:
            r = ab_tile_body.resources(kernel, schedule, 8, False, size,
                                       "plain", 32)
            assert r["threads"] == 512 and r["blocks"] >= 1, r
        warp = ab_tile_body.resources(kernel, "warp", 8, False, size,
                                      "plain", 32)
        assert warp["smem_dynamic"] < 13 * 2048 * 4, warp


PROBES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    probe_mosaic, probe_mosaic2, probe_gather, probe_mosaic3, probe_chain,
    probe_body, probe_dyn_cost, vpu_dtype_bench)}


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_kernels_match_plain(card, name):
    """Every body of the probe through its kernel, as its main() drives it
    (the timed ones at one copy and at the copies that fill the card),
    equal bit for bit to its plain version on the card, every copy."""
    m = PROBES[name]
    m.launches = 0
    res = m.measure(card, blocks=1)
    torch.cuda.synchronize()
    assert m.launches >= len(res)
    ok = m.check(res)
    assert all(ok.values()), [k for k, v in ok.items() if not v]


def test_vpu_sass_counts(card):
    """The SASS of the vpu kernels holds a loop, and float32's body is the
    probe's 4 operations per value and iteration."""
    from rodent_tpu_torch.kernels.build import load_library
    load_library(kind="probes")
    counts = vpu_dtype_bench.sass_counts()
    assert set(counts) == set(vpu_dtype_bench.DTYPES)
    assert counts["float32"][0] == 4, counts["float32"]


def test_probe_refusals(card):
    x = probe_mosaic.inputs(card)
    with pytest.raises(ValueError):
        probe_mosaic.run("dot", x[:8].contiguous())
    with pytest.raises(ValueError):
        probe_mosaic2.run("dot_in_loop", x.double())
    tbl, idx = (torch.from_numpy(a).to(card)
                for a in probe_gather.timed_inputs("pages4"))
    with pytest.raises(ValueError, match="shared memory"):
        probe_gather.run("pages4", tbl, idx, shared=True)
    out = torch.empty(1, 8, 128, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        common.probe_call("rt_probe_gather", 3, tbl.data_ptr(),
                          idx.data_ptr(), out.data_ptr(), 8, 1, 4, 1, 1)
    with pytest.raises(ValueError):
        probe_body.run(("push8", "sort"), probe_body.inputs(card))
    with pytest.raises(ValueError):
        probe_chain.run("chase", 3, probe_chain.inputs(card))
    with pytest.raises(ValueError):
        vpu_dtype_bench.run("float32", vpu_dtype_bench.inputs("float32", 1,
                                                              card))
