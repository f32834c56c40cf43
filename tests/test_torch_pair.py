"""The pair-layout traversal of the port (traversal/pair.py, the plain
version of K6) against experiments/pallas_pair.py in interpret mode, and
the port of that experiment's own checks (experiments/test_pair.py).

pallas_pair counts pops per grid step, whose `streams` tiles interleave
in one loop; the port counts per tile, so the sum over each `streams`
consecutive tiles must equal the step's count, exactly. Hits: prim_id and
geom_id exactly, t/u/v within atol 1e-5 / rtol 1e-6, any-hit hit/miss
exactly.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from experiments.pallas_pair import pair_device, traverse_pair as jpair
from rodent_tpu.accel import build_bvh
from rodent_tpu.traversal import api as japi
from rodent_tpu_torch.traversal import api as tapi
from rodent_tpu_torch.traversal import packet as tpacket
from rodent_tpu_torch.traversal import pair as tpair
from test_traversal import random_tri_soup

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)

RAYS = 512


def _rays(n, seed, tmax):
    """experiments/test_pair.py:36-41"""
    r = np.random.RandomState(seed)
    return (r.randn(n, 3).astype(np.float32) * 3.0,
            r.randn(n, 3).astype(np.float32), np.float32(tmax))


def _both(org, d, tmax):
    n = org.shape[0]
    jr = japi.make_rays(jnp.asarray(org), jnp.asarray(d),
                        jnp.zeros(n, jnp.float32), jnp.full(n, tmax))
    return jr, tapi.make_rays(org, d, 0.0, tmax)


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_hits(got, want, any_hit=False):
    hit = want["prim_id"] >= 0
    if any_hit:
        np.testing.assert_array_equal(got["prim_id"] >= 0, hit)
        return
    np.testing.assert_array_equal(got["prim_id"], want["prim_id"])
    np.testing.assert_array_equal(got["geom_id"], want["geom_id"])
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-6)


@pytest.fixture(scope="module")
def soup():
    """experiments/test_pair.py:48-50, with leaves of several Tri rows."""
    verts, idx = random_tri_soup(300, seed=47)
    bvh = build_bvh(verts, idx, arity=8, packet=8, leaf_threshold=32,
                    leaf_cost=0.2)
    return pair_device(bvh), tapi.bvh_to_device(bvh, "cpu")


def test_pair_matches_api():
    """experiments/test_pair.py:44-67: 300 rays (no whole number of tiles
    of 256) through the port's pair traversal equal the per-ray traversal of
    the JAX package, closest-hit and any-hit."""
    verts, idx = random_tri_soup(257, seed=47)
    bvh = build_bvh(verts, idx, arity=8, packet=8)
    tdev = tapi.bvh_to_device(bvh, "cpu")
    jdev = japi.bvh_to_device(bvh)
    org, d, tmax = _rays(300, 49, 1e30)
    jr, tr = _both(org, d, tmax)
    want = _np(japi.traverse(jdev, jr))
    got = _np(tpair.traverse_pair(tdev, tr, tile_rays=256))
    np.testing.assert_array_equal(got["prim_id"], want["prim_id"])
    np.testing.assert_array_equal(got["geom_id"], want["geom_id"])
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-5, rtol=1e-6)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5)
    org, d, tmax = _rays(256, 51, 2.0)
    jr, tr = _both(org, d, tmax)
    wa = np.asarray(japi.traverse(jdev, jr, any_hit=True)["prim_id"]) >= 0
    ga = tpair.traverse_pair(tdev, tr, any_hit=True, tile_rays=256)
    assert 0 < wa.mean() < 1
    np.testing.assert_array_equal(ga["prim_id"].numpy() >= 0, wa)


def test_pair_deep_tree():
    """experiments/test_pair.py:70-91: a clustered soup makes deep subtrees
    and leaves of several Tri rows; the stack holds one entry per pending
    node and leaves continue row by row."""
    r = np.random.RandomState(83)
    base = np.repeat(r.randn(40, 3) * 5.0, 20, axis=0).astype(np.float32)
    verts = np.concatenate([
        base, base + r.randn(800, 3).astype(np.float32) * 0.02,
        base + r.randn(800, 3).astype(np.float32) * 0.02])
    idx = np.stack([np.arange(800), np.arange(800) + 800,
                    np.arange(800) + 1600,
                    np.zeros(800)], 1).astype(np.int32).reshape(-1)
    bvh = build_bvh(verts, idx, arity=8, packet=8)
    assert (np.diff(np.nonzero(bvh.prim_id[:, -1] < 0)[0]) > 1).any()
    tdev = tapi.bvh_to_device(bvh, "cpu")
    org, d, tmax = _rays(512, 85, 1e30)
    jr, tr = _both(org, d, tmax)
    want = _np(japi.traverse(japi.bvh_to_device(bvh), jr))
    got = _np(tpair.traverse_pair(tdev, tr, tile_rays=512, count_pops=True))
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(got["prim_id"], want["prim_id"])


@pytest.mark.parametrize("streams,any_hit,ablate", [
    (1, False, ()), (2, False, ()), (2, True, ()),
    (1, False, ("nosort",)), (1, False, ("nostrip",)),
    (2, True, ("nonode",)), (1, False, ("noleaf",))])
def test_pops_per_step_match_pallas_pair(soup, streams, any_hit, ablate):
    """Per-tile pops summed over each `streams` consecutive tiles of 128
    rays equal pallas_pair's per-step count; the hits equal its hits, for
    every ablation with a counterpart."""
    jdev, tdev = soup
    org, d, tmax = _rays(RAYS, 5, 2.0 if any_hit else 1e30)
    jr, tr = _both(org, d, tmax)
    want = _np(jpair(jdev, jr, any_hit=any_hit, tile_rays=128,
                     streams=streams, count_pops=True, ablate=ablate))
    got = _np(tpair.traverse_pair(tdev, tr, any_hit=any_hit, tile_rays=128,
                                  ablate=ablate, count_pops=True))
    np.testing.assert_array_equal(got["pops"].reshape(-1, streams).sum(1),
                                  want["pops"])
    assert (got["leaf_pops"] <= got["pops"]).all()
    _assert_hits(got, want, any_hit)
    if ablate == ("nonode",):
        assert (got["pops"] == 1).all() and (got["prim_id"] < 0).all()
    if ablate == ("noleaf",):
        assert (got["prim_id"] < 0).all()
        assert got["leaf_pops"].sum() > 0


def test_pair_refusals(soup):
    """BVH8 with Tri8 rows only; the TPU matrix unit's ablations raise;
    CPU tensors never launch K6."""
    _, tdev = soup
    org, d, tmax = _rays(64, 7, 1e30)
    rays = tapi.make_rays(org, d, 0.0, tmax)
    for ab in ("nomatmul", "fastmatmul"):
        with pytest.raises(ValueError, match="matrix unit"):
            tpair.traverse_pair(tdev, rays, ablate=(ab,))
    with pytest.raises(ValueError, match="unknown ablation"):
        tpair.traverse_pair(tdev, rays, ablate=("nopure",))
    with pytest.raises(ValueError, match="tile_rays"):
        tpair.traverse_pair(tdev, rays, tile_rays=300)
    verts, idx = random_tri_soup(200, seed=3)
    for arity, width in ((8, 4), (4, 8)):
        other = tapi.bvh_to_device(build_bvh(verts, idx, arity=arity,
                                             packet=width), "cpu")
        with pytest.raises(ValueError, match="Tri8 rows only"):
            tpair.traverse_pair(other, rays)
    tpacket.reset_launches()
    tpair.traverse_pair(tdev, rays, tile_rays=128)
    assert set(tpacket.launches.values()) == {0}


@pytest.mark.parametrize("ablate", [(), ("nostrip",), ("nosort",)])
def test_ab_tile_body_pair_on_cpu(soup, ablate):
    """ab_tile_body.launch of K6 on CPU tensors is the plain pair version,
    counters included; it refuses the matrix unit's
    ablations as the wrapper does, and launches nothing."""
    from rodent_tpu_torch.experiments import ab_tile_body
    _, tdev = soup
    org, d, tmax = _rays(300, 9, 2.0)
    rays = tapi.make_rays(org, d, 0.0, tmax)
    comps = tapi.components(rays)
    tpacket.reset_launches()
    got = ab_tile_body.launch(tdev, comps, "K6", True, 256,
                              ablate=ablate)
    want = tpair.traverse_pair(tdev, rays, any_hit=True, tile_rays=256,
                               ablate=ablate, count_pops=True)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    with pytest.raises(ValueError, match="matrix unit"):
        ab_tile_body.launch(tdev, comps, "K6", size=256,
                            ablate=("nomatmul",))
    assert set(tpacket.launches.values()) == {0}
