"""The tile route of the port (api.traverse_tile_components, the plain
version of K5) against the legacy Pallas body _kernel with its own tile
stack, run in interpret mode with count_pops=True.

_kernel walks a tile of tile_rows * 128 rays with one shared stack
(pallas_packet.py:1-24). Both sides get the same rays, padded to whole
tiles as pack_rays pads them; per tile, pops and leaf pops (rows 0 and 1 of
each tile's 8-row block, :870-875) are held equal, exactly; prim_id
exactly, t/u/v within atol 1e-5 / rtol 1e-6, any-hit hit/miss exactly.
The soup is BVH8/Tri8 with leaves of several Tri rows. The coherent batch
(directions in one octant) makes octant-pure tiles, where the pure slab
test and the frustum test act; the random batch makes mixed tiles. 300
rays fill no whole number of tiles.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rodent_tpu.accel import build_bvh
from rodent_tpu.traversal import api as japi
from rodent_tpu.traversal.pallas_packet import _call_kernel, pack_rays
from rodent_tpu_torch.traversal import api as tapi
from rodent_tpu_torch.traversal import packet as tpacket
from test_traversal import random_tri_soup

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)

RAYS = 300
MODES = {"plain": {}, "frustum": {"frustum": True},
         "nopure": {"ablate": ("nopure",)}}
CASES = ([("coherent", rows, mode, ah) for rows in (1, 2) for mode in MODES
          for ah in (False, True)]
         + [("random", rows, mode, ah) for rows, mode in
            ((1, "plain"), (2, "frustum"), (2, "nopure"))
            for ah in (False, True)])


@pytest.fixture(scope="module")
def scene():
    verts, idx = random_tri_soup(1000, seed=47)
    bvh = build_bvh(verts, idx, arity=8, packet=8, leaf_threshold=32,
                    leaf_cost=0.2)
    rows = np.diff(np.concatenate([[-1], np.nonzero(
        bvh.prim_id[:, -1] < 0)[0]]))
    assert rows.max() > 1          # leaves of several Tri rows
    return japi.bvh_to_device(bvh), tapi.bvh_to_device(bvh, "cpu")


def _batch(kind):
    r = np.random.RandomState(5 if kind == "coherent" else 6)
    if kind == "coherent":
        org = (np.array([[-1.0, -1.0, -9.0]], np.float32)
               + r.randn(RAYS, 3).astype(np.float32) * 0.05)
        d = np.stack([r.uniform(0.01, 0.2, RAYS), r.uniform(0.01, 0.2, RAYS),
                      np.ones(RAYS)], 1).astype(np.float32)
    else:
        org = r.randn(RAYS, 3).astype(np.float32) * 3.0
        d = r.randn(RAYS, 3).astype(np.float32)
        d[:4, 0] = 0.0             # axis-parallel rays
    return org, d


def _tmax(any_hit):
    tmax = np.full(RAYS, 20.0 if any_hit else 1e30, np.float32)
    tmax[40:44] = -1.0             # dead rays
    return tmax


@pytest.mark.parametrize("kind,rows,mode,any_hit", CASES)
def test_tile_route_matches_the_legacy_body(scene, kind, rows, mode,
                                            any_hit):
    jdev, tdev = scene
    org, d = _batch(kind)
    tmax = _tmax(any_hit)
    kw = MODES[mode]
    jr = japi.make_rays(jnp.asarray(org), jnp.asarray(d),
                        jnp.zeros(RAYS, jnp.float32), jnp.asarray(tmax))
    packed, nt = pack_rays(jr, rows, 1)
    outs = _call_kernel(jdev, packed, nt, rows, any_hit, True,
                        count_pops=True, multi=1, **kw)
    cnt = np.asarray(outs[5]).reshape(nt, 8, 128)
    want = {k: np.asarray(o).reshape(-1)[:RAYS] for k, o in
            zip(("t", "u", "v", "prim_id", "geom_id"), outs[:5])}
    rays = tapi.make_rays(org, d, 0.0, tmax)
    got = {k: v.numpy() for k, v in tapi.traverse(
        tdev, rays, any_hit=any_hit, count_pops=True, tile_rows=rows,
        **kw).items()}
    np.testing.assert_array_equal(got["pops"], cnt[:, 0, 0])
    np.testing.assert_array_equal(got["leaf_pops"], cnt[:, 1, 0])
    hit = want["prim_id"] >= 0
    assert 0 < hit.mean() < 1
    if any_hit:
        np.testing.assert_array_equal(got["prim_id"] >= 0, hit)
        return
    np.testing.assert_array_equal(got["prim_id"], want["prim_id"])
    np.testing.assert_array_equal(got["geom_id"][hit], want["geom_id"][hit])
    for key in ("t", "u", "v"):
        np.testing.assert_allclose(got[key][hit], want[key][hit], atol=1e-5,
                                   rtol=1e-6)
    np.testing.assert_array_equal(got["t"][~hit], tmax[~hit])


def test_frustum_acts_on_pure_tiles(scene):
    """The coherent batch makes octant-pure tiles (the random one none), and
    there the frustum test pushes a superset: more pops, the same hits. The
    per-ray route stays the oracle of the hits."""
    _, tdev = scene
    for kind, pure in (("coherent", True), ("random", False)):
        org, d = _batch(kind)
        rays = tapi.make_rays(org, d, 0.0, _tmax(False))
        comps = tapi.components(rays)
        assert bool(tapi.tile_purity(comps[2], 2).all()) == pure
        assert bool(tapi.tile_purity(comps[2], 2).any()) == pure
        base = tapi.traverse(tdev, rays, count_pops=True, tile_rows=2)
        fr = tapi.traverse(tdev, rays, count_pops=True, tile_rows=2,
                           frustum=True)
        per_ray = tapi.traverse(tdev, rays)
        assert torch.equal(base["prim_id"], per_ray["prim_id"])
        assert torch.equal(fr["prim_id"], base["prim_id"])
        if pure:
            assert (fr["pops"] >= base["pops"]).all()
            assert fr["pops"].sum() > base["pops"].sum()
        else:
            assert torch.equal(fr["pops"], base["pops"])


def test_tile_route_through_the_wrapper_on_cpu(scene):
    """traverse_packet with tile_rows on CPU tensors is the plain tile
    version, launches nothing, and returns the per-tile counters only with
    count_pops=True."""
    _, tdev = scene
    org, d = _batch("coherent")
    rays = tapi.make_rays(org, d, 0.0, _tmax(False))
    tpacket.reset_launches()
    got = tpacket.traverse_packet(tdev, rays, tile_rows=2, frustum=True,
                                  count_pops=True)
    want = tapi.traverse(tdev, rays, tile_rows=2, frustum=True,
                         count_pops=True)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert got["pops"].shape == (2,)
    plain = tpacket.traverse_packet(tdev, rays, tile_rows=2)
    assert set(plain) == {"t", "u", "v", "prim_id", "geom_id"}
    assert set(tpacket.launches.values()) == {0}


def test_tile_route_refusals(scene):
    """The tile route takes frustum or "nopure", one at a time, and none of
    the per-ray options; the per-ray route refuses both and names
    tile_rows."""
    _, tdev = scene
    org, d = _batch("random")
    rays = tapi.make_rays(org, d, 0.0, 1e30)
    for call in (tapi.traverse, tpacket.traverse_packet):
        with pytest.raises(ValueError, match="one of"):
            call(tdev, rays, tile_rows=3)
        with pytest.raises(ValueError, match="one at a time|ask for one"):
            call(tdev, rays, tile_rows=2, frustum=True, ablate=("nopure",))
        with pytest.raises(ValueError, match="takes"):
            call(tdev, rays, tile_rows=2, ablate=("nosort",))
        with pytest.raises(ValueError, match="per-ray route"):
            call(tdev, rays, tile_rows=2, pops=2)
    with pytest.raises(ValueError, match="prefetch"):
        tpacket.traverse_packet(tdev, rays, tile_rows=2, prefetch=True)
