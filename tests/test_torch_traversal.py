"""rodent_tpu_torch.traversal against rodent_tpu.traversal on the CPU.

The port's traverse_packet runs its plain torch version here (the CUDA
kernel K1 needs a card; test_torch_cuda.py compares the two on one).
It is held against the JAX package's Pallas traversal, run in interpret
mode with tile_rows=4, and against api.traverse, on random triangle soups
for arity 2/4/8 and Tri4/8/16/24 packets: prim_id exact, t within atol
1e-5 and rtol 1e-6, any-hit hit/miss exact (tests/test_traversal.py
pattern). Device tables and sort keys are held byte for byte. The per-ray
pop counters (the plain version of K3) are held against the legacy Pallas
body's per-tile counters.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodent_tpu.accel import build_bvh
from rodent_tpu.traversal import api as japi
from rodent_tpu.traversal import sorting as jsort
from rodent_tpu.traversal.pallas_packet import (_call_kernel, pack_rays,
                                                traverse_packet as jpacket)
from rodent_tpu.utils import testscenes
from rodent_tpu_torch.traversal import api as tapi
from rodent_tpu_torch.traversal import packet as tpacket
from rodent_tpu_torch.traversal import sorting as tsort
from test_traversal import random_tri_soup

CASES = [(a, m) for a in (2, 4, 8) for m in (4, 8, 16, 24)]

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)


def random_rays(n, seed, tmax):
    r = np.random.RandomState(seed)
    org = r.randn(n, 3).astype(np.float32) * 3.0
    d = r.randn(n, 3).astype(np.float32)
    d[:8, 0] = 0.0                      # axis-parallel rays
    d[8:16, 1:] = 0.0
    return org, d, np.full(n, tmax, np.float32)


def _both(arity, packet):
    verts, idx = random_tri_soup(257, seed=47)
    bvh = build_bvh(verts, idx, arity=arity, packet=packet)
    return bvh, japi.bvh_to_device(bvh), tapi.bvh_to_device(bvh, "cpu")


def _np(hit):
    return {k: np.asarray(v) for k, v in hit.items()}


@pytest.mark.parametrize("arity,packet", CASES)
def test_bvh_to_device_byte_identical(arity, packet):
    bvh, jdev, tdev = _both(arity, packet)
    for key in ("nodes", "tris"):
        a, b = np.asarray(jdev[key]), tdev[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert (tdev["meta"].shared_stack, tdev["meta"].node_stack) == (
        jdev["meta"].shared_stack, jdev["meta"].node_stack)
    assert tapi.compute_stack_needs(bvh.child) == \
        japi.compute_stack_needs(bvh.child)


@pytest.mark.parametrize("arity,packet", CASES)
def test_traverse_packet_matches_jax(arity, packet):
    _, jdev, tdev = _both(arity, packet)
    org, d, tmax = random_rays(300, seed=49, tmax=1e30)
    jr = japi.make_rays(org, d, np.zeros(300, np.float32), tmax)
    want_api = _np(japi.traverse(jdev, jr))
    want_pk = _np(jpacket(jdev, jr, tile_rows=4, interpret=True))
    tpacket.reset_launches()
    got = _np(tpacket.traverse_packet(tdev, tapi.make_rays(org, d, 0.0,
                                                           tmax)))
    assert tpacket.launches["bvh_traverse"] == 0   # CPU: plain version
    for want in (want_api, want_pk):
        np.testing.assert_array_equal(got["prim_id"], want["prim_id"])
        np.testing.assert_array_equal(got["geom_id"], want["geom_id"])
        for key in ("t", "u", "v"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                       rtol=1e-6)
    assert (got["prim_id"] >= 0).mean() > 0.1

    org, d, tmax = random_rays(256, seed=51, tmax=2.0)
    got = tpacket.traverse_packet(tdev, tapi.make_rays(org, d, 0.0, tmax),
                                  any_hit=True)["prim_id"].numpy() >= 0
    jr = japi.make_rays(org, d, np.zeros(256, np.float32), tmax)
    want = np.asarray(japi.traverse(jdev, jr, any_hit=True)["prim_id"])
    np.testing.assert_array_equal(got, want >= 0)
    if arity == 8:   # the interpreted kernel is slow: one arity suffices
        np.testing.assert_array_equal(got, np.asarray(jpacket(
            jdev, jr, any_hit=True, tile_rows=4,
            interpret=True)["prim_id"]) >= 0)
    assert 0 < got.mean() < 1


def test_dead_rays_and_bruteforce():
    _, jdev, tdev = _both(4, 8)
    org, d, tmax = random_rays(200, seed=53, tmax=1e30)
    tmax[::3] = -1.0                    # tmax < tmin: dead
    got = tpacket.traverse_packet(tdev, tapi.make_rays(org, d, 0.0, tmax))
    dead = tmax < 0
    assert (got["prim_id"].numpy()[dead] == -1).all()
    np.testing.assert_array_equal(got["t"].numpy()[dead], tmax[dead])
    rays = tapi.make_rays(org, d, 0.0, 1e30)
    bf = _np(tapi.intersect_bruteforce(tdev, rays))
    want = _np(japi.intersect_bruteforce(
        jdev, japi.make_rays(org, d, np.zeros(200, np.float32),
                             np.full(200, 1e30, np.float32))))
    np.testing.assert_array_equal(bf["prim_id"], want["prim_id"])
    np.testing.assert_allclose(bf["t"], want["t"], atol=1e-5, rtol=1e-6)
    hit = _np(tapi.traverse(tdev, rays))
    np.testing.assert_array_equal(hit["prim_id"], bf["prim_id"])
    np.testing.assert_array_equal(tapi.occluded(tdev, rays).numpy(),
                                  bf["prim_id"] >= 0)


def test_stack_cap_refuses_deep_trees():
    _, _, tdev = _both(8, 8)
    assert tpacket.stack_cap(tdev) == 64
    deep = dict(tdev, meta=tapi.BvhMeta(shared_stack=127, node_stack=1))
    with pytest.raises(ValueError, match="stack"):
        tpacket.stack_cap(deep)


def test_sort_keys_bit_exact():
    """Keys and the stable permutation equal the JAX package's bit for bit
    when the port's key is given the JAX package's own 1/|d|
    (jax.lax.rsqrt of the same float32 sum): all of the key's arithmetic
    is held on every host. rsqrt itself is an approximation whose last
    bits depend on the code and the host CPU (XLA's, torch's, CUDA's
    rsqrtf), so with the port's own torch.rsqrt a key may differ, but only
    in its 20 direction bits and only on a ray whose 1/|d| differs. Hall
    primaries and 70,000 random rays, axis-parallel and zero directions
    included."""
    verts, _ = testscenes.make_hall(20_000)
    lo, hi = verts.min(0), verts.max(0)
    org, d = testscenes.hall_primary_rays(256, 256)
    r = np.random.RandomState(3)
    org2 = (r.rand(70_000, 3) * (hi - lo) + lo).astype(np.float32)
    d2 = r.randn(70_000, 3).astype(np.float32)
    d2[:100, 0] = 0.0
    d2[100:200, 1] = 0.0
    d2[200:300] = 0.0
    for o, dd in ((org, d), (org2, d2)):
        want = np.asarray(jsort.ray_sort_keys(
            jnp.asarray(o), jnp.asarray(dd), lo, hi)).astype(np.int64)
        # the float32 sum the JAX key takes its rsqrt of, op by op
        s = (dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1]
             + dd[:, 2] * dd[:, 2] + np.float32(1e-30))
        jinv = np.asarray(jax.lax.rsqrt(jnp.asarray(s)))
        to, td = torch.from_numpy(o), torch.from_numpy(dd)
        got = tsort.ray_sort_keys(to, td, lo, hi,
                                  inv_len=torch.from_numpy(jinv)).numpy()
        np.testing.assert_array_equal(got, want)
        _, jperm = jsort.sort_rays(japi.make_rays(o, dd, 0.0, 1e30), lo, hi)
        jperm = np.asarray(jperm)
        tperm = torch.sort(torch.from_numpy(got), stable=True).indices
        np.testing.assert_array_equal(tperm.numpy(), jperm)
        # the port's own rsqrt: only direction bits, only where 1/|d| moved
        own = tsort.ray_sort_keys(to, td, lo, hi).numpy()
        tinv = torch.rsqrt(torch.from_numpy(s)).numpy()
        moved = own != want
        assert not np.any(moved & (tinv == jinv))
        assert not np.any((own ^ want) & ~tsort.DIR_BITS)
        srt, sperm = tsort.sort_rays(tapi.make_rays(o, dd, 0.0, 1e30), lo,
                                     hi)
        np.testing.assert_array_equal(
            sperm.numpy(), torch.sort(torch.from_numpy(own),
                                      stable=True).indices.numpy())
        np.testing.assert_array_equal(srt["dir"].numpy(), dd[sperm.numpy()])


def test_pop_counters_match_the_legacy_body():
    """The port's per-ray pops / leaf_pops against the count_pops output of
    the legacy Pallas body (_kernel, interpret mode): each of 32 rays is
    replicated across all 128 lanes of a one-row tile, so the tile's shared
    stack is that ray's own stack and its per-tile counts (rows 0 and 1 of
    the tile's 8-row block) are the ray's. Closest-hit on a BVH8/Tri8 soup.
    All 32 rays agree exactly, pops and leaf pops; the hits agree too."""
    _, jdev, tdev = _both(8, 8)
    org, d, _ = random_rays(32, seed=55, tmax=1e30)
    n = 32 * 128
    jr = japi.make_rays(jnp.asarray(np.repeat(org, 128, 0)),
                        jnp.asarray(np.repeat(d, 128, 0)),
                        jnp.zeros(n, jnp.float32),
                        jnp.full(n, 1e30, jnp.float32))
    packed, nt = pack_rays(jr, 1, 1)
    outs = _call_kernel(jdev, packed, nt, 1, False, True, count_pops=True,
                        multi=1)
    cnt = np.asarray(outs[5]).reshape(nt, 8, 128)
    got = _np(tapi.traverse(tdev, tapi.make_rays(org, d, 0.0, 1e30),
                            count_pops=True))
    np.testing.assert_array_equal(got["pops"], cnt[:, 0, 0])
    np.testing.assert_array_equal(got["leaf_pops"], cnt[:, 1, 0])
    np.testing.assert_array_equal(
        got["prim_id"], np.asarray(outs[3]).reshape(nt, 128)[:, 0])
    assert got["pops"].max() > 5 and got["leaf_pops"].max() > 1


@pytest.mark.parametrize("any_hit", [False, True])
def test_pop_counter_invariants(any_hit):
    """0 <= leaf_pops <= pops, a dead ray counts 0 and a live one at least
    the root; counting changes no hit; traverse_packet on CPU tensors
    gives the same counters and launches nothing, and refuses to prefetch
    and count at once."""
    _, _, tdev = _both(8, 16)
    org, d, tmax = random_rays(400, seed=57, tmax=2.0 if any_hit else 1e30)
    tmax[::5] = -1.0
    rays = tapi.make_rays(org, d, 0.0, tmax)
    got = _np(tapi.traverse(tdev, rays, any_hit=any_hit, count_pops=True))
    plain = _np(tapi.traverse(tdev, rays, any_hit=any_hit))
    for key in plain:
        np.testing.assert_array_equal(got[key], plain[key])
    pops, leaf = got["pops"], got["leaf_pops"]
    assert pops.dtype == leaf.dtype == np.int32
    assert (leaf >= 0).all() and (leaf <= pops).all()
    dead = tmax < 0
    assert (pops[dead] == 0).all() and (pops[~dead] >= 1).all()
    assert leaf.sum() > 0
    tpacket.reset_launches()
    wrapped = _np(tpacket.traverse_packet(tdev, rays, any_hit=any_hit,
                                          count_pops=True))
    np.testing.assert_array_equal(wrapped["pops"], pops)
    np.testing.assert_array_equal(wrapped["leaf_pops"], leaf)
    assert set(tpacket.launches.values()) == {0}
    with pytest.raises(ValueError, match="prefetch and count_pops"):
        tpacket.traverse_packet(tdev, rays, prefetch=True, count_pops=True)
