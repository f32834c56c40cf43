"""Tri12 leaves, which the JAX kernels take at any Tri width (_pack_rows,
pallas_packet.py:1487-1505) and the port's kernels K1-K3 and K7 are built
for: the port's plain versions on Tri12 builds against the Pallas bodies in
interpret mode.

- Hits: the soup of tests/test_traversal.py (257 triangles, 300 rays;
  leaves of up to 32 triangles at leaf_cost 0.2, so most span two or three
  rows) and a make_hall(2_000) build (race_hall_packet's, leaf_threshold
  12), at Tri12 (build_bvh(..., packet=12)), in tiles of 4 rows: the
  legacy order (traverse_packet's default multi=2, _kernel_multi) against
  api.traverse_components, and the carry-top body (_kernel_ct, select
  fold and sort) against api.traverse_ct_components. prim_id and geom_id
  equal, t/u/v within atol 1e-5 / rtol 1e-6, any-hit hit/miss equal.
- Pops per ray: each ray replicated across the 128 lanes of a one-row tile
  (tests/test_torch_traversal.py's layout): the legacy body's count_pops
  (_kernel) and _kernel_ct's against the plain counters, closest-hit and
  any-hit.
- The port's wrappers on CPU tensors take those plain versions at Tri12
  for K1, K2 (prefetch), K3 (count_pops), K7 and K7-PF, and launch
  nothing.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rodent_tpu.accel import build_bvh
from rodent_tpu.traversal import api as japi
from rodent_tpu.traversal.pallas_packet import (_call_kernel, pack_rays,
                                                traverse_packet)
from rodent_tpu.utils import testscenes
from rodent_tpu_torch.traversal import api as tapi
from rodent_tpu_torch.traversal import packet as tpacket
from test_traversal import random_tri_soup

torch.set_num_threads(1)

FLT_MAX = np.float32(3.402823466e38)
# None: the legacy order; else the carry-top body with this select
BODIES = [None, "fold", "sort"]
BODY_IDS = ["legacy", "ct-fold", "ct-sort"]


def _scene(name):
    """(Tri12 BVH8 build, origins, directions, any-hit tmax)."""
    if name == "soup":
        verts, idx = random_tri_soup(257, seed=47)
        bvh = build_bvh(verts, idx, arity=8, packet=12, leaf_threshold=32,
                        leaf_cost=0.2)
        r = np.random.RandomState(49)
        org = r.randn(300, 3).astype(np.float32) * 3.0
        d = r.randn(300, 3).astype(np.float32)
        return bvh, org, d, np.float32(2.0)
    verts, idx = testscenes.make_hall(2_000)
    bvh = build_bvh(verts, idx, arity=8, packet=12, leaf_threshold=12)
    org, d = testscenes.hall_primary_rays(16, 16)
    return bvh, org, d, FLT_MAX


@pytest.fixture(scope="module", params=["soup", "hall"])
def scene(request):
    bvh, org, d, ah_tmax = _scene(request.param)
    assert bvh.tri_v0.shape[1] == 12
    return (request.param, japi.bvh_to_device(bvh),
            tapi.bvh_to_device(bvh, "cpu"), org, d, ah_tmax)


def _kw(select):
    return {} if select is None else {"carry_top": True, "select": select}


def test_tri12_build_spans_rows(scene):
    """The Tri12 tables: 168 floats a row; the soup's leaves span more than
    one row (a row whose last lane's pid has its sign bit clear
    continues)."""
    name, _, tdev, *_ = scene
    tris = tdev["tris"]
    assert tris.shape[1] == 14 * 12
    last = tris[:, 12 * 12 + 11].view(torch.int32)
    assert int((last >= 0).sum()) > tris.shape[0] // 2 or name == "hall"
    assert tpacket.stack_cap(tdev) in tpacket.STACK_CAPS


@pytest.mark.parametrize("select", BODIES, ids=BODY_IDS)
def test_plain_matches_pallas_at_tri12(scene, select):
    name, jdev, tdev, org, d, ah_tmax = scene
    n = len(org)
    for any_hit, tmax in ((False, FLT_MAX), (True, ah_tmax)):
        jr = japi.make_rays(jnp.asarray(org), jnp.asarray(d),
                            jnp.zeros(n, jnp.float32),
                            jnp.full(n, tmax, jnp.float32))
        want = {k: np.asarray(v) for k, v in traverse_packet(
            jdev, jr, any_hit=any_hit, tile_rows=4, interpret=True,
            **_kw(select)).items()}
        got = {k: v.numpy() for k, v in tapi.traverse(
            tdev, tapi.make_rays(org, d, 0.0, tmax), any_hit=any_hit,
            **_kw(select)).items()}
        hit = want["prim_id"] >= 0
        if any_hit:
            np.testing.assert_array_equal(got["prim_id"] >= 0, hit)
            continue
        assert 0 < hit.sum(), name
        np.testing.assert_array_equal(got["prim_id"], want["prim_id"])
        np.testing.assert_array_equal(got["geom_id"], want["geom_id"])
        for key in ("t", "u", "v"):
            np.testing.assert_allclose(got[key][hit], want[key][hit],
                                       atol=1e-5, rtol=1e-6)
        np.testing.assert_array_equal(got["t"][~hit], want["t"][~hit])


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("select", BODIES, ids=BODY_IDS)
def test_pops_per_ray_at_tri12(scene, select, any_hit):
    name, jdev, tdev, org, d, ah_tmax = scene
    org, d = org[:40], d[:40]
    tmax = np.full(len(org), ah_tmax if any_hit else FLT_MAX, np.float32)
    n = len(org) * 128
    jr = japi.make_rays(jnp.asarray(np.repeat(org, 128, 0)),
                        jnp.asarray(np.repeat(d, 128, 0)),
                        jnp.zeros(n, jnp.float32),
                        jnp.asarray(np.repeat(tmax, 128)))
    packed, nt = pack_rays(jr, 1, 1)
    outs = _call_kernel(jdev, packed, nt, 1, any_hit, True, count_pops=True,
                        multi=1, **_kw(select))
    cnt = np.asarray(outs[5]).reshape(nt, 8, 128)
    got = {k: v.numpy() for k, v in tapi.traverse(
        tdev, tapi.make_rays(org, d, 0.0, tmax), any_hit=any_hit,
        count_pops=True, **_kw(select)).items()}
    np.testing.assert_array_equal(got["pops"], cnt[:, 0, 0])
    np.testing.assert_array_equal(got["leaf_pops"], cnt[:, 1, 0])
    np.testing.assert_array_equal(
        got["prim_id"], np.asarray(outs[3]).reshape(nt, 128)[:, 0])
    assert got["pops"].mean() > 2 and got["leaf_pops"].max() >= 1, name


def test_wrappers_take_the_plain_versions_at_tri12(scene):
    """traverse_packet on CPU tensors at Tri12: K1, K2 (prefetch) and K3
    (count_pops) routes equal api.traverse_components, K7 and K7-PF routes
    api.traverse_ct_components, bit for bit; no launch is counted."""
    _, _, tdev, org, d, _ = scene
    rays = tapi.make_rays(org, d, 0.0, FLT_MAX)
    tpacket.reset_launches()
    legacy = tapi.traverse(tdev, rays, count_pops=True)
    ct = tapi.traverse(tdev, rays, count_pops=True, carry_top=True)
    for kw, want in (({}, legacy), ({"prefetch": True}, legacy),
                     ({"count_pops": True}, legacy),
                     ({"carry_top": True}, ct),
                     ({"carry_top": True, "count_pops": True}, ct),
                     ({"carry_top": True, "prefetch": True}, ct)):
        got = tpacket.traverse_packet(tdev, rays, **kw)
        for key in got:
            assert torch.equal(got[key], want[key]), (kw, key)
    assert set(tpacket.launches.values()) == {0}
