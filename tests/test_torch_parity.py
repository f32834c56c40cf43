"""The port's library surface against the JAX package's on the CPU: the
vector math of core/math.py, the hashes of core/rng.py,
core/sampling.russian_roulette, the single-ray primitives of
traversal/primitives.py, api.traverse's stack_depth, api.intersect_bruteforce's
any_hit and render/film.splat, each under its JAX name, on inputs made
from a numpy seed.

Tolerances: integers, hashes, masks and hit ids bit for bit; traversal
t/u/v within atol 1e-5 and rtol 1e-6 (tests/test_traversal.py's rule);
the vector math within rtol 1e-6 and atol 1e-6, because XLA's CPU code
may fuse a multiply and an add into one rounding inside a jitted jnp
function (jnp.cross, ROADMAP C2) where torch rounds twice; the film
within rtol 1e-6, because a scatter-add of repeated ids adds in an order
neither library fixes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodent_tpu.accel import build_bvh
from rodent_tpu.core import math as jm
from rodent_tpu.core import rng as jrng
from rodent_tpu.core import sampling as jsampling
from rodent_tpu.render import film as jfilm
from rodent_tpu.traversal import api as japi
from rodent_tpu.traversal import primitives as jprim
from rodent_tpu_torch.core import math as tm
from rodent_tpu_torch.core import rng as trng
from rodent_tpu_torch.core import sampling as tsampling
from rodent_tpu_torch.render import film as tfilm
from rodent_tpu_torch.traversal import api as tapi
from rodent_tpu_torch.traversal import primitives as tprim
from test_traversal import random_tri_soup

torch.set_num_threads(1)

N = 4096
MATH_TOL = {"rtol": 1e-6, "atol": 1e-6}
HIT_TOL = {"rtol": 1e-6, "atol": 1e-5}


def _vecs(seed, n=N, k=3):
    r = np.random.RandomState(seed)
    return [r.randn(n, 3).astype(np.float32) for _ in range(k)]


def _close(got, want, tol=MATH_TOL):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, tuple) else list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **tol)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", ["cross", "length2", "length", "reflect",
                                  "basis_mul"])
def test_vector_math_matches_jax(name):
    a, b, c = _vecs(1)
    n = a / np.linalg.norm(a, axis=1, keepdims=True)
    args = {"cross": (a, b), "length2": (a,), "length": (a,),
            "reflect": (a, n), "basis_mul": (a, b, c, n)}[name]
    _close(getattr(tm, name)(*map(_t, args)),
           getattr(jm, name)(*map(jnp.asarray, args)))


def test_lerp_matches_jax():
    """lerp with a scalar and with a per-component k; lerp2 with scalar
    weights and with per-point weights (one axis less than the points)."""
    a, b, c = _vecs(2)
    r = np.random.RandomState(3)
    k = r.rand(N, 3).astype(np.float32)
    u, v = (r.rand(N).astype(np.float32) * 0.5 for _ in range(2))
    _close(tm.lerp(_t(a), _t(b), 0.25), jm.lerp(jnp.asarray(a),
                                                jnp.asarray(b), 0.25))
    _close(tm.lerp(_t(a), _t(b), _t(k)),
           jm.lerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(k)))
    _close(tm.lerp2(_t(a), _t(b), _t(c), _t(u), _t(v)),
           jm.lerp2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                    jnp.asarray(u), jnp.asarray(v)))
    _close(tm.lerp2(_t(a), _t(b), _t(c), 0.2, 0.3),
           jm.lerp2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), 0.2,
                    0.3))


def test_orthonormal_basis_matches_jax():
    """make_orthonormal_basis on unit normals of both z signs (z = 0
    included): tangent and bitangent; the normal comes back as given."""
    (a,) = _vecs(4, k=1)
    a[:16, 2] = 0.0
    n = a / np.linalg.norm(a, axis=1, keepdims=True)
    got = tm.make_orthonormal_basis(_t(n))
    want = jm.make_orthonormal_basis(jnp.asarray(n))
    _close(got[:2], tuple(want[:2]))
    assert torch.equal(got[2], _t(n))


def test_hashes_match_jax():
    """fnv_init, bernstein_init and bernstein_hash (and fnv_hash on top of
    fnv_init) bit for bit, the uint32 arithmetic done in int64 with a mask
    (ROADMAP C1), over 4,096 random uint32 words chained four deep, int32
    words with their sign bit set among them."""
    r = np.random.RandomState(5)
    words = r.randint(0, 2 ** 32, size=(4, N), dtype=np.uint64).astype(
        np.uint32)
    assert int(trng.fnv_init()) == int(jrng.fnv_init())
    assert int(trng.bernstein_init()) == int(jrng.bernstein_init())
    for init, jhash, thash in ((jrng.bernstein_init, jrng.bernstein_hash,
                                trng.bernstein_hash),
                               (jrng.fnv_init, jrng.fnv_hash,
                                trng.fnv_hash)):
        jh = jnp.broadcast_to(init(), (N,))
        th = torch.full((N,), int(init()), dtype=torch.int64)
        for w in words:
            jh = jhash(jh, jnp.asarray(w))
            th = thash(th, torch.from_numpy(w.astype(np.int64)))
            np.testing.assert_array_equal(th.numpy(),
                                          np.asarray(jh).astype(np.int64))
    signed = words[0].view(np.int32)
    assert (signed < 0).any()
    want = jrng.bernstein_hash(jrng.bernstein_init(), jnp.asarray(signed))
    got = trng.bernstein_hash(trng.bernstein_init(),
                              torch.from_numpy(signed.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_russian_roulette_matches_jax():
    """min(2 * luminance, clamp) at the default clamp and another, on
    contributions around the clamp."""
    r = np.random.RandomState(6)
    c = (r.rand(N, 3) * 0.8).astype(np.float32)
    for clamp in (0.75, 0.5):
        got = tsampling.russian_roulette(_t(c), clamp)
        want = np.asarray(jsampling.russian_roulette(jnp.asarray(c), clamp))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == clamp).any() and (want < clamp).any()


def _tri_inputs(seed):
    r = np.random.RandomState(seed)
    org = r.randn(N, 3).astype(np.float32) * 2.0
    v0 = r.randn(N, 3).astype(np.float32)
    v1 = v0 + r.randn(N, 3).astype(np.float32)
    v2 = v0 + r.randn(N, 3).astype(np.float32)
    tgt = (v0 + v1 + v2) / 3 + r.randn(N, 3).astype(np.float32) * 0.3
    d = (tgt - org).astype(np.float32)
    e1, e2 = (v0 - v1).astype(np.float32), (v2 - v0).astype(np.float32)
    n = np.cross(e1, e2).astype(np.float32)
    d[:8, 0] = 0.0                                  # axis-parallel rays
    n[8:16] = 0.0                                   # degenerate triangles
    tmin = np.zeros(N, np.float32)
    tmax = np.where(np.arange(N) % 5 == 0, 0.5, 1e30).astype(np.float32)
    return org, d, tmin, tmax, v0, e1, e2, n


def test_intersect_ray_tri_matches_jax():
    """Moller-Trumbore on 4,096 ray/triangle pairs (about half hit, short
    rays, axis-parallel rays and degenerate triangles among them): the hit
    mask bit for bit, t/u/v within the traversal tolerance where it hits."""
    args = _tri_inputs(7)
    mask, t, u, v = tprim.intersect_ray_tri(*map(_t, args))
    jmask, jt, ju, jv = jprim.intersect_ray_tri(*map(jnp.asarray, args))
    jmask = np.asarray(jmask)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert 0.2 < jmask.mean() < 0.8
    for g, w in ((t, jt), (u, ju), (v, jv)):
        np.testing.assert_allclose(g.numpy()[jmask], np.asarray(w)[jmask],
                                   **HIT_TOL)


def _box_inputs(seed):
    r = np.random.RandomState(seed)
    org = r.randn(N, 3).astype(np.float32) * 3.0
    d = r.randn(N, 3).astype(np.float32)
    d[:8, 1] = 0.0
    inv = np.asarray(jm.safe_rcp(jnp.asarray(d)))
    with np.errstate(over="ignore"):   # inv_org of an axis-parallel ray
        return org, d, inv, (-(org * inv)).astype(np.float32)


def test_intersect_ray_box_matches_jax():
    """The slab test on 4,096 rays against one box each (axis-parallel
    rays included): entry and exit within the traversal tolerance, the hit
    test entry <= exit bit for bit."""
    org, d, inv, iox = _box_inputs(8)
    r = np.random.RandomState(9)
    lo = r.randn(N, 3).astype(np.float32)
    hi = lo + r.rand(N, 3).astype(np.float32) * 2.0
    tmin = np.zeros(N, np.float32)
    tmax = np.full(N, 1e30, np.float32)
    args = (inv, iox, tmin, tmax, lo, hi)
    got = tprim.intersect_ray_box(*map(_t, args))
    want = jprim.intersect_ray_box(*map(jnp.asarray, args))
    _close(got, tuple(want), HIT_TOL)
    np.testing.assert_array_equal((got[0] <= got[1]).numpy(),
                                  np.asarray(want[0] <= want[1]))


def test_intersect_ray_box_soa_matches_jax():
    """The wide-node slab test: 4,096 rays, each against an 8-child node's
    (6, 8) bounds, entry and exit (4096, 8) as the box test's."""
    org, d, inv, iox = _box_inputs(10)
    r = np.random.RandomState(11)
    mid = r.randn(N, 3, 8).astype(np.float32) * 0.5
    lo = mid - 1.5
    hi = mid + r.rand(N, 3, 8).astype(np.float32) * 1.5
    bounds = np.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1], lo[:, 2],
                       hi[:, 2]], axis=1)
    tmin = np.zeros(N, np.float32)
    tmax = np.full(N, 1e30, np.float32)
    args = (inv, iox, tmin, tmax, bounds)
    got = tprim.intersect_ray_box_soa(*map(_t, args))
    want = jprim.intersect_ray_box_soa(*map(jnp.asarray, args))
    assert tuple(got[0].shape) == (N, 8)
    _close(got, tuple(want), HIT_TOL)
    hits = np.asarray(want[0] <= want[1])
    np.testing.assert_array_equal((got[0] <= got[1]).numpy(), hits)
    assert 0.05 < hits.mean() < 0.95


@pytest.fixture(scope="module")
def soup():
    verts, idx = random_tri_soup(400, seed=5)
    r = np.random.RandomState(1)
    org = r.randn(1000, 3).astype(np.float32) * 3.0
    d = r.randn(1000, 3).astype(np.float32)
    d[:8, 0] = 0.0
    return verts, idx, org, d


@pytest.mark.parametrize("arity,m", [(8, 8), (4, 4), (2, 4)])
def test_traverse_stack_depth_matches_jax(soup, arity, m):
    """api.traverse(stack_depth=) with the JAX meaning: the stack's entries,
    a push past them dropped while the pointer moves and a pop past them
    empty, so a ray skips what did not fit and may miss. At depths from
    2 (most rays lose subtrees) to the tree's worst case and the default,
    closest-hit and any-hit: prim_id and geom_id bit for bit, t/u/v
    within the traversal tolerance. The tile route takes no stack_depth;
    a negative one is refused."""
    verts, idx, org, d = soup
    bvh = build_bvh(verts, idx, arity=arity, packet=m)
    jdev = japi.bvh_to_device(bvh)
    tdev = tapi.bvh_to_device(bvh, "cpu")
    worst = tdev["meta"].shared_stack
    n = org.shape[0]
    misses = {}
    for any_hit, tmax in ((False, 1e30), (True, 2.0)):
        for depth in (None, 2, 3, 5, worst):
            want = japi.traverse(jdev, japi.make_rays(
                org, d, np.zeros(n, np.float32), np.full(n, tmax,
                                                         np.float32)),
                any_hit=any_hit, stack_depth=depth)
            got = tapi.traverse(tdev, tapi.make_rays(org, d, 0.0, tmax),
                                any_hit=any_hit, stack_depth=depth)
            for k in ("prim_id", "geom_id"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
            for k in ("t", "u", "v"):
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), **HIT_TOL)
            misses[(any_hit, depth)] = int((got["prim_id"] < 0).sum())
        assert misses[(any_hit, 2)] > misses[(any_hit, None)]
        assert misses[(any_hit, worst)] == misses[(any_hit, None)]
    rays = tapi.make_rays(org, d, 0.0, 1e30)
    with pytest.raises(ValueError, match="stack_depth"):
        tapi.traverse(tdev, rays, stack_depth=-1)
    if arity == 8:
        with pytest.raises(ValueError, match="tile route"):
            tapi.traverse(tdev, rays, stack_depth=4, tile_rows=1)


def test_intersect_bruteforce_any_hit_matches_jax(soup):
    """intersect_bruteforce takes any_hit as the JAX function does, whose
    result is the closest hit either way: hits bit for bit in ids and
    within the traversal tolerance in t/u/v, for both values; its hit/miss
    is the any-hit traversal's."""
    verts, idx, org, d = soup
    bvh = build_bvh(verts, idx, arity=4, packet=8)
    jdev = japi.bvh_to_device(bvh)
    tdev = tapi.bvh_to_device(bvh, "cpu")
    n = org.shape[0]
    jr = japi.make_rays(org, d, np.zeros(n, np.float32),
                        np.full(n, 2.0, np.float32))
    tr = tapi.make_rays(org, d, 0.0, 2.0)
    for any_hit in (False, True):
        want = japi.intersect_bruteforce(jdev, jr, any_hit=any_hit)
        got = tapi.intersect_bruteforce(tdev, tr, any_hit=any_hit)
        for k in ("prim_id", "geom_id"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        for k in ("t", "u", "v"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **HIT_TOL)
    np.testing.assert_array_equal(
        got["prim_id"].numpy() >= 0, tapi.occluded(tdev, tr).numpy())


def test_film_splat_matches_jax():
    """splat adds colours at pixel ids, repeated ids included, with and
    without a mask; an id in [-rows, -1] counts from the end and any other
    id out of range is dropped, as the JAX film's mode="drop" scatter; the
    film passed in is not changed."""
    r = np.random.RandomState(12)
    rows = 64 * 48
    film0 = r.rand(rows, 3).astype(np.float32)
    ids = r.randint(-rows - 50, rows + 50, size=20_000).astype(np.int32)
    color = r.rand(20_000, 3).astype(np.float32)
    mask = r.rand(20_000) < 0.7
    before = torch.from_numpy(film0.copy())
    for m in (None, mask):
        want = np.asarray(jfilm.splat(
            jnp.asarray(film0), jnp.asarray(ids), jnp.asarray(color),
            None if m is None else jnp.asarray(m)))
        got = tfilm.splat(before, torch.from_numpy(ids),
                          torch.from_numpy(color),
                          None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert torch.equal(before, torch.from_numpy(film0))
    assert ((ids < -rows) | (ids >= rows)).any() and (
        (ids < 0) & (ids >= -rows)).any()
