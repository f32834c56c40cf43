"""The carry-top body (the JAX package's _kernel_ct) in the port: its plain
version, api.traverse_ct_components (the plain version of K7,
csrc/bvh_ct.cu), against _kernel_ct itself run in interpret mode.

- Hits: the soup of tests/test_traversal.py:286 and a make_hall(2_000)
  build, 300 and 256 rays in tiles of 4 rows, every select and slab form:
  prim_id equal, t/u/v within the North star's atol 1e-5 / rtol 1e-6,
  any-hit hit/miss equal.
- Pops per ray: each ray replicated across the 128 lanes of a one-row tile,
  so the tile's stack is the ray's own and its counters (rows 0 and 1 of
  the tile's 8-row block) the ray's. Pops and leaf pops equal, in every
  select and slab form, closest-hit and any-hit. XLA's interpreter and the
  port's fma_f32 agree on every fused key these rays test: no ray's pops
  differ. A dead ray (tmax < tmin) pops the root once in the tile and
  never starts in the port (as K1 and K3 do): 0 pops.
- select="sort" with the unfused slab pops what the legacy order pops, so
  it equals api.traverse_components (K1's and K3's plain version) in every
  output bit.
- fma_f32 equals the exact rational a * b + c rounded to float32
  (fractions.Fraction) on random and edge triples.
- The next-pop prefetch (K7-PF on a card): the port's
  traverse_packet(carry_top=True, prefetch=True) on CPU tensors against
  _kernel_ct with tris_hbm=True and prefetch=True (_pf_helpers' DMAs), with
  and without nodes_hbm, on the soup and at Tri16, every select and slab
  form, closest-hit and any-hit: the same tolerance.
- The wrapper's refusals: the options the JAX wrapper demotes the carry-top
  body for, tile_rows=, row_loads, the prefetch with count_pops (which the
  JAX wrapper drops there) and an unknown select.
"""
import struct
from fractions import Fraction

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rodent_tpu.accel import build_bvh
from rodent_tpu.traversal import api as japi
from rodent_tpu.traversal.pallas_packet import (_call_kernel, pack_rays,
                                                traverse_packet)
from rodent_tpu.utils import testscenes
from rodent_tpu_torch.experiments import sass_audit
from rodent_tpu_torch.kernels import build
from rodent_tpu_torch.traversal import api as tapi
from rodent_tpu_torch.traversal import packet as tpacket
from test_traversal import random_tri_soup

torch.set_num_threads(1)

BODIES = [{"select": sel, "fma_slab": fma} for sel in ("fold", "sort")
          for fma in (True, False)]
IDS = [f"{b['select']}-{'fma' if b['fma_slab'] else 'nofma'}"
       for b in BODIES]
FLT_MAX = np.float32(3.402823466e38)


def _scene(name):
    """(BVH8 build, origins, directions, any-hit tmax) of a test scene."""
    if name == "soup":
        verts, idx = random_tri_soup(257, seed=47)
        bvh = build_bvh(verts, idx, arity=8, packet=8)
        r = np.random.RandomState(49)
        org = r.randn(300, 3).astype(np.float32) * 3.0
        d = r.randn(300, 3).astype(np.float32)
        return bvh, org, d, np.float32(2.0)
    verts, idx = testscenes.make_hall(2_000)
    bvh = build_bvh(verts, idx, arity=8, packet=8, leaf_threshold=12)
    org, d = testscenes.hall_primary_rays(16, 16)
    return bvh, org, d, FLT_MAX


@pytest.fixture(scope="module", params=["soup", "hall"])
def scene(request):
    bvh, org, d, ah_tmax = _scene(request.param)
    return (request.param, japi.bvh_to_device(bvh),
            tapi.bvh_to_device(bvh, "cpu"), org, d, ah_tmax)


@pytest.mark.parametrize("body", BODIES, ids=IDS)
def test_plain_matches_kernel_ct(scene, body):
    name, jdev, tdev, org, d, ah_tmax = scene
    n = len(org)
    for any_hit, tmax in ((False, FLT_MAX), (True, ah_tmax)):
        jr = japi.make_rays(jnp.asarray(org), jnp.asarray(d),
                            jnp.zeros(n, jnp.float32),
                            jnp.full(n, tmax, jnp.float32))
        want = {k: np.asarray(v) for k, v in traverse_packet(
            jdev, jr, any_hit=any_hit, tile_rows=4, interpret=True,
            carry_top=True, **body).items()}
        got = {k: v.numpy() for k, v in tapi.traverse(
            tdev, tapi.make_rays(org, d, 0.0, tmax), any_hit=any_hit,
            carry_top=True, **body).items()}
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
@pytest.mark.parametrize("body", BODIES, ids=IDS)
def test_pops_per_ray_match_kernel_ct(scene, body, any_hit):
    name, jdev, tdev, org, d, ah_tmax = scene
    org, d = org[:40], d[:40]
    tmax = np.full(len(org), ah_tmax if any_hit else FLT_MAX, np.float32)
    tmax[:2] = -1.0                       # dead rays
    n = len(org) * 128
    jr = japi.make_rays(jnp.asarray(np.repeat(org, 128, 0)),
                        jnp.asarray(np.repeat(d, 128, 0)),
                        jnp.zeros(n, jnp.float32),
                        jnp.asarray(np.repeat(tmax, 128)))
    packed, nt = pack_rays(jr, 1, 1)
    outs = _call_kernel(jdev, packed, nt, 1, any_hit, True, count_pops=True,
                        multi=1, carry_top=True, **body)
    cnt = np.asarray(outs[5]).reshape(nt, 8, 128)
    want_prim = np.asarray(outs[3]).reshape(nt, 128)[:, 0]
    got = {k: v.numpy() for k, v in tapi.traverse(
        tdev, tapi.make_rays(org, d, 0.0, tmax), any_hit=any_hit,
        count_pops=True, carry_top=True, **body).items()}
    live = tmax >= 0
    np.testing.assert_array_equal(got["pops"][live], cnt[live, 0, 0])
    np.testing.assert_array_equal(got["leaf_pops"][live], cnt[live, 1, 0])
    assert (cnt[~live, 0, 0] == 1).all() and (got["pops"][~live] == 0).all()
    assert (got["leaf_pops"][~live] == 0).all()
    np.testing.assert_array_equal(got["prim_id"], want_prim)
    assert got["pops"][live].mean() > 2, name      # rays walk the tree


def _pf_soup(packet):
    """The soup of tests/test_traversal.py at Tri8, or at Tri16 as its Tri16
    test builds it (leaves of up to 32 triangles: two VMEM lines a row, one
    DMA in the HBM modes)."""
    verts, idx = random_tri_soup(257, seed=47)
    kw = {"leaf_threshold": 32} if packet == 16 else {}
    bvh = build_bvh(verts, idx, arity=8, packet=packet, **kw)
    assert bvh.tri_v0.shape[1] == packet
    return japi.bvh_to_device(bvh), tapi.bvh_to_device(bvh, "cpu")


@pytest.fixture(scope="module", params=[8, 16], ids=["soup", "soup-tri16"])
def pf_soup(request):
    return _pf_soup(request.param)


@pytest.mark.parametrize("nodes_hbm", [False, True],
                         ids=["tris_hbm", "giga"])
@pytest.mark.parametrize("body", BODIES, ids=IDS)
def test_prefetch_matches_kernel_ct(pf_soup, body, nodes_hbm):
    jdev, tdev = pf_soup
    r = np.random.RandomState(49)
    org = r.randn(300, 3).astype(np.float32) * 3.0
    d = r.randn(300, 3).astype(np.float32)
    n = len(org)
    tpacket.reset_launches()
    for any_hit, tmax in ((False, FLT_MAX), (True, np.float32(2.0))):
        jr = japi.make_rays(jnp.asarray(org), jnp.asarray(d),
                            jnp.zeros(n, jnp.float32),
                            jnp.full(n, tmax, jnp.float32))
        want = {k: np.asarray(v) for k, v in traverse_packet(
            jdev, jr, any_hit=any_hit, tile_rows=4, interpret=True,
            carry_top=True, tris_hbm=True, nodes_hbm=nodes_hbm,
            prefetch=True, **body).items()}
        got = {k: v.numpy() for k, v in tpacket.traverse_packet(
            tdev, tapi.make_rays(org, d, 0.0, tmax), any_hit=any_hit,
            carry_top=True, prefetch=True, **body).items()}
        hit = want["prim_id"] >= 0
        assert 0 < hit.sum()
        if any_hit:
            np.testing.assert_array_equal(got["prim_id"] >= 0, hit)
            continue
        np.testing.assert_array_equal(got["prim_id"], want["prim_id"])
        np.testing.assert_array_equal(got["geom_id"], want["geom_id"])
        for key in ("t", "u", "v"):
            np.testing.assert_allclose(got[key][hit], want[key][hit],
                                       atol=1e-5, rtol=1e-6)
        np.testing.assert_array_equal(got["t"][~hit], want["t"][~hit])
    assert set(tpacket.launches.values()) == {0}


@pytest.mark.parametrize("name", ["soup", "hall"])
def test_sort_unfused_is_the_legacy_order(name):
    """carry_top with select="sort" and the unfused slab pops the legacy
    order's entries in its order: every output (hits, pops, leaf pops,
    rows read) equals api.traverse_components', closest-hit and any-hit;
    the fold and the fused slab keep the same hits here."""
    bvh, org, d, ah_tmax = _scene(name)
    tdev = tapi.bvh_to_device(bvh, "cpu")
    for any_hit, tmax in ((False, FLT_MAX), (True, ah_tmax)):
        rays = tapi.make_rays(org, d, 0.0, tmax)
        legacy = tapi.traverse(tdev, rays, any_hit=any_hit, count_pops=True,
                               count_rows=True)
        ct = tapi.traverse(tdev, rays, any_hit=any_hit, count_pops=True,
                           count_rows=True, carry_top=True, select="sort",
                           fma_slab=False)
        assert set(ct) == set(legacy)
        for key in legacy:
            assert torch.equal(ct[key], legacy[key]), key
        fold = tapi.traverse(tdev, rays, any_hit=any_hit, carry_top=True)
        assert torch.equal(fold["prim_id"] >= 0, legacy["prim_id"] >= 0)
        if not any_hit:
            assert torch.equal(fold["prim_id"], legacy["prim_id"])


def _f32(bits):
    return struct.unpack("<f", struct.pack("<I", bits & 0xFFFFFFFF))[0]


def _round_f32(x):
    """The exact rational x rounded to the nearest float32, ties to even;
    beyond the largest float32's rounding boundary, infinity."""
    if x == 0:
        return 0.0
    lim = Fraction(2 ** 128) - Fraction(2 ** 103)
    if abs(x) >= lim:
        return float("inf") if x > 0 else float("-inf")
    c = np.float32(float(x))
    cands = {c, np.nextafter(c, np.float32(-np.inf)),
             np.nextafter(c, np.float32(np.inf))}
    best = min((v for v in cands if np.isfinite(v)),
               key=lambda v: (abs(Fraction(float(v)) - x),
                              int(np.float32(v).view(np.int32)) & 1))
    return float(best)


def test_fma_f32_is_correctly_rounded():
    """fma_f32(a, b, c) equals a * b + c computed exactly and rounded once
    to float32, on random triples over a wide range of exponents, on
    cancellations (c near -(a * b)), halfway cases, subnormal results and
    overflow, and on the slab planes' own shape (b * inv + (-(org * inv)))
    with inv clamped to 2^62."""
    r = np.random.RandomState(7)
    k = 4000
    a = (r.randn(k) * np.exp2(r.randint(-60, 60, k))).astype(np.float32)
    b = (r.randn(k) * np.exp2(r.randint(-60, 60, k))).astype(np.float32)
    c = (r.randn(k) * np.exp2(r.randint(-60, 60, k))).astype(np.float32)
    # cancellations: c the float32 nearest -(a * b), or one ULP off it
    cc = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)
    c[:1000] = np.where(np.arange(1000) % 2, cc,
                        np.nextafter(cc, np.float32(np.inf)))
    # halfway and tiny cases: a * b exact with a 25-bit significand
    a[1000:1200] = np.float32(1 + 2.0 ** -12)
    b[1000:1200] = np.float32(1 + 2.0 ** -12)
    c[1000:1200] = (np.arange(200) - 100).astype(np.float32) * np.float32(
        2.0 ** -24)
    # subnormal results and overflow
    a[1200:1300] = np.float32(1e-30)
    b[1200:1300] = (r.rand(100) * 1e-10).astype(np.float32)
    c[1200:1300] = (r.randn(100) * 1e-41).astype(np.float32)
    a[1300:1320] = np.float32(3e38)
    b[1300:1320] = np.float32(2.0)
    c[1300:1320] = np.float32(-3e38)
    # slab planes: bounds in a scene, inverse clamped, io = -(org * inv)
    inv = np.clip((1.0 / r.randn(500)).astype(np.float32) * np.exp2(
        r.randint(0, 70, 500)).astype(np.float32), -2.0 ** 62, 2.0 ** 62)
    org = (r.randn(500) * 10).astype(np.float32)
    a[1400:1900] = (r.randn(500) * 10).astype(np.float32)
    b[1400:1900] = inv.astype(np.float32)
    c[1400:1900] = -(org * b[1400:1900])
    got = tapi.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    for i in range(k):
        want = _round_f32(Fraction(float(a[i])) * Fraction(float(b[i]))
                          + Fraction(float(c[i])))
        g = float(got[i])
        assert g == want or (np.isnan(g) and np.isnan(want)), (
            i, a[i], b[i], c[i], g, want)
    # rounded once: (1 + 2^-12)^2 - 1 = 2^-11 + 2^-24, which the product
    # rounded first (a tie, to even) loses
    one = torch.tensor([_f32(0x3F800800)])
    assert tapi.fma_f32(one, one, torch.tensor([-1.0])).item() == _f32(
        0x3A000400)
    assert (one * one - 1.0).item() == _f32(0x3A000000)


def test_wrapper_refusals():
    """The carry-top route refuses what the JAX wrapper silently demotes
    to the legacy body (pallas_packet.py:1517-1520), naming the demotion,
    tile_rows=, row_loads, the prefetch with count_pops (the JAX wrapper
    drops the prefetch there, :1537-1538) and a select other than fold or
    sort; the prefetch alone takes the plain version on CPU tensors, and
    the CPU route counts no launch."""
    verts, idx = random_tri_soup(257, seed=47)
    tdev = tapi.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8),
                              "cpu")
    r = np.random.RandomState(3)
    rays = tapi.make_rays(r.randn(64, 3), r.randn(64, 3), 0.0, 1e30)
    for kw in ({"frustum": True}, {"ablate": ("nosort",)}, {"pops": 2},
               {"leaf_chain": 2}):
        for call in (tpacket.traverse_packet, tapi.traverse):
            with pytest.raises(ValueError, match="demotes the carry-top"):
                call(tdev, rays, carry_top=True, **kw)
    with pytest.raises(ValueError, match="tile_rows="):
        tpacket.traverse_packet(tdev, rays, carry_top=True, tile_rows=1)
    with pytest.raises(ValueError, match="tile_rows="):
        tapi.traverse(tdev, rays, carry_top=True, tile_rows=1)
    for kw in ({"row_loads": True}, {"row_loads": True, "prefetch": True}):
        with pytest.raises(ValueError, match="carry_top=True with row_loads"):
            tpacket.traverse_packet(tdev, rays, carry_top=True, **kw)
    with pytest.raises(ValueError, match="carry_top=True with prefetch and "
                       "count_pops"):
        tpacket.traverse_packet(tdev, rays, carry_top=True, prefetch=True,
                                count_pops=True)
    with pytest.raises(ValueError, match="tile_rows="):
        tpacket.traverse_packet(tdev, rays, carry_top=True, prefetch=True,
                                tile_rows=1)
    for carry_top in (True, False):
        with pytest.raises(ValueError, match="select='min'"):
            tpacket.traverse_packet(tdev, rays, carry_top=carry_top,
                                    select="min")
    with pytest.raises(ValueError, match="stack_depth"):
        tapi.traverse(tdev, rays, carry_top=True, stack_depth=8)
    tpacket.reset_launches()
    ct = tpacket.traverse_packet(tdev, rays, carry_top=True)
    pf = tpacket.traverse_packet(tdev, rays, carry_top=True, prefetch=True)
    for key in ct:
        assert torch.equal(pf[key], ct[key]), key
    assert set(tpacket.launches.values()) == {0}
    dev4 = tapi.bvh_to_device(build_bvh(verts, idx, arity=4, packet=8),
                              "cpu")
    comps = [*tapi.components(rays)[2], *tapi.components(rays)[0],
             *tapi.components(rays)[1], rays["tmin"], rays["tmax"]]
    with pytest.raises(ValueError, match="bvh_traverse_ct is built for"):
        tpacket._launch_ct(dev4, comps, False, False, "fold", True)
    with pytest.raises(ValueError,
                       match="bvh_traverse_ct_prefetch is built for"):
        tpacket._launch_ct(dev4, comps, False, False, "fold", True, True)
    with pytest.raises(ValueError,
                       match="bvh_traverse_ct_prefetch has no counters"):
        tpacket._launch_ct(dev4, comps, False, True, "fold", True, True)


def test_wrapper_refuses_unaligned_tables():
    """K7 and K7-PF read node and Tri rows in 16-byte loads: a table view
    that starts 4 bytes into its storage makes the wrapper raise before a
    launch, with or without counters and the prefetch."""
    verts, idx = random_tri_soup(257, seed=47)
    tdev = tapi.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8),
                              "cpu")
    r = np.random.RandomState(3)
    rays = tapi.make_rays(r.randn(64, 3), r.randn(64, 3), 0.0, 1e30)
    org, dirv, inv, _, tmin, tmax = tapi.components(rays)
    comps = [*inv, *org, *dirv, tmin, tmax]
    tpacket.reset_launches()
    for table in ("nodes", "tris"):
        x = tdev[table]
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
        flat[1:] = x.reshape(-1)
        off = dict(tdev, **{table: flat[1:].view(x.shape)})
        assert off[table].is_contiguous() and off[table].data_ptr() % 16
        for count, pf in ((False, False), (True, False), (False, True)):
            with pytest.raises(ValueError, match="16-byte aligned"):
                tpacket._launch_ct(off, comps, False, count, "fold", True,
                                   pf)
    assert set(tpacket.launches.values()) == {0}


def test_plain_records_pop_kinds(scene):
    """record_kinds=True adds each ray's pop kinds in order (1 node, -1
    leaf, then 0): as many node and leaf pops as the counters, every 0
    after the last pop, and no other output bit moves."""
    _, _, tdev, org, d, ah_tmax = scene
    for any_hit, tmax in ((False, FLT_MAX), (True, ah_tmax)):
        o, dv, inv, _, tmin, tm = tapi.components(
            tapi.make_rays(org, d, 0.0, tmax))
        for body in BODIES:
            base = tapi.traverse_ct_components(tdev, o, dv, inv, tmin, tm,
                                               any_hit, count_pops=True,
                                               **body)
            rec = tapi.traverse_ct_components(tdev, o, dv, inv, tmin, tm,
                                              any_hit, count_pops=True,
                                              record_kinds=True, **body)
            k = rec.pop("kinds")
            assert set(rec) == set(base)
            for key in base:
                assert torch.equal(rec[key], base[key]), key
            assert k.dtype == torch.int8 and k.shape[0] == tmin.shape[0]
            assert k.shape[1] == int(base["pops"].max())
            assert torch.equal((k == 1).sum(1).int(),
                               base["pops"] - base["leaf_pops"])
            assert torch.equal((k == -1).sum(1).int(), base["leaf_pops"])
            done = (k == 0).int().cumsum(1) > 0
            assert not bool((done & (k != 0)).any())


def test_warp_model_on_hand_made_sequences():
    """ct_warp_model's three rules on kind sequences whose counts are
    known. Two lanes that alternate node and leaf pops out of step: the
    if-if loop runs both paths every trip (4 and 4); the while-while loop
    runs node pops while either lane's next pop is a node (3 node runs, 2
    leaf runs, 3 outer trips); the busiest ray takes 2 of each. Lanes with
    equal sequences run each path once a pop under every rule. A ray that
    never starts pads its warp; the instructions are runs times a pop's."""
    from rodent_tpu_torch.experiments import ct_warp_model as wm
    k = torch.tensor([[1, -1, 1, -1], [-1, 1, -1, 1]], dtype=torch.int8)
    c = wm.warp_counts(k, warp=2)
    assert (c["rays"], c["warps"], c["node_pops"], c["leaf_pops"]) == (
        2, 1, 4, 4)
    assert (c["if-if"]["node"], c["if-if"]["leaf"]) == (4, 4)
    assert (c["while-while"]["node"], c["while-while"]["leaf"],
            c["while-while"]["outer"]) == (3, 2, 3)
    assert (c["busiest"]["node"], c["busiest"]["leaf"]) == (2, 2)
    assert c["if-if"]["node_busy"] == pytest.approx(4 / 8)
    assert c["while-while"]["node_busy"] == pytest.approx(4 / 6)
    assert c["while-while"]["leaf_busy"] == pytest.approx(4 / 4)
    assert wm.instructions(c, 10, 100) == {"if-if": 440, "while-while": 230,
                                            "busiest": 220}
    same = torch.tensor([[1, 1, -1, 1, -1, -1]] * 3 + [[0] * 6],
                        dtype=torch.int8)
    c = wm.warp_counts(same, warp=2)
    assert c["warps"] == 2 and c["node_pops"] == 9 and c["leaf_pops"] == 9
    for rule in wm.RULES:
        assert (c[rule]["node"], c[rule]["leaf"]) == (6, 6), rule
    assert c["while-while"]["outer"] == 2 * 2   # two trips a warp
    # a leaf first, a lane that ends early: the node loop waits on no one
    k = torch.tensor([[-1, 1, 1, 1], [1, -1, 0, 0]], dtype=torch.int8)
    c = wm.warp_counts(k, warp=2)
    assert (c["if-if"]["node"], c["if-if"]["leaf"]) == (4, 2)
    assert (c["while-while"]["node"], c["while-while"]["leaf"]) == (4, 1)
    assert (c["busiest"]["node"], c["busiest"]["leaf"]) == (3, 1)
    assert wm.parse_instr(["8=316,775", "24=316,2251"]) == {
        8: (316.0, 775.0), 24: (316.0, 2251.0)}
    with pytest.raises(ValueError, match="M=NODE,LEAF"):
        wm.parse_instr(["8:316"])


def test_sass_audit_reads_the_ct_kernel():
    """sass_audit finds K7's outer loop, its node loop and the leaf loop
    after it (the while-while form) and its lane loop's lanes a trip (a
    loop over groups of kLeafLanes lanes, each field read by one wide
    load, unrolled once) in csrc/bvh_ct.cu, demangles its instantiations,
    and the "ct" library builds from that source alone (with the shared
    header)."""
    src = (build.CSRC / "bvh_ct.cu").read_text()
    reg = sass_audit.kernel_regions(src, "bvh_ct_kernel")
    assert reg["body"][0] < reg["loop"][0] < reg["node"][0] < reg["leaf"][0]
    assert reg["node"][1] < reg["leaf"][0]
    assert reg["leaf"][1] < reg["loop"][1] < reg["body"][1]
    lines = src.splitlines()
    assert "while (code > 0) {" in lines[reg["node"][0] - 1]
    assert "while (code < 0) {" in lines[reg["leaf"][0] - 1]
    assert sass_audit.lane_unroll(src, "bvh_ct_kernel") == 4
    assert sass_audit.demangle(
        "_ZN12_GLOBAL__N_113bvh_ct_kernelILb0ELi8ELi24ELi128ELb1ELb0ELb1EEE"
        "vNS_4ArgsE") == ("bvh_ct_kernel", (0, 8, 24, 128, 1, 0, 1))
    assert build.LIBRARIES["ct"] == ("bvh_ct.cu", ())
    assert "rt_bvh_traverse_ct" in build._ENTRIES["ct"]
    labels = [i[0] for i in sass_audit.INSTANCES if i[2] == "bvh_ct_kernel"]
    assert len(labels) == 4 and "ct" in sass_audit.AUDITED


def test_ct_bound_counts_its_own_work():
    """The bound of a K7 launch (experiments.common) counts the carry-top
    body's operations (25 a child's ordered slab, K1's push, the fold's 7
    compare-selects, any-hit's 8, or Batcher's 19 exchanges of 5) and the
    rows its own plain version reads (ct_plain, rows_read with ct=)."""
    from rodent_tpu_torch.experiments import common
    assert common.pop_ops(8, 8) == (8 * 32 + 7 * 19, 2 + 8 * 59)
    assert common.pop_ops(8, 8, select="fold") == (8 * 29 + 21, 2 + 8 * 59)
    assert common.pop_ops(8, 24, select="sort") == (8 * 29 + 95,
                                                     2 + 24 * 59)
    assert common.pop_ops(8, 8, True, select="fold")[0] == 8 * 29 + 16
    bvh, org, d, _ = _scene("hall")
    tdev = tapi.bvh_to_device(bvh, "cpu")
    comps = tapi.components(tapi.make_rays(org, d, 0.0, FLT_MAX))
    for body in BODIES:
        p = common.ct_plain(tdev, comps, **body)
        rows = (int(p["nodes_read"].sum()), int(p["tris_read"].sum()))
        assert common.rows_read(tdev, comps, ct=body) == rows
        s = common.pop_stats(p)
        ms, what = common.bound_ms(tdev, s["n"], s["node"], s["leaf"], rows,
                                   select=body["select"])
        node, leaf = common.pop_ops(8, 8, select=body["select"])
        ops = (node * s["node"] + leaf * s["leaf"]) / common.PEAK_OPS
        nbytes = (s["n"] * 64 + rows[0] * 28 * 8
                  + rows[1] * 56 * 8) / common.PEAK_BYTES
        assert ms == pytest.approx(max(ops, nbytes) * 1e3)
        assert what == ("operations" if ops >= nbytes else "bytes")
