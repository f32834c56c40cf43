"""The options of the legacy Pallas body _kernel in the port's plain
traversal (api.traverse_components), against _kernel itself run in
interpret mode with count_pops=True.

_kernel walks a tile of rays with one shared stack. Each of 32 rays is
replicated across all 128 lanes of a one-row tile, so the tile's stack is
that ray's own stack and its per-tile counters (rows 0 and 1 of the tile's
8-row block) are the ray's (test_torch_traversal.py,
test_pop_counters_match_the_legacy_body). The soup is built BVH8/Tri8 with
leaves of up to five Tri rows, so leaf chains of 2 and 4 run and a chain
of 4 pushes its continuation. Per ray, pops, leaf pops and prim_id are held
equal, exactly. Any-hit rays are short (tmax 2), so some miss. K4's base
(traverse_packet's base=True, K4 with no option) is held against _kernel
with no option.
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

OPTIONS = {"nonodetest": {"ablate": ("nonodetest",)},
           "noleaftest": {"ablate": ("noleaftest",)},
           "nosort": {"ablate": ("nosort",)},
           "pops2": {"pops": 2},
           "chain2": {"leaf_chain": 2},
           "chain4": {"leaf_chain": 4}}
# nosort is closest-hit only: any-hit already pushes in slot order
CASES = [(o, ah) for o in OPTIONS for ah in (False, True)
         if not (ah and o == "nosort")]
RAYS = 32


@pytest.fixture(scope="module")
def soup():
    verts, idx = random_tri_soup(600, seed=47)
    bvh = build_bvh(verts, idx, arity=8, packet=8, leaf_threshold=32,
                    leaf_cost=0.2)
    rows = np.diff(np.concatenate([[-1], np.nonzero(
        bvh.prim_id[:, -1] < 0)[0]]))
    assert rows.max() > 4          # a chain of 4 leaves a continuation
    r = np.random.RandomState(55)
    org = r.randn(RAYS, 3).astype(np.float32) * 3.0
    d = r.randn(RAYS, 3).astype(np.float32)
    d[:4, 0] = 0.0                 # axis-parallel rays
    d[4:8, 1:] = 0.0
    return japi.bvh_to_device(bvh), tapi.bvh_to_device(bvh, "cpu"), org, d


def _tmax(any_hit):
    return np.float32(2.0 if any_hit else 1e30)


@pytest.mark.parametrize("option,any_hit", CASES)
def test_option_matches_the_legacy_body(soup, option, any_hit):
    jdev, tdev, org, d = soup
    tmax = _tmax(any_hit)
    kw = OPTIONS[option]
    n = RAYS * 128
    jr = japi.make_rays(jnp.asarray(np.repeat(org, 128, 0)),
                        jnp.asarray(np.repeat(d, 128, 0)),
                        jnp.zeros(n, jnp.float32), jnp.full(n, tmax))
    packed, nt = pack_rays(jr, 1, 1)
    outs = _call_kernel(jdev, packed, nt, 1, any_hit, True, count_pops=True,
                        multi=1, **kw)
    cnt = np.asarray(outs[5]).reshape(nt, 8, 128)
    want_prim = np.asarray(outs[3]).reshape(nt, 128)[:, 0]
    rays = tapi.make_rays(org, d, 0.0, tmax)
    got = {k: v.numpy() for k, v in tapi.traverse(
        tdev, rays, any_hit=any_hit, count_pops=True, **kw).items()}
    np.testing.assert_array_equal(got["pops"], cnt[:, 0, 0])
    np.testing.assert_array_equal(got["leaf_pops"], cnt[:, 1, 0])
    np.testing.assert_array_equal(got["prim_id"], want_prim)

    # what the option does, against the plain version without it
    base = {k: v.numpy() for k, v in tapi.traverse(
        tdev, rays, any_hit=any_hit, count_pops=True).items()}
    hits = base["prim_id"] >= 0
    assert 0 < hits.mean() < 1
    if option == "noleaftest":
        assert (got["prim_id"] == -1).all()
    elif not any_hit:
        np.testing.assert_array_equal(got["prim_id"], base["prim_id"])
    else:
        np.testing.assert_array_equal(got["prim_id"] >= 0, hits)
    if option == "nonodetest":
        assert (got["pops"] >= base["pops"]).all()
        assert got["pops"].sum() > base["pops"].sum()
    if option.startswith("chain"):
        assert (got["leaf_pops"] <= base["leaf_pops"]).all()
        assert got["leaf_pops"].sum() < base["leaf_pops"].sum()


@pytest.mark.parametrize("any_hit", [False, True])
def test_base_matches_the_legacy_body(soup, any_hit):
    """K4's base through the wrapper on CPU tensors (the plain version with
    no option) against _kernel with count_pops=True and no option: per
    ray, pops, leaf pops and prim_id equal."""
    jdev, tdev, org, d = soup
    tmax = _tmax(any_hit)
    n = RAYS * 128
    jr = japi.make_rays(jnp.asarray(np.repeat(org, 128, 0)),
                        jnp.asarray(np.repeat(d, 128, 0)),
                        jnp.zeros(n, jnp.float32), jnp.full(n, tmax))
    packed, nt = pack_rays(jr, 1, 1)
    outs = _call_kernel(jdev, packed, nt, 1, any_hit, True, count_pops=True,
                        multi=1)
    cnt = np.asarray(outs[5]).reshape(nt, 8, 128)
    got = {k: v.numpy() for k, v in tpacket.traverse_packet(
        tdev, tapi.make_rays(org, d, 0.0, tmax), any_hit=any_hit,
        count_pops=True, **tpacket.OPTION_ARGS["base"]).items()}
    np.testing.assert_array_equal(got["pops"], cnt[:, 0, 0])
    np.testing.assert_array_equal(got["leaf_pops"], cnt[:, 1, 0])
    np.testing.assert_array_equal(
        got["prim_id"], np.asarray(outs[3]).reshape(nt, 128)[:, 0])
    assert 0 < (got["prim_id"] >= 0).mean() < 1


@pytest.mark.parametrize("option", [None, "chain4", "pops2", "nonodetest"])
def test_rows_read_are_the_rays_rows(soup, option):
    """count_rows marks the node and Tri rows the pops read: the batch's
    rows are the union of each ray's own, no more rows than pops, and the
    whole tree where the slab tests are off (the bound's byte term)."""
    _, tdev, org, d = soup
    kw = OPTIONS[option] if option else {}
    rays = tapi.make_rays(org, d, 0.0, 1e30)
    out = tapi.traverse(tdev, rays, count_pops=True, count_rows=True, **kw)
    nodes, tris = out["nodes_read"], out["tris_read"]
    assert nodes.shape == (tdev["nodes"].shape[0],)
    assert tris.shape == (tdev["tris"].shape[0],)
    node_pops = int((out["pops"] - out["leaf_pops"]).sum())
    assert int(nodes.sum()) <= node_pops
    assert int(tris.sum()) <= kw.get("leaf_chain", 1) * int(
        out["leaf_pops"].sum())
    union_n, union_t = torch.zeros_like(nodes), torch.zeros_like(tris)
    for i in range(RAYS):
        one = tapi.make_rays(org[i:i + 1], d[i:i + 1], 0.0, 1e30)
        r = tapi.traverse(tdev, one, count_rows=True, **kw)
        union_n |= r["nodes_read"]
        union_t |= r["tris_read"]
    assert torch.equal(union_n, nodes) and torch.equal(union_t, tris)
    assert bool(nodes[0])
    if option == "nonodetest":
        assert bool(nodes.all()) and bool(tris.all())
    else:
        assert not bool(tris.all())


def test_refused_options(soup):
    """nopure and frustum belong to a stack shared by a tile: the per-ray
    route refuses them and names tile_rows, the tile route's argument
    (tests/test_torch_tile.py runs them); nosort is closest-hit only; pops
    is 1 or 2 and a chain 1, 2 or 4."""
    _, tdev, org, d = soup
    rays = tapi.make_rays(org, d, 0.0, 1e30)
    for call in (tapi.traverse, tpacket.traverse_packet):
        with pytest.raises(ValueError, match="nopure.*tile_rows="):
            call(tdev, rays, ablate=("nopure",))
        with pytest.raises(ValueError, match="frustum.*tile_rows="):
            call(tdev, rays, frustum=True)
        with pytest.raises(ValueError, match="closest-hit only"):
            call(tdev, rays, any_hit=True, ablate=("nosort",))
        with pytest.raises(ValueError, match="pops=3"):
            call(tdev, rays, pops=3)
        with pytest.raises(ValueError, match="leaf_chain=3"):
            call(tdev, rays, leaf_chain=3)
    with pytest.raises(ValueError, match="one at a time"):
        tpacket.traverse_packet(tdev, rays, pops=2, leaf_chain=2)
    with pytest.raises(ValueError, match="prefetch"):
        tpacket.traverse_packet(tdev, rays, prefetch=True, pops=2)


def test_cpu_options_launch_nothing(soup):
    """traverse_packet on CPU tensors with any option takes the plain
    version: the counters and hits of api.traverse, and no launch.
    row_loads changes nothing the plain version computes."""
    _, tdev, org, d = soup
    tpacket.reset_launches()
    for any_hit in (False, True):
        rays = tapi.make_rays(org, d, 0.0, _tmax(any_hit))
        base = tapi.traverse(tdev, rays, any_hit=any_hit, count_pops=True)
        for name, kw in tpacket.OPTION_ARGS.items():
            if any_hit and name == "nosort":
                continue
            got = tpacket.traverse_packet(tdev, rays, any_hit=any_hit,
                                          count_pops=True, **kw)
            plain = {k: v for k, v in kw.items()
                     if k not in ("row_loads", "base")}
            want = (tapi.traverse(tdev, rays, any_hit=any_hit,
                                  count_pops=True, **plain)
                    if plain else base)
            for key in want:
                assert torch.equal(got[key], want[key]), (name, key)
    assert set(tpacket.launches.values()) == {0}


def test_cpu_base_routes_to_the_plain_traversal(soup):
    """base=True on CPU tensors is the plain traversal with no option (K3's
    plain version): the same hits, and its counters with count_pops=True,
    without a launch; option_name() of no arguments stays None (K1-K3's
    route); the base takes no other option, no carry-top body and no tile
    route."""
    _, tdev, org, d = soup
    assert tpacket.option_name() is None
    assert tpacket.option_name(base=True) == "base"
    assert tpacket.OPTIONS[-1] == "base"
    tpacket.reset_launches()
    for any_hit in (False, True):
        rays = tapi.make_rays(org, d, 0.0, _tmax(any_hit))
        for count in (False, True):
            got = tpacket.traverse_packet(tdev, rays, any_hit=any_hit,
                                          count_pops=count, base=True)
            want = tapi.traverse(tdev, rays, any_hit=any_hit,
                                 count_pops=count)
            assert set(got) == set(want)
            for key in want:
                assert torch.equal(got[key], want[key]), (any_hit, key)
    assert set(tpacket.launches.values()) == {0}
    rays = tapi.make_rays(org, d, 0.0, 1e30)
    with pytest.raises(ValueError, match="one at a time"):
        tpacket.traverse_packet(tdev, rays, base=True, pops=2)
    with pytest.raises(ValueError, match="carry_top=True with base"):
        tpacket.traverse_packet(tdev, rays, base=True, carry_top=True)
    with pytest.raises(ValueError, match="no base"):
        tpacket.traverse_packet(tdev, rays, base=True, tile_rows=1)
    with pytest.raises(ValueError, match="prefetch"):
        tpacket.traverse_packet(tdev, rays, base=True, prefetch=True)
