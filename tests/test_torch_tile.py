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


def test_tile_libraries_and_flags():
    """The two schedules of csrc/bvh_tile.cu are two libraries of one
    source: "tile" (the warp schedule, which the wrappers load) and
    "tile_v1" (-DRT_TILE_V1, the first schedule), both for sm_90a with
    -fmad=false, exporting the same entries, the resource query among
    them; their built files differ."""
    from rodent_tpu_torch.kernels import build
    assert build.LIBRARIES["tile"] == ("bvh_tile.cu", ())
    assert build.LIBRARIES["tile_v1"] == ("bvh_tile.cu", ("-DRT_TILE_V1",))
    for kind in ("tile", "tile_v1"):
        flags = build._flags(kind)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "-fmad=false" in flags
        assert ("-DRT_TILE_V1" in flags) == (kind == "tile_v1")
    assert build._ENTRIES["tile_v1"] == build._ENTRIES["tile"]
    assert "rt_bvh_tile_resources" in build._ENTRIES["tile"]
    assert build.library_path(kind="tile") != build.library_path(
        kind="tile_v1")
    src = (build.CSRC / "bvh_tile.cu").read_text()
    assert "#ifdef RT_TILE_V1" in src and "bvh_tile_warp_kernel" in src
    from rodent_tpu_torch.experiments import ab_tile_body
    assert set(ab_tile_body.LIBRARY.values()) == {"tile", "tile_v1"}
    assert ab_tile_body.LIBRARY[ab_tile_body.WRAPPED] == "tile"


@pytest.mark.parametrize("schedule", ["v1", "warp"])
@pytest.mark.parametrize("mode", ["plain", "frustum", "nopure"])
def test_ab_tile_body_launch_on_cpu(scene, schedule, mode):
    """ab_tile_body.launch on CPU tensors is the plain tile version for
    either schedule, counters included, and launches nothing."""
    from rodent_tpu_torch.experiments import ab_tile_body
    _, tdev = scene
    org, d = _batch("coherent")
    rays = tapi.make_rays(org, d, 0.0, _tmax(True))
    tpacket.reset_launches()
    got = ab_tile_body.launch(tdev, tapi.components(rays), "K5", schedule,
                              True, 2, mode)
    want = tapi.traverse(tdev, rays, any_hit=True, count_pops=True,
                         tile_rows=2, **MODES[mode])
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert set(tpacket.launches.values()) == {0}


def test_tile_launch_keys():
    """Each library's K5 and K6 count under their own key of
    packet.launches: the kernel's name for "tile", which the wrappers
    load, "tile_v1 <kernel>" for the first schedule; ab_tile_body reads
    them per schedule."""
    from rodent_tpu_torch.experiments import ab_tile_body as ab
    assert tpacket.launch_key("bvh_traverse_tile") == "bvh_traverse_tile"
    assert (tpacket.launch_key("bvh_traverse_pair", "tile_v1")
            == "tile_v1 bvh_traverse_pair")
    tpacket.reset_launches()
    for i, (s, k) in enumerate((s, k) for s in ab.SCHEDULES
                               for k in ab.KERNELS):
        key = tpacket.launch_key(ab.NAMES[k], ab.LIBRARY[s])
        assert key in tpacket.launches
        tpacket.launches[key] = i + 1
    assert [ab.launch_count(s, k) for s in ab.SCHEDULES
            for k in ab.KERNELS] == [1, 2, 3, 4]
    tpacket.reset_launches()
    assert set(tpacket.launches.values()) == {0}


def test_tile_frustum_rows32_stack_refused(scene):
    """The warp schedule's frustum mode at tile_rows 32 keeps the rays in
    shared memory beside a stack copy per warp: a stack past
    TILE_FRUSTUM_R32_STACK_MAX is refused by name before anything reaches
    a card."""
    _, tdev = scene
    org, d = _batch("coherent")
    rays = tapi.make_rays(org, d, 0.0, 1e30)
    o, dd, inv, _, tmin, tmax = tapi.components(rays)
    flat = [*inv, *o, *dd, tmin, tmax]
    cap = tpacket.TILE_FRUSTUM_R32_STACK_MAX + 1
    with pytest.raises(ValueError, match="frustum mode at tile_rows 32"):
        tpacket._launch_tile(tdev, flat, False, 32, "frustum", "tile", cap)


def test_ab_tile_body_refusals(scene):
    """launch() names what it takes: the schedules and kernels, K5's
    tile_rows and modes, K6's tiles, a stack in range, no guard for K5,
    and no stack or guard of its own on CPU tensors."""
    from rodent_tpu_torch.experiments import ab_tile_body as ab
    _, tdev = scene
    org, d = _batch("random")
    comps = tapi.components(tapi.make_rays(org, d, 0.0, 1e30))
    for kw, match in (({"schedule": "v2"}, "takes"),
                      ({"kernel": "K7"}, "takes"),
                      ({"size": 3}, "tile_rows=3"),
                      ({"mode": "wide"}, "mode"),
                      ({"ablate": ("nosort",)}, "no ablation"),
                      ({"max_iters": 10}, "no iteration guard"),
                      ({"stack_cap": 0}, "stack_cap=0"),
                      ({"stack_cap": 257}, "stack_cap=257"),
                      ({"kernel": "K6", "size": 300}, "tile_rays=300"),
                      ({"kernel": "K6", "size": 256, "mode": "frustum"},
                       "no mode"),
                      ({"kernel": "K6", "size": 256, "stack_cap": 129},
                       "stack_cap=129"),
                      ({"kernel": "K6", "size": 256, "max_iters": -1},
                       "max_iters"),
                      ({"stack_cap": 8}, "need CUDA tensors"),
                      ({"kernel": "K6", "size": 256, "max_iters": 8},
                       "need CUDA tensors")):
        args = {"kernel": "K5", "schedule": "warp", "size": 2, **kw}
        with pytest.raises(ValueError, match=match):
            ab.launch(tdev, comps, **args)


def _synthetic(ms_v1, ms_warp, k1_ms, bound):
    res = {"regs": 96, "smem_static": 1024, "smem_dynamic": 2048,
           "local": 0, "blocks": 1, "threads": 512}
    return {"k1_ms": k1_ms, "ms": {"v1": ms_v1, "warp": ms_warp},
            "bound": (bound, "operations"),
            "stats": {"mean": 88.5, "max": 120},
            "subset": (65536, 32),
            "resources": {"v1": dict(res, regs=64), "warp": res}}


def test_ab_tile_body_report():
    """The A/B's report on a synthetic result: per configuration both
    schedules' times, shares of the bound, ratios to K1 and resources, and
    warp over v1."""
    from rodent_tpu_torch.experiments import ab_tile_body as ab
    head = ab.line("hall", "primary", "K5", 16, "plain",
                   _synthetic(1.6, 0.8, 0.4, 0.2))
    assert head.startswith("hall primary K5 rows 16: K1 0.4000 ms")
    assert "v1 1.6000 ms (12.5% of the bound, 4.00x K1; 64 regs" in head
    assert "warp 0.8000 ms (25.0% of the bound, 2.00x K1; 96 regs" in head
    assert "1024+2048 B shared, 0 B local, 1 blocks of 512/SM" in head
    assert "warp/v1 0.5000; bound 0.2000 ms (operations)" in head
    assert "65536 rays in 32 tiles == plain" in head
    assert ab.line("hall", "ao", "K6", 2048, "plain", _synthetic(
        2.0, 1.0, 0.5, 0.1)).startswith("hall ao K6 tile 2048: K1 0.5000")
    assert ab.label("K5", 16, "frustum") == "K5 rows 16 frustum"
    assert ab.configs("powerplant", "primary") == [
        ("K5", 2, "plain"), ("K5", 2, "frustum"), ("K5", 16, "plain"),
        ("K5", 16, "frustum")]
    hall = ab.configs("hall", "primary")
    assert ("K5", 16, "nopure") in hall and len(hall) == 12
    assert len(ab.configs("hall", "ao")) == 11


def test_rounds_order():
    """common.rounds times its calls in turns, in order and then in
    reverse (A, B, C, C, B, A), and in_turns is its case of two."""
    from rodent_tpu_torch.experiments import common
    calls = []

    def fn(name):
        def f():
            calls.append(name)
            return name
        return f
    ms, res = common.rounds([fn("a"), fn("b"), fn("c")],
                            torch.device("cpu"), blocks=1)
    assert calls == ["a", "b", "c", "c", "b", "a"]
    assert res == ["a", "b", "c"] and len(ms) == 3
    calls.clear()
    _, _, ra, rb = common.in_turns(fn("x"), fn("y"), torch.device("cpu"),
                                   blocks=2)
    assert calls == ["x", "x", "y", "y", "y", "y", "x", "x"]
    assert (ra, rb) == ("x", "y")
