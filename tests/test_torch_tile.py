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
from unittest import mock

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rodent_tpu.accel import build_bvh
from rodent_tpu.traversal import api as japi
from rodent_tpu.traversal.pallas_packet import _call_kernel, pack_rays
from rodent_tpu_torch.traversal import api as tapi
from rodent_tpu_torch.traversal import packet as tpacket
from rodent_tpu_torch.traversal import pair as tpair
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


def _plain_at(route, tdev, comps, any_hit, cap):
    """The plain tile (K5's, tile_rows 1) or pair (K6's, tiles of 128 rays)
    version on a stack of `cap` entries."""
    o, d, inv, _, tmin, tmax = comps
    mod = tapi if route == "tile" else tpair
    with mock.patch.object(mod, "stack_entries", lambda dev: cap):
        if route == "tile":
            return tapi.traverse_tile_components(tdev, o, d, inv, tmin, tmax,
                                                 any_hit=any_hit, tile_rows=1)
        return tpair.traverse_pair_components(tdev, o, d, inv, tmin, tmax,
                                              any_hit=any_hit, tile_rays=128,
                                              count_pops=True)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("route", ["tile", "pair"])
def test_plain_stack_at_its_edge(scene, route, any_hit):
    """The plain tile and pair versions on stacks cut short. At the least
    cap that holds every tile's pushes some tile fills the stack, and rows
    that pop slot cap - 1 and push nothing write the slot's own entry back
    (the pushes' clamped slot): every output equals the full stack's bit
    for bit, pops included. One entry less, some tile's pushes pass the
    cap and the traversal raises. The coherent batch makes such rows in
    the pair version (an entry at cap - 1 with children left, whose popped
    child pushes nothing) and, in any-hit, whose pushes keep slot order,
    in the tile version."""
    _, tdev = scene
    org, d = _batch("coherent")
    comps = tapi.components(tapi.make_rays(org, d, 0.0, _tmax(any_hit)))
    full = tapi.stack_entries(tdev)
    want = _plain_at(route, tdev, comps, any_hit, full)
    cap, got = full, want
    while True:
        try:
            out = _plain_at(route, tdev, comps, any_hit, cap - 1)
        except ValueError as e:
            assert f"stack of {cap - 1} entries overflowed" in str(e)
            break
        cap, got = cap - 1, out
    assert 1 < cap < full
    for key in want:
        assert torch.equal(got[key], want[key]), key


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
    """K5 and K6 are built from csrc/bvh_tile.cu into the one "tile"
    library, for sm_90a with -fmad=false, the resource query among its
    entries; the source holds one schedule (no compile-time switch), no
    other library is built from it, and the A/B has no schedule
    argument."""
    from rodent_tpu_torch.kernels import build
    assert build.LIBRARIES["tile"] == ("bvh_tile.cu", ())
    assert set(build.LIBRARIES) == {"main", "ct", "options", "group",
                                    "tile", "probes"}
    assert set(build._ENTRIES) == set(build.LIBRARIES)
    flags = build._flags("tile")
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert not any(f.startswith("-D") for f in flags)
    assert "rt_bvh_tile_resources" in build._ENTRIES["tile"]
    assert "rt_bvh_traverse_pair" in build._ENTRIES["tile"]
    src = (build.CSRC / "bvh_tile.cu").read_text()
    assert "#if" not in src and "bvh_tile_warp_kernel" in src
    from rodent_tpu_torch.experiments import ab_tile_body
    assert not hasattr(ab_tile_body, "SCHEDULES")
    assert not hasattr(ab_tile_body, "LIBRARY")


@pytest.mark.parametrize("mode", ["plain", "frustum", "nopure"])
def test_ab_tile_body_launch_on_cpu(scene, mode):
    """ab_tile_body.launch on CPU tensors is the plain tile version,
    counters included, and launches nothing."""
    from rodent_tpu_torch.experiments import ab_tile_body
    _, tdev = scene
    org, d = _batch("coherent")
    rays = tapi.make_rays(org, d, 0.0, _tmax(True))
    tpacket.reset_launches()
    got = ab_tile_body.launch(tdev, tapi.components(rays), "K5", True, 2,
                              mode)
    want = tapi.traverse(tdev, rays, any_hit=True, count_pops=True,
                         tile_rows=2, **MODES[mode])
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert set(tpacket.launches.values()) == {0}


def test_tile_launch_keys():
    """K5 and K6 count under their kernels' names in packet.launches, the
    keys ab_tile_body reads, and nowhere else."""
    from rodent_tpu_torch.experiments import ab_tile_body as ab
    assert set(tpacket.launches) == {
        "bvh_traverse", "bvh_traverse_prefetch", "bvh_traverse_count",
        "bvh_traverse_option", "bvh_traverse_tile", "bvh_traverse_pair",
        "bvh_traverse_ct", "bvh_traverse_ct_prefetch"}
    tpacket.reset_launches()
    for i, k in enumerate(ab.KERNELS):
        tpacket.launches[ab.NAMES[k]] = i + 1
    assert [ab.launch_count(k) for k in ab.KERNELS] == [1, 2]
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
        tpacket._launch_tile(tdev, flat, False, 32, "frustum", cap)


def test_ab_tile_body_refusals(scene):
    """launch() names what it takes: the kernels, K5's
    tile_rows and modes, K6's tiles, a stack in range, no guard for K5,
    and no stack or guard of its own on CPU tensors."""
    from rodent_tpu_torch.experiments import ab_tile_body as ab
    _, tdev = scene
    org, d = _batch("random")
    comps = tapi.components(tapi.make_rays(org, d, 0.0, 1e30))
    for kw, match in (({"kernel": "K7"}, "takes"),
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
        args = {"kernel": "K5", "size": 2, **kw}
        with pytest.raises(ValueError, match=match):
            ab.launch(tdev, comps, **args)


def _synthetic(ms, k1_ms, bound):
    return {"k1_ms": k1_ms, "ms": ms, "bound": (bound, "operations"),
            "stats": {"mean": 88.5, "max": 120},
            "subset": (65536, 32),
            "resources": {"regs": 96, "smem_static": 1024,
                          "smem_dynamic": 2048, "local": 0, "blocks": 1,
                          "threads": 512}}


def test_ab_tile_body_report():
    """The A/B's report on a synthetic result: per configuration the
    kernel's time, share of the bound, ratio to K1 and resources."""
    from rodent_tpu_torch.experiments import ab_tile_body as ab
    head = ab.line("hall", "primary", "K5", 16, "plain",
                   _synthetic(0.8, 0.4, 0.2))
    assert head.startswith("hall primary K5 rows 16: K1 0.4000 ms")
    assert "0.8000 ms (25.0% of the bound, 2.00x K1; 96 regs" in head
    assert "1024+2048 B shared, 0 B local, 1 blocks of 512/SM" in head
    assert "bound 0.2000 ms (operations)" in head
    assert "65536 rays in 32 tiles == plain" in head
    assert ab.line("hall", "ao", "K6", 2048, "plain", _synthetic(
        1.0, 0.5, 0.1)).startswith("hall ao K6 tile 2048: K1 0.5000")
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


def _chip_smoke(monkeypatch):
    """chip_smoke.py as a module (its phase 12 pool spawns workers that
    import it by name, so the repository root goes on sys.path)."""
    import os
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def test_phase12_jobs_cover_every_check_once(monkeypatch):
    """The jobs chip_smoke.py phase 12 hands its worker pool
    (tile_jobs(), a pure function) hold each check once: the 52 soup runs
    (K5 at tile_rows 1 and 2 on both soups' random rays and in every mode
    on their coherent rays, K6 with each ablation at 128 and 256 rays on
    the Tri8 soup's random rays; closest-hit and any-hit) and the 8
    check_stops, and the plain-version checks of the 38 configurations of
    ab_tile_body.configs, the 16 that timed_tile_config leaves untimed
    among them."""
    from itertools import product
    from rodent_tpu_torch.experiments import ab_tile_body
    cs = _chip_smoke(monkeypatch)
    jobs = cs.tile_jobs()
    assert len(jobs) == len(set(jobs)) == 98
    assert {j[0] for j in jobs} == {"soup", "subset"}
    soups = [j[1:] for j in jobs if j[0] == "soup"]
    runs = {("run", m, batch, any_hit, "K5", rows, mode)
            for m, (batch, modes), any_hit, rows in product(
                (8, 24), (("random", ("plain",)),
                          ("coherent", tpacket.TILE_MODES)),
                (False, True), (1, 2))
            for mode in modes}
    runs |= {("run", 8, "random", any_hit, "K6", tile, ablate)
             for any_hit, tile, ablate in product(
                 (False, True), (128, 256),
                 [()] + [(a,) for a in tpair.ABLATIONS])}
    stops = {("stops", 8, "random", any_hit, kernel, size, "plain")
             for any_hit, (kernel, size) in product(
                 (False, True), (("K5", 1), ("K5", 2), ("K6", 128),
                                 ("K6", 256)))}
    assert len(runs) == 52 and len(stops) == 8
    assert sorted(soups, key=repr) == sorted(runs | stops, key=repr)
    configs = [(scene, name, *c) for scene, names in (
        ("hall", ("primary", "ao", "bounces")), ("powerplant", ("primary",)))
        for name in names for c in ab_tile_body.configs(scene, name)]
    untimed = [c for c in configs if not cs.timed_tile_config(c[1], c[3])]
    assert (len(configs), len(untimed)) == (38, 16)
    assert sorted(j[1:] for j in jobs if j[0] == "subset") == sorted(configs)


def test_phase12_pool_fails_on_a_difference(monkeypatch):
    """chip_smoke.py phase 12's pool (tile_pool) on the CPU, the plain
    version standing for the kernel: a subset job whose kernel outputs
    equal the plain version's passes, with its rays and tiles; a pool
    with one job whose outputs differ in one value raises, naming the
    output."""
    from rodent_tpu_torch.accel import build_bvh as tbuild_bvh
    from rodent_tpu_torch.experiments import ab_tile_body
    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "TILE_WORKERS", 2)
    verts, idx = cs.random_tri_soup(300, seed=5)
    dev = tapi.bvh_to_device(tbuild_bvh(
        verts, idx, arity=8, packet=8, leaf_threshold=32, leaf_cost=0.2),
        "cpu")
    r = np.random.RandomState(6)
    rays = tapi.make_rays(r.randn(512, 3).astype(np.float32) * 3.0,
                          r.randn(512, 3).astype(np.float32), 0.0, 1e30,
                          device="cpu")
    comps = tapi.components(rays)
    out = ab_tile_body.launch(dev, comps, "K5", False, 1)
    sub, sub_out = ab_tile_body.subset(comps, "K5", 1, out)
    bad = dict(sub_out, prim_id=sub_out["prim_id"].clone())
    bad["prim_id"][3] += 1
    job = ("subset", "soup", "random", "K5", 1, "plain")
    cpu = torch.device("cpu")
    res = cs.tile_pool([job], lambda j: (dev, sub, False, sub_out), cpu,
                       cs.start_pool()[0])
    assert [(x["rays"], x["tiles"]) for x in res] == [(512, 4)]
    data = iter([(dev, sub, False, sub_out), (dev, sub, False, bad)])
    with pytest.raises(RuntimeError, match="prim_id differs on 1 entries"):
        cs.tile_pool([job, job], lambda j: next(data), cpu,
                      cs.start_pool()[0])
