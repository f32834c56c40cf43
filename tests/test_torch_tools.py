"""The port's tools on the CPU (--cpu: the plain traversal; a card runs the
kernels): rodent_tpu_torch.tools.benchmark, traversal and renderer modes,
rodent_tpu_torch.tools.bench_traversal on a .bvh/.rays pair written with
the JAX package's rodent_tpu.io.formats (the port reads them with its own
copy), and the traversal experiments of rodent_tpu_torch.experiments at a
tiny size."""
import re

import numpy as np
import pytest
import torch

from rodent_tpu.accel import build_bvh
from rodent_tpu.io import formats
from rodent_tpu.utils import testscenes
from rodent_tpu_torch.experiments import (ab_render_policy, ablate_packet,
                                          ablate_pair, attribute_bigscene,
                                          bigscene_12m, cost_model,
                                          measure_packet, measure_pair,
                                          profile_renderer,
                                          race_hall_packet,
                                          shard_scaling_table,
                                          sweep_bigscene_leaf)
from rodent_tpu_torch.tools import bench_traversal, benchmark
from rodent_tpu_torch.traversal import api, packet

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)

ROW = re.compile(r"^(\w+) : (\w+) : ([\w-]+) : ([\d.]+) Mrays \(avg "
                 r"[\d.]+, min [\d.]+, max [\d.]+, n=1; (\d+) "
                 r"intersections\)$")


def test_benchmark_traversal_rows(capsys):
    """powerplant-20K (the big-scene Tri24 build), 4096 rays: one
    well-formed row per distribution and variant; the K1 and K2 routes
    (packet, hbm, hbm-nopf) find the same intersections."""
    packet.reset_launches()
    assert benchmark.main([
        "--cpu", "--scenes", "powerplant", "--sizes", "powerplant=20000",
        "--rays", "4096", "--dists", "primary,ao",
        "--variants", "packet,hbm,hbm-nopf", "--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [ROW.match(line) for line in lines]
    assert len(rows) == 6 and all(rows), lines
    for dist in ("primary", "ao"):
        mine = [r for r in rows if r.group(2) == dist]
        assert [r.group(3) for r in mine] == ["packet", "hbm", "hbm-nopf"]
        assert len({r.group(5) for r in mine}) == 1
        assert all(r.group(1) == "powerplant" for r in mine)
        assert 0 < int(mine[0].group(5)) <= 4096
    assert set(packet.launches.values()) == {0}


def test_benchmark_refusals(monkeypatch, capsys):
    """The dual-queue variants, which argparse refused until the engine was
    ported, run: tiled and tiled-c find the packet route's intersections
    on hall-2K's primaries and ao rays; an unknown variant is refused by
    argparse, and without --cpu the tool needs a card."""
    assert benchmark.main([
        "--cpu", "--scenes", "hall", "--sizes", "hall=2000", "--rays",
        "1024", "--dists", "primary,ao", "--variants",
        "packet,tiled,tiled-c", "--iters", "1"]) == 0
    rows = [ROW.match(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 6 and all(rows)
    for dist in ("primary", "ao"):
        mine = [r for r in rows if r.group(2) == dist]
        assert [r.group(3) for r in mine] == ["packet", "tiled", "tiled-c"]
        assert len({r.group(5) for r in mine}) == 1
    assert int(rows[0].group(5)) > 0
    with pytest.raises(SystemExit) as e:
        benchmark.main(["--cpu", "--variants", "packet,tiled-x"])
    assert e.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        benchmark.main(["--scenes", "hall", "--sizes", "hall=2000"])


def test_benchmark_hall_primaries_take_the_carry_top_body(monkeypatch,
                                                          capsys):
    """As the JAX tool does (rodent_tpu/tools/benchmark.py:182-184), the
    packet variant traces hall's primaries through the carry-top body (K7
    on a card), with select "fold" and the fused slab, and its other rays
    through K1; packet-k1 is K1 everywhere. Both find the same
    intersections."""
    from rodent_tpu_torch.traversal import packet as tpacket
    calls = []
    real = tpacket.traverse_packet_components

    def spy(dev, *comps, **kw):
        calls.append(kw)
        return real(dev, *comps, **kw)
    monkeypatch.setattr(tpacket, "traverse_packet_components", spy)
    assert benchmark.main([
        "--cpu", "--scenes", "hall", "--sizes", "hall=2000", "--rays",
        "1024", "--dists", "primary,ao", "--variants", "packet,packet-k1",
        "--iters", "1"]) == 0
    rows = [ROW.match(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [(r.group(2), r.group(3)) for r in rows] == [
        ("primary", "packet"), ("primary", "packet-k1"), ("ao", "packet"),
        ("ao", "packet-k1")]
    assert rows[0].group(5) == rows[1].group(5) != "0"
    ct = {"carry_top": True, "select": "fold", "fma_slab": True}
    # the first call traces the primaries for the ao rays' hit points
    assert [all(c.get(k) == v for k, v in ct.items()) for c in calls] == [
        False, True, False, False, False]


def test_benchmark_hbm_rows_take_the_prefetching_carry_top_body(
        monkeypatch, capsys):
    """As the JAX tool's per-distribution config gives the carry-top body
    to every packet variant on hall's primaries
    (rodent_tpu/tools/benchmark.py:176-184), the hbm and giga rows trace
    them with CT_BODY and the prefetch (K7-PF on a card) and hbm-nopf and
    giga-nopf with CT_BODY without it (K7); on the ao rays the same rows
    take neither body (K2 with the prefetch, K1 without). Every row finds
    the same intersections."""
    from rodent_tpu_torch.traversal import packet as tpacket
    calls = []
    real = tpacket.traverse_packet_components

    def spy(dev, *comps, **kw):
        calls.append(kw)
        return real(dev, *comps, **kw)
    monkeypatch.setattr(tpacket, "traverse_packet_components", spy)
    variants = ["hbm", "giga", "hbm-nopf", "giga-nopf"]
    assert benchmark.main([
        "--cpu", "--scenes", "hall", "--sizes", "hall=2000", "--rays",
        "1024", "--dists", "primary,ao", "--variants", ",".join(variants),
        "--iters", "1"]) == 0
    rows = [ROW.match(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [(r.group(2), r.group(3)) for r in rows] == [
        (d, v) for d in ("primary", "ao") for v in variants]
    for dist in ("primary", "ao"):
        assert len({r.group(5) for r in rows if r.group(2) == dist}) == 1
    # the first call traces the primaries for the ao rays' hit points
    assert "carry_top" not in calls[0] and not calls[0]["prefetch"]
    ct = {"carry_top": True, "select": "fold", "fma_slab": True}
    pf = [True, True, False, False]
    for c, p in zip(calls[1:5], pf):
        assert c == dict(ct, any_hit=False, prefetch=p), c
    for c, p in zip(calls[5:], pf):
        assert c == {"any_hit": True, "prefetch": p}, c
    assert len(calls) == 9


def test_benchmark_renderer_row(capsys):
    """--mode renderer: render_iteration_persistent under the port's
    policy at 16x8 prints one Msamples/s row."""
    assert benchmark.main([
        "--cpu", "--mode", "renderer", "--scenes", "powerplant",
        "--sizes", "powerplant=20000", "--width", "16", "--height", "8",
        "--spp", "1", "--mpl", "4", "--iters", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    assert re.match(r"^powerplant : render\(16x8 spp1 mpl4, traversal="
                    r"packet\) : [\d.]+ Msamples/s \(min [\d.]+, max "
                    r"[\d.]+, n=1; mean film [\d.]+\)$", out[0]), out


def test_bench_traversal(tmp_path, capsys):
    """A BVH8/Tri4 .bvh and 2,048 primary rays of hall-2K: the
    intersection count and the dumped hit distances equal the port's
    traversal; --variant hbm, tiled, tiled-c and --sort change neither;
    -any dumps the
    occlusion mask."""
    verts, idx = testscenes.make_hall(2_000)
    bvh = build_bvh(verts, idx, arity=8)
    bvh_f, rays_f = str(tmp_path / "s.bvh"), str(tmp_path / "r.rays")
    formats.write_bvh(bvh_f, bvh.to_block())
    org, dirs = testscenes.hall_primary_rays(64, 32)
    formats.write_rays(rays_f, org, dirs)
    dev = api.bvh_to_device(bvh, "cpu")
    want = api.traverse(dev, api.make_rays(org, dirs, 0.01, 5000.0))
    want_t = want["t"].numpy()
    n_hit = int((want["prim_id"] >= 0).sum())
    assert n_hit > 1000

    def run(*extra):
        out_f = str(tmp_path / f"t{len(extra)}.fbuf")
        assert bench_traversal.main([
            "-bvh", bvh_f, "-ray", rays_f, "--tmin", "0.01", "--tmax",
            "5000", "--bench", "2", "-o", out_f, "--cpu", *extra]) == 0
        text = capsys.readouterr().out
        return text, formats.read_fbuf(out_f)

    for extra in ((), ("--variant", "hbm"), ("--variant", "giga", "--sort"),
                  ("--variant", "tiled"), ("--variant", "tiled-c",
                                           "--sort")):
        text, t = run(*extra)
        assert f"{n_hit} intersection(s)" in text
        assert re.search(r"^[\d.]+ Mrays/sec$", text, re.M)
        np.testing.assert_array_equal(t, want_t)
    text, blocked = run("-any")
    np.testing.assert_array_equal(blocked, (want_t < 5000.0).astype(
        np.float32))


# script -> (its tiny arguments, lines its output must hold)
EXPERIMENTS = {
    "ablate_packet": (
        ablate_packet, ["--tris", "2000", "--rays", "1024"],
        [r"^ +K3: ", r"^ +nonodetest: .* pops/ray +379\.00 ",
         r"^ +noleaftest: ", r"^ +nosort: ",
         r"^ns per pop, K3 less nonodetest: -?[\d.]+ \(the slab",
         r"^ns per pop, K3 less noleaftest: "]),
    "measure_packet": (
        measure_packet, ["--tris", "2000", "--rays", "1024", "--rows", "1,2"],
        [r"^ +primary +K1 +[\d.]+ ", r"^ +ao +K1 +[\d.]+ ",
         r"^ +bounces +K1 +[\d.]+ ", r"^ +primary +1 +[\d.]+ ",
         r"^ +ao +2 +[\d.]+ +[\d.]+ +[\d.]+ +\d+ ",
         r"^ +bounces +2 +[\d.]+ "]),
    "measure_pair": (
        measure_pair, ["--tris", "2000", "--rays", "1024", "--tiles",
                       "128,256", "--dists", "primary,ao"],
        [r"^ +primary +128 +[\d.]+ +[\d.]+ +[\d.]+ +\d+ ",
         r"^ +ao +256 +[\d.]+ "]),
    "ablate_pair": (
        ablate_pair, ["--tris", "2000", "--rays", "1024", "--tile", "256"],
        [r"^ +baseline: .* ns/pop \(\d+ pops; [\d.]+x K6\)$",
         r"^ +nonode: .*\(4 pops;", r"^ +noleaf,nonode: ",
         r"^ +nostrip: ", r"^ +nosort: "]),
    "cost_model": (
        cost_model, ["--sizes", "hall=2000,crown=2000,powerplant=5000",
                     "--rays", "256", "--scenes", "crown,powerplant"],
        [r"^fit on hall: ns per ray = ", r"^  crown +primary: predicted",
         r"^  powerplant bounces-unsorted: predicted"]),
    "attribute_bigscene": (
        attribute_bigscene, ["--tris", "20000", "--rays", "1024"],
        [r"^counted \(K3\): pops/ray ", r"^ +K1: ", r"^ +K2: ",
         r"^ +pops2: ", r"^ +chain4: ", r"^ +row_loads: "]),
    "ab_render_policy": (
        ab_render_policy, ["--tris", "2000", "--wh", "16x12", "--spp", "1",
                           "--mpl", "4", "--iters", "1", "--pools", "64,192",
                           "--policies", "all-packet,split",
                           "--variants", "tiled+sort"],
        [r"^ +all-packet-p64: [\d.]+ Msamples/s \(min [\d.]+ max [\d.]+ "
         r"n=1\) steps \d+ \[ref\]$",
         r"^ +all-packet-p192: .* \[bit-identical\]$",
         r"^ +split-p64: .* \[bit-identical\]$",
         r"^ +tiled\+sort-p192: .* steps \d+ \[bit-identical\]$"]),
    "profile_renderer": (
        profile_renderer, ["--tiny", "--scene", "mathall"],
        [r"^baseline: ", r"^no-splat: .* calls _splat_planar [1-9]",
         r"^no-gathers: .* calls surface_element [1-9]\d*, "
         r"gather_material [1-9]",
         r"^no-texture-fetch: .* calls _sample_bank [1-9]",
         r"^no-camera-emit\*: .* calls _emit_camera [1-9]",
         r"^no-light-sampling\*: .* calls sample_direct [1-9]\d*, "
         r"emission [1-9]",
         r"^no-bsdf\*: .* calls eval_pdf [1-9]\d*, sample [1-9]",
         r"^no-shadow-trace: .* calls _traverse [1-9]",
         r"^no-traverse-at-all\*: .* calls _traverse [1-9]",
         r"^pool 4K: ", r"^sort-pool\+retire4: ", r"^retire_every 3: "]),
    "race_hall_packet": (
        race_hall_packet, ["--tris", "2000", "--rays", "256", "--packets",
                           "8,24", "--lcs", "0,0.6"],
        [r"^pk=8 lc=def: \d+ BVH8 nodes .* Tri8 rows .*; pops/ray [\d.]+, "
         r"leaf pops/ray [\d.]+, warp-max [\d.]+; hit ",
         r"^pk=24 lc=0.6: .* Tri24 rows ",
         r"^  K1: [\d.]+ ms = [\d.]+ Mrays/s; in turns with pk=8 lc=def ",
         r"^  K7 ct-fold: [\d.]+ ms = [\d.]+ Mrays/s; in turns with this "
         r"build's K1 [\d.]+ ms: [\d.]+x; pops/ray [\d.]+, leaf pops/ray "]),
    "sweep_bigscene_leaf": (
        sweep_bigscene_leaf, ["--tris", "20000", "--rays", "256", "--lts",
                              "12", "--lcs", "0,0.45", "--packets", "24"],
        [r"^pk=24 lt=12 lc=def: .* node pops/ray [\d.]+; built in ",
         r"^pk=24 lt=12 lc=0.45: ",
         r"^  K1: [\d.]+ ms = [\d.]+ Mrays/s; K2: [\d.]+ ms = [\d.]+ "
         r"Mrays/s; K2/K1 [\d.]+$"]),
    "bigscene_12m": (
        bigscene_12m, ["--target", "20000", "--rays", "256"],
        [r"^powerplant: \d+ tris .* Tri24 rows = .* tier hybrid$",
         r"^primary: pops/ray ", r"^ao : hbm : [\d.]+ Mrays \(",
         r"^bounces : packet : [\d.]+ Mrays ",
         r"^bounces : packet/hbm time [\d.]+$"]),
    "shard_scaling_table": (
        shard_scaling_table, ["--wh", "24x16", "--tris", "2000", "--pool",
                              "256"],
        [r"^   8 \| (\d+ ){7}\d+ +\| +[\d.]+ \| ",
         r"^reference 1920x1088 spp4 \|    2 \|    4 \|  1044480 \| "
         r"+18800640 \| "]),
}


@pytest.mark.parametrize("name", list(EXPERIMENTS))
def test_experiment_on_cpu(name, capsys):
    """Each experiment runs the plain version with --cpu at a tiny size,
    says that no number of the run is a card's, prints its rows, and
    launches no kernel; measure_packet --frustum runs the tile route's
    frustum test, which the per-ray route refuses."""
    mod, args, rows = EXPERIMENTS[name]
    packet.reset_launches()
    assert mod.main(["--cpu", "--blocks", "1", *args]) == 0
    out = capsys.readouterr().out
    assert out.startswith("card: cpu: the plain torch version"), out
    for row in rows:
        assert re.search(row, out, re.M), (row, out)
    assert set(packet.launches.values()) == {0}
    if name == "measure_packet":
        assert mod.main(["--cpu", "--blocks", "1", "--tris", "2000",
                         "--rays", "1024", "--dists", "primary", "--rows",
                         "1", "--frustum"]) == 0
        out = capsys.readouterr().out
        assert "K5 frustum=True" in out
        assert re.search(r"^ +primary +1 +[\d.]+ ", out, re.M), out
        with pytest.raises(ValueError, match="frustum.*tile_rows="):
            api.check_options(False, frustum=True)
    if name == "race_hall_packet":
        # the JAX tool's Tri12 runs (K1, K3 and K7 take it); a width that
        # is still not built is refused
        assert mod.main(["--cpu", "--blocks", "1", "--tris", "2000",
                         "--rays", "256", "--packets", "8,12", "--lcs",
                         "0"]) == 0
        out = capsys.readouterr().out
        assert re.search(r"^pk=12 lc=def: \d+ BVH8 nodes .* Tri12 rows ",
                         out, re.M), out
        assert len(re.findall(r"^  K7 ct-fold: ", out, re.M)) == 2, out
        assert set(packet.launches.values()) == {0}
        with pytest.raises(SystemExit):
            mod.main(["--cpu", "--packets", "8,32"])
        assert "--packets 32: K1 and K3 are built for Tri 4/8/12/16/24" in (
            capsys.readouterr().err)
        with pytest.raises(SystemExit):
            mod.main(["--cpu", "--packets", "4"])
        assert "--packets 4: K7 is built for Tri 8/12/16/24" in (
            capsys.readouterr().err)


@pytest.mark.parametrize("name", list(EXPERIMENTS)[6:])
def test_experiment_needs_card(name, monkeypatch):
    """Without --cpu and without a card, each of the measuring tools exits
    with an error before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        EXPERIMENTS[name][0].main(EXPERIMENTS[name][1])


def test_ab_render_policy_raises_on_film_difference(monkeypatch):
    """A spy that perturbs the film of the second row by one part in a
    million: the tool raises, naming both rows."""
    real = ab_render_policy.integrator.render_iteration_persistent
    calls = []

    def spy(*args, **kw):
        film, steps = real(*args, **kw)
        calls.append(kw.get("pool"))
        if kw.get("pool") == 192:
            film = film * (1.0 + 1e-6)
        return film, steps

    monkeypatch.setattr(ab_render_policy.integrator,
                        "render_iteration_persistent", spy)
    with pytest.raises(RuntimeError, match="the film of all-packet-p192 "
                       "differs from all-packet-p64's"):
        ab_render_policy.main([
            "--cpu", "--tris", "2000", "--wh", "16x12", "--spp", "1",
            "--mpl", "4", "--iters", "1", "--pools", "64,192",
            "--policies", "all-packet"])
    assert calls == [64, 64, 192, 192]


def test_profile_renderer_refuses_a_dead_ablation():
    """An ablation whose stand-in the step never calls raises, and the
    module attribute is restored."""
    from rodent_tpu_torch.render import integrator
    real = integrator.render_debug
    with pytest.raises(RuntimeError, match="ablation no-debug: the step "
                       "never called render_debug"):
        profile_renderer.ablated("no-debug", [
            (integrator, "render_debug", lambda *a: None)], lambda: 1.0)
    assert integrator.render_debug is real
    dt, calls = profile_renderer.ablated(
        "live", [(integrator, "render_debug", lambda *a: None)],
        lambda: integrator.render_debug() or 2.0)
    assert (dt, calls) == (2.0, {"render_debug": 1})
