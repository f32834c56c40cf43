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
from rodent_tpu_torch.experiments import (ablate_packet, ablate_pair,
                                          attribute_bigscene, cost_model,
                                          measure_packet, measure_pair)
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
