"""The port's tools on the CPU (--cpu: the plain traversal; a card runs the
kernels): rodent_tpu_torch.tools.benchmark, traversal and renderer modes,
and rodent_tpu_torch.tools.bench_traversal on a .bvh/.rays pair written
with the shared rodent_tpu.io.formats."""
import re

import numpy as np
import pytest
import torch

from rodent_tpu.accel import build_bvh
from rodent_tpu.io import formats
from rodent_tpu.utils import testscenes
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


def test_benchmark_refusals(monkeypatch):
    """The dual-queue variants are refused by argparse (ROADMAP A10), and
    without --cpu the tool needs a card."""
    with pytest.raises(SystemExit) as e:
        benchmark.main(["--cpu", "--variants", "packet,tiled"])
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
    traversal; --variant hbm and --sort change neither; -any dumps the
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

    for extra in ((), ("--variant", "hbm"), ("--variant", "giga", "--sort")):
        text, t = run(*extra)
        assert f"{n_hit} intersection(s)" in text
        assert re.search(r"^[\d.]+ Mrays/sec$", text, re.M)
        np.testing.assert_array_equal(t, want_t)
    text, blocked = run("-any")
    np.testing.assert_array_equal(blocked, (want_t < 5000.0).astype(
        np.float32))
