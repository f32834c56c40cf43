"""The port's headline bench (rodent_tpu_torch.bench) and the measuring
tools' counts on the CPU, against the JAX package: the bench's JSON line
carries bench.py's keys and its hit fraction is the JAX traversal's; the
pops per ray of race_hall_packet and sweep_bigscene_leaf are the Pallas
kernel's counters in interpret mode; the shard table's steps, padding and
bytes are the JAX accounting's."""
import json
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rodent_tpu.accel import build_bvh
from rodent_tpu.parallel import accounting as jacc
from rodent_tpu.render.camera import Camera as JCamera
from rodent_tpu.render.compiler import compile_mesh as jcompile
from rodent_tpu.traversal import api as japi
from rodent_tpu.traversal.pallas_packet import _call_kernel, pack_rays
from rodent_tpu.utils import testscenes
from rodent_tpu_torch import bench
from rodent_tpu_torch.experiments import (race_hall_packet,
                                          shard_scaling_table,
                                          sweep_bigscene_leaf)
from rodent_tpu_torch.traversal import packet

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)

FLT_MAX = 3.402823466e38
TINY = ["--cpu", "--tris", "2000", "--side", "32", "--big-tris", "20000",
        "--blocks", "1"]
# bench.py:261-267's keys and its detail keys, bench.py's primary rows
# named for the carry-top body (K7, "ct") beside K1's, and its cornell_*
# keys left out
TOP = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL = {"backend", "num_nodes", "num_packets", "primary_pk8_k1_mrays",
          "primary_pk16_k1_mrays", "primary_pk8_ct_mrays",
          "primary_pk16_ct_mrays", "primary_config", "primary_mrays",
          "primary_band", "primary_hit_fraction", "bigscene_transport",
          "bigscene_tris", "bigscene_mrays", "bigscene_band"} | {
    f"{kind}_{key}" for kind in ("ao", "bounces")
    for key in ("packet_mrays", "packet_band", "tiled-c_mrays",
                "tiled-c_band", "mrays", "engine")}


def test_bench_line_on_cpu(tmp_path, capsys):
    """One JSON line with bench.py's keys, the card line, the baseline's
    source and, the reference directory being absent, no cornell_* key and
    a detail["cornell"] naming the path; no kernel launches on the CPU.
    Its primary_hit_fraction and tree sizes equal the JAX package's
    traversal and build_bvh on the same seeded scene, build and rays."""
    absent = str(tmp_path / "absent")
    packet.reset_launches()
    assert bench.main([*TINY, "--reference", absent]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == TOP
    detail = res["detail"]
    assert set(detail) == DETAIL | {"card", "baseline", "cornell"}
    assert (res["metric"], res["unit"]) == ("hall260k_primary_traversal",
                                            "Mrays/s")
    assert detail["backend"] == "cpu"
    assert detail["card"].startswith("cpu: the plain torch version")
    assert "373.1" in detail["baseline"]
    assert absent in detail["cornell"]
    assert detail["bigscene_transport"] == "prefetch"
    assert detail["primary_config"] in ("pk8-K1", "pk16-K1", "pk8-ct",
                                        "pk16-ct")
    assert {detail["ao_engine"], detail["bounces_engine"]} <= {
        "packet", "tiled-c"}
    assert set(packet.launches.values()) == {0}

    verts, idx = testscenes.make_hall(2000)
    pk8 = build_bvh(verts, idx, arity=8, **bench.BUILDS["pk8"])
    assert (detail["num_nodes"], detail["num_packets"]) == (
        pk8.num_nodes, pk8.num_packets)
    name = detail["primary_config"].split("-")[0]
    jdev = japi.bvh_to_device(build_bvh(verts, idx, arity=8,
                                        **bench.BUILDS[name]))
    org, dirs = testscenes.hall_primary_rays(32, 32)
    hit = japi.traverse(jdev, japi.make_rays(
        jnp.asarray(org), jnp.asarray(dirs), jnp.zeros(len(org)),
        jnp.full(len(org), FLT_MAX)))
    want = float(np.mean(np.asarray(hit["prim_id"]) >= 0))
    assert detail["primary_hit_fraction"] == round(want, 4)


def test_bench_reference_and_card(tmp_path, monkeypatch):
    """A reference directory that lacks one of the cornell files raises
    before anything is built; without --cpu and without a card the bench
    exits with an error."""
    ref = tmp_path / "ref"
    (ref / "testing").mkdir(parents=True)
    (ref / "testing" / "cornell_box.obj").write_text("v 0 0 0\n")
    with pytest.raises(FileNotFoundError, match="ref-cornell.png"):
        bench.main([*TINY, "--reference", str(ref)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        bench.main(["--reference", str(tmp_path / "absent")])


def _jax_pops(verts, idx, build, org, dirs):
    """Mean pops and leaf pops per ray of the Pallas kernel's counters in
    interpret mode: each ray fills one 128-ray tile of its own, so the
    tile's shared stack walks that ray's nodes alone."""
    jdev = japi.bvh_to_device(build_bvh(verts, idx, arity=8, **build))
    n = len(org) * 128
    rays = japi.make_rays(jnp.asarray(np.repeat(org, 128, 0)),
                          jnp.asarray(np.repeat(dirs, 128, 0)),
                          jnp.zeros(n, jnp.float32),
                          jnp.full(n, FLT_MAX, jnp.float32))
    packed, nt = pack_rays(rays, 1, 1)
    outs = _call_kernel(jdev, packed, nt, 1, False, True, count_pops=True,
                        multi=1)
    cnt = np.asarray(outs[5]).reshape(nt, 8, 128)
    return cnt[:, 0, 0].mean(), cnt[:, 1, 0].mean()


POPS = re.compile(r"^(pk=\S+(?: lt=\S+)? lc=\S+): .*; pops/ray ([\d.]+), "
                  r"leaf pops/ray ([\d.]+),", re.M)


@pytest.mark.parametrize("tool", ["race_hall_packet", "sweep_bigscene_leaf"])
def test_tool_pops_match_pallas_counters(tool, capsys):
    """The pops and leaf pops per ray that race_hall_packet (hall-2K, Tri8
    and Tri24 leaves) and sweep_bigscene_leaf (powerplant-66K, Tri24,
    binned SAH) print for 16 sorted primaries equal the JAX package's
    count_pops (pallas_packet._kernel in interpret mode) on the same rays
    and build."""
    if tool == "race_hall_packet":
        mod, make, rays = race_hall_packet, testscenes.make_hall, \
            testscenes.hall_primary_rays
        args, tris = ["--packets", "8,24", "--lcs", "0.6"], 2000
        builds = [dict(packet=8, leaf_threshold=12, leaf_cost=0.6),
                  dict(packet=24, leaf_threshold=12, leaf_cost=0.6)]
    else:
        mod, make, rays = sweep_bigscene_leaf, testscenes.make_powerplant, \
            testscenes.powerplant_primary_rays
        args, tris = ["--packets", "24", "--lts", "12", "--lcs", "0.45"], \
            20000
        builds = [dict(packet=24, quality=0, leaf_threshold=12,
                       leaf_cost=0.45)]
    assert mod.main(["--cpu", "--blocks", "1", "--tris", str(tris),
                     "--rays", "16", *args]) == 0
    rows = POPS.findall(capsys.readouterr().out)
    assert len(rows) == len(builds)
    verts, idx = make(tris)
    org, dirs = rays(4, 4)
    for (name, pops, leaf), build in zip(rows, builds):
        want = _jax_pops(verts, idx, build, org, dirs)
        assert (float(pops), float(leaf)) == want, name


def test_shard_table_matches_jax(capsys):
    """shard_scaling_table at 23x15 spp 2 on hall-2K, pool 256 (px 2, 4
    and 8 pad the film by 1, 3 and 7 pixels): the steps
    per strip at px 1/2/4/8 equal the JAX package's measure_shard_steps,
    and every padding and all-reduce figure its shard_plan."""
    w, h, spp, pool = 23, 15, 2, 256
    assert shard_scaling_table.main([
        "--cpu", "--wh", f"{w}x{h}", "--tris", "2000", "--spp", str(spp),
        "--pool", str(pool)]) == 0
    out = capsys.readouterr().out
    verts, idx = testscenes.make_hall(2000)
    jscene = jcompile(verts, idx, max_path_len=20, emitter="inside")
    cam = JCamera.make((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0,
                       w, h)
    for n_px in shard_scaling_table.PX:
        plan = jacc.shard_plan(w, h, spp, n_px)
        steps = jacc.measure_shard_steps(
            jscene.device, cam, w, h, spp, n_px,
            pool=min(pool, plan["pixels_local"] * spp))[0]
        row = (f"{n_px:4d} | {' '.join(str(int(s)) for s in steps):<28} | "
               f"{steps.max() / steps.mean():8.3f} | "
               f"{plan['padded_pixels']:4d} "
               f"({plan['padded_fraction']:.5f}) | "
               f"{plan['collective_bytes_per_device']:6d}")
        assert row in out.splitlines(), (row, out)
    for label, cw, ch, s in ((f"probe {w}x{h}", w, h, spp),
                             ("reference 1920x1088 spp4", 1920, 1088, 4)):
        for n_px, n_sp in shard_scaling_table.MESHES:
            if s % n_sp:
                continue
            plan = jacc.shard_plan(cw, ch, s, n_px, n_sp)
            row = (f"{label:<24} | {n_px:4d} | {n_sp:4d} | "
                   f"{plan['pixels_local']:8d} | "
                   f"{plan['collective_bytes_per_device']:12d} | "
                   f"{plan['padded_fraction']:.6f}")
            assert row in out.splitlines(), (row, out)
