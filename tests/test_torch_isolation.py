"""The port stands alone: no jax and nothing of the JAX package behind it,
no kernel launch on the CPU, no silent fallback when the CUDA toolchain is
missing."""
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import rodent_tpu_torch
from rodent_tpu_torch.accel import build_bvh
from rodent_tpu_torch.kernels import build
from rodent_tpu_torch.traversal import api, packet, pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    """Every rodent_tpu_torch module and chip_smoke import without jax,
    without any module of the JAX package rodent_tpu (whose host code the
    port keeps its own copy of) and without experiments/, and importing
    them loads no kernel library, so no micro-probe runs at import
    (checked in a fresh interpreter: the test process itself has both
    packages loaded)."""
    names = [m.name for m in pkgutil.walk_packages(
        rodent_tpu_torch.__path__, "rodent_tpu_torch.")]
    for name in ("traversal.packet", "render.integrator", "render.compiler",
                 "tools.benchmark", "tools.bench_traversal", "accel.builder",
                 "accel.layout", "io.formats", "io.obj", "io.png", "native",
                 "utils.testscenes", "experiments.common",
                 "experiments.ablate_packet", "experiments.measure_packet",
                 "experiments.cost_model", "experiments.attribute_bigscene",
                 "traversal.pair", "experiments.measure_pair",
                 "experiments.ablate_pair", "experiments.probe_mosaic",
                 "experiments.probe_mosaic2", "experiments.probe_gather",
                 "experiments.probe_mosaic3", "experiments.probe_chain",
                 "experiments.probe_body", "experiments.probe_dyn_cost",
                 "experiments.vpu_dtype_bench", "io.jpg", "render.texture",
                 "render.light", "utils.profiling", "tools.render",
                 "tools.converter", "tools.ray_gen", "tools.bvh_extractor",
                 "tools.fbuf2png", "traversal.dense", "traversal.tiled",
                 "tools.quality_gate", "tools.view", "parallel",
                 "parallel.mesh", "parallel.accounting",
                 "tools.bench_shading", "tools.bench_interface",
                 "tools.bench_ref", "utils.checkpoint", "bench",
                 "experiments.ab_render_policy",
                 "experiments.profile_renderer",
                 "experiments.race_hall_packet",
                 "experiments.sweep_bigscene_leaf",
                 "experiments.bigscene_12m",
                 "experiments.shard_scaling_table",
                 "experiments.sass_audit", "experiments.attribute_crown",
                 "experiments.ab_crown_build",
                 "experiments.probe_crown_sort",
                 "experiments.measure_sorts",
                 "experiments.waterfall_tiled",
                 "experiments.measure_tiled_iters",
                 "experiments.sweep_arity_tiled",
                 "experiments.probe_sb_depth",
                 "experiments.bigscene_demo",
                 "experiments.make_goldens",
                 "experiments.ab_gather_take",
                 "experiments.measure_ct",
                 "experiments.sass_compare",
                 "experiments.ab_cornell_engine",
                 "experiments.measure_splat"):
        assert f"rodent_tpu_torch.{name}" in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'rodent_tpu', 'experiments'))\n"
            "assert not bad, bad\n"
            "from rodent_tpu_torch.kernels import build\n"
            "assert not build._libs, build._libs\n"
            "print('clean')\n")
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_bench_ref_loads_no_torch():
    """tools.bench_ref, the independent anchor, runs on numpy and ctypes
    alone: importing it loads neither torch nor jax."""
    code = ("import sys\n"
            "import rodent_tpu_torch.tools.bench_ref\n"
            "import rodent_tpu_torch.native\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('torch', 'jax', 'jaxlib', 'rodent_tpu'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_cpu_traversal_never_launches_the_kernel():
    r = np.random.RandomState(0)
    verts = r.randn(300, 3).astype(np.float32)
    idx = np.concatenate([r.randint(0, 300, (100, 3)),
                          np.zeros((100, 1), int)], 1).astype(np.int32)
    dev = api.bvh_to_device(build_bvh(verts, idx.reshape(-1)), "cpu")
    rays = api.make_rays(r.randn(64, 3), r.randn(64, 3), 0.0, 1e30)
    packet.reset_launches()
    hit = packet.traverse_packet(dev, rays)
    packet.traverse_packet(dev, rays, any_hit=True)
    for kw in (dict(prefetch=True), dict(count_pops=True),
               *packet.OPTION_ARGS.values()):
        for any_hit in (False, True):
            if any_hit and kw.get("ablate") == ("nosort",):
                continue
            packet.traverse_packet(dev, rays, any_hit=any_hit, **kw)
    for kw in ({}, {"frustum": True}, {"ablate": ("nopure",)}):
        packet.traverse_packet(dev, rays, tile_rows=1, count_pops=True, **kw)
    dev8 = api.bvh_to_device(build_bvh(verts, idx.reshape(-1), arity=8,
                                       packet=8), "cpu")
    pair.traverse_pair(dev8, rays, tile_rays=128, count_pops=True)
    for select in ("fold", "sort"):
        for any_hit in (False, True):
            packet.traverse_packet(dev8, rays, any_hit=any_hit,
                                   count_pops=True, carry_top=True,
                                   select=select, fma_slab=select == "fold")
            packet.traverse_packet(dev8, rays, any_hit=any_hit,
                                   carry_top=True, prefetch=True,
                                   select=select)
    assert packet.launches == {"bvh_traverse": 0,
                               "bvh_traverse_prefetch": 0,
                               "bvh_traverse_count": 0,
                               "bvh_traverse_option": 0,
                               "bvh_traverse_tile": 0,
                               "bvh_traverse_pair": 0,
                               "bvh_traverse_ct": 0,
                               "bvh_traverse_ct_prefetch": 0}
    assert hit["t"].device.type == "cpu"


def test_kernel_library_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load_library(build_dir=tmp_path)
    assert not any(tmp_path.iterdir())


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where torch sees
    no card, and when it stands alone without the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run(["chip_smoke.py"], REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
