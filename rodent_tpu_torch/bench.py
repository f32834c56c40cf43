"""The port's headline bench (port of bench.py): primary-ray traversal
throughput on the card and the full metric set, printed as ONE JSON line
with bench.py's keys (metric, value, unit, vs_baseline, detail).

Rows (the scenes, builds, rays and timer of experiments.common):

- primary: hall-260K, 1024x1024 primary rays, octant+Morton sorted,
  closest-hit on two BVH8 builds, Tri8 leaves (leaf_threshold=12, "pk8")
  and Tri16 leaves with cheap DP leaves (leaf_cost=0.6, "pk16"), each
  through two bodies: bench.py's own, the carry-top body with its
  defaults (carry_top=True, select="fold", fma_slab=True), which is K7
  (csrc/bvh_ct.cu), in the rows primary_pk8_ct_mrays and
  primary_pk16_ct_mrays; and the legacy body, K1, in the rows
  primary_pk8_k1_mrays and primary_pk16_k1_mrays. The fastest of the four
  is the headline, and primary_config names its build and body ("pk8-ct",
  "pk16-K1", ...). bench.py's tile_rows=32 and multi=1 are the TPU
  kernel's tile shape, which one ray per thread does not have;
- ao and bounces: rays from the pk8 primaries' hit points
  (testscenes.secondary_rays_from_trace), sorted, through K1 ("packet",
  any-hit for ao) and the dual-queue engine with staged compaction
  ("tiled-c": traversal/tiled.py, compact_stages=5);
- bigscene: powerplant-4.3M (make_powerplant(5_000_000), Tri24, quality 0,
  leaf_threshold=12, leaf_cost=0.45), 1024x1024 sorted primaries through
  K2, the prefetching kernel of the big-scene tiers;
- cornell: the reference's quality gate and renderer rate on its cornell
  box (50 iterations at spp 4 under select_render_policy, MSE against
  testing/ref-cornell.png), where the --reference directory holds it.
  Where that directory is absent the line has no cornell_* key and
  detail["cornell"] says why; a directory that lacks one of the two files
  is an error.

Timing: CUDA events around blocks of back-to-back calls
(experiments.common.samples) after 0.5 s of warm-up; 5 blocks of about
20 ms each for primary and bigscene, 5 blocks of 2 calls for ao and
bounces. A row is the median over the blocks in Mrays/s, its band their
min and max. The cornell rate is the host clock around synchronised
iterations, the first one excluded.

vs_baseline is the headline over 373.1 Mrays/s, the reference's own CUDA
backend on sponza primaries (BASELINE.md:47, results_aila.txt:1, GPU model
not recorded); bench.py divides by a target set for a TPU chip instead.

With --cpu the plain torch versions run on the CPU on the host clock
(with small --tris, --side and --big-tris for a quick run); without --cpu
the bench needs a CUDA card.

Usage: python -m rodent_tpu_torch.bench [--reference DIR]
    [--cpu --tris N --side N --big-tris N]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .accel import build_bvh
from .experiments import common
from .traversal import api, tiled
from .traversal.packet import traverse_packet_components
from .utils import testscenes
from .utils.profiling import synchronize

BASELINE_MRAYS = 373.1
BASELINE = ("373.1 Mrays/s: the reference's own CUDA backend (rodent BVH2) "
            "on sponza primaries, BASELINE.md:47 (results_aila.txt:1); its "
            "GPU model is not recorded")
# bench.py's two primary builds
BUILDS = {"pk8": {"packet": 8, "leaf_threshold": 12},
          "pk16": {"packet": 16, "leaf_threshold": 12, "leaf_cost": 0.6}}
# the primary rows' bodies: bench.py's carry-top body (K7) and the legacy
# body (K1), with traverse_packet's arguments for each
PRIMARY_BODIES = {"ct": {"carry_top": True, "select": "fold",
                         "fma_slab": True},
                  "K1": {}}
REFERENCE_ENV = "RODENT_REFERENCE"
CORNELL_FILES = ("cornell_box.obj", "ref-cornell.png")
# bench.py:233-234: the ctest config
CORNELL_ITERS, CORNELL_SPP = 50, 4


def reference_files(ref_dir):
    """The cornell scene and reference image under ref_dir/testing, or None
    where ref_dir does not exist; raises where it exists and lacks one."""
    if not os.path.isdir(ref_dir):
        return None
    files = tuple(os.path.join(ref_dir, "testing", n) for n in CORNELL_FILES)
    for f in files:
        if not os.path.isfile(f):
            raise FileNotFoundError(f"bench: the reference directory "
                                    f"{ref_dir} has no {f}")
    return files


def rate(fn, n, device, blocks, calls=None):
    """(median, min, max) Mrays/s over the blocks of common.samples, and the
    last result."""
    ms, out = common.samples(fn, device, blocks, warmup_s=common.WARMUP_S,
                             calls=calls)
    mr = np.sort(n / np.asarray(ms) / 1e3)
    return (float(mr[len(mr) // 2]), float(mr[0]), float(mr[-1])), out


def primary_rows(args, device, detail):
    """The primary rows on hall; returns (headline Mrays/s, the pk8 tables,
    the ray distributions of common.distributions, rays per row)."""
    verts, idx = testscenes.make_hall(args.tris)
    devs = {}
    for name, kw in BUILDS.items():
        bvh = build_bvh(verts, idx, arity=8, **kw)
        devs[name] = api.bvh_to_device(bvh, device)
        if name == "pk8":
            detail["num_nodes"] = int(bvh.num_nodes)
            detail["num_packets"] = int(bvh.num_packets)
    n = args.side * args.side
    dists = common.distributions("hall", verts, idx, devs["pk8"], args.side,
                                 device, ("primary", "ao", "bounces"))
    comps = dists["primary"][0]
    best, band, hit = 0.0, None, None
    for name, dev in devs.items():
        for body, kw in PRIMARY_BODIES.items():
            (m, lo, hi), out = rate(
                lambda d=dev, kw=kw: traverse_packet_components(d, *comps,
                                                                **kw),
                n, device, args.blocks)
            detail[f"primary_{name}_{body.lower()}_mrays"] = round(m, 2)
            if m > best:
                best, band, hit = m, (lo, hi), out
                detail["primary_config"] = f"{name}-{body}"
    detail["primary_mrays"] = round(best, 2)
    detail["primary_band"] = [round(band[0], 2), round(band[1], 2)]
    detail["primary_hit_fraction"] = round(float(
        (hit["prim_id"] >= 0).to(torch.float32).mean()), 4)
    return best, devs["pk8"], dists, n


def secondary_rows(args, device, detail, dev, dists, n):
    """ao and bounces through K1 and tiled-c; an engine that fails raises."""
    engines = {
        "packet": lambda c, ah: traverse_packet_components(dev, *c,
                                                           any_hit=ah),
        "tiled-c": lambda c, ah: tiled.traverse_components(
            dev, *c, any_hit=ah, compact_stages=5)}
    for kind in ("ao", "bounces"):
        comps, any_hit = dists[kind]
        best, best_eng = 0.0, None
        for name, eng in engines.items():
            (m, lo, hi), _ = rate(lambda: eng(comps, any_hit), n, device,
                                  args.blocks, calls=2)
            detail[f"{kind}_{name}_mrays"] = round(m, 2)
            detail[f"{kind}_{name}_band"] = [round(lo, 2), round(hi, 2)]
            if m > best:
                best, best_eng = m, name
        detail[f"{kind}_mrays"] = round(best, 2)
        detail[f"{kind}_engine"] = best_eng


def bigscene_row(args, device, detail):
    """powerplant-4.3M's sorted primaries through K2."""
    verts, idx, dev, _ = common.load("powerplant", common.TRI24, device,
                                     args.big_tris)
    comps, _ = common.distributions("powerplant", verts, idx, dev,
                                    args.side, device,
                                    ("primary",))["primary"]
    (m, lo, hi), _ = rate(
        lambda: traverse_packet_components(dev, *comps, prefetch=True),
        args.side * args.side, device, args.blocks)
    detail["bigscene_transport"] = "prefetch"
    detail["bigscene_tris"] = len(idx) // 4
    detail["bigscene_mrays"] = round(m, 2)
    detail["bigscene_band"] = [round(lo, 2), round(hi, 2)]


def cornell_row(files, device, detail):
    """bench.py:221-258: the cornell gate and the renderer's rate."""
    from .io import png
    from .render import film as film_mod
    from .render.camera import Camera
    from .render.compiler import compile_obj, select_render_policy
    from .render.integrator import render_iteration_persistent

    obj, ref_png = files
    ref = png.read_png(ref_png)[..., :3]
    h, w = ref.shape[:2]
    scene = compile_obj(obj, device, max_path_len=64)
    policy = select_render_policy(scene.device)
    cam = Camera.make((0, 1, 2.7), (0, 0, -1), (0, 1, 0), 60.0, w, h)
    film = render_iteration_persistent(scene.device, cam,
                                       film_mod.new_film(w, h, device), w, h,
                                       CORNELL_SPP, 0, **policy)
    synchronize(film)
    t0 = time.perf_counter()
    for it in range(1, CORNELL_ITERS):
        film = render_iteration_persistent(scene.device, cam, film, w, h,
                                           CORNELL_SPP, it, **policy)
    synchronize(film)
    dt = time.perf_counter() - t0
    img = film_mod.tonemap(film, w, h, CORNELL_ITERS)
    detail["cornell_mse_u8"] = round(film_mod.mse_u8(ref, img), 2)
    detail["cornell_msamples"] = round(
        w * h * CORNELL_SPP * (CORNELL_ITERS - 1) / dt / 1e6, 2)
    detail["cornell_iters"] = CORNELL_ITERS


def main(argv=None):
    p = argparse.ArgumentParser(prog="bench")
    p.add_argument("--reference",
                   default=os.environ.get(REFERENCE_ENV, "reference"),
                   help="the reference checkout, whose testing/ holds the "
                        "cornell box (default: $RODENT_REFERENCE, else "
                        "./reference)")
    p.add_argument("--tris", type=int, default=common.SIZES["hall"])
    p.add_argument("--side", type=int, default=1024,
                   help="rays per row: side x side")
    p.add_argument("--big-tris", type=int,
                   default=common.SIZES["powerplant"])
    common.add_args(p)
    args = p.parse_args(argv)
    device = common.device_of(args, "bench")
    files = reference_files(args.reference)
    detail = {"backend": device.type, "card": common.card(device),
              "baseline": BASELINE}
    mrays, dev, dists, n = primary_rows(args, device, detail)
    secondary_rows(args, device, detail, dev, dists, n)
    del dev, dists
    bigscene_row(args, device, detail)
    if files is None:
        detail["cornell"] = (
            f"not run: the reference directory {args.reference} is absent "
            f"(the row needs its testing/{CORNELL_FILES[0]} and "
            f"testing/{CORNELL_FILES[1]})")
    else:
        cornell_row(files, device, detail)
    print(json.dumps({
        "metric": "hall260k_primary_traversal",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
        "detail": detail,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
