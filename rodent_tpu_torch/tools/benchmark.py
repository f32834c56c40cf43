"""benchmark: the multi-config sweep harness (port of
rodent_tpu/tools/benchmark.py, the reference's benchmarks/benchmark.py
role).

Runs scene x ray distribution x kernel variant and prints one line per
config, `scene : distribution : variant : N Mrays (avg A, min B, max C,
n=I; K intersections)`, on the procedural scene fixtures (sponza-class
hall, crown-class, powerplant-class). Variants:

  packet     K1, the traversal kernel (csrc/bvh_traverse.cu)
  hbm, giga  K2, K1 plus the exact next-pop L2 prefetch (the big-scene
             tiers; on the card one kernel serves both TPU transports)
  hbm-nopf, giga-nopf
             K1 again: the no-prefetch A/B rows of the big-scene tiers

The TPU's dual-queue engine (tiled, tiled-c) is not ported (ROADMAP A10)
and is refused. A sample is CUDA events around 3 back-to-back calls on
pre-split ray components (the kernel and its wrapper), the row the median
of --iters samples; with --cpu the plain torch version runs on the CPU,
one call per sample on the host clock. Without --cpu the tool needs a
CUDA card.

--mode renderer runs render_iteration_persistent under the port's
select_render_policy on the same scenes at the reference's benchmark
config 1920x1088 / spp 4 / max path length 20 and prints Msamples/s rows.

Usage:
  python -m rodent_tpu_torch.tools.benchmark [--scenes hall,crown,powerplant]
      [--dists primary,ao,bounces] [--variants packet,hbm]
      [--rays 1048576] [--iters 5] [--sizes hall=260000,...]
      [--mode traversal|renderer] [--cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

_SCENES = {
    "hall": ("make_hall", "hall_primary_rays", 260_000),
    "crown": ("make_crown", "crown_primary_rays", 800_000),
    "powerplant": ("make_powerplant", "powerplant_primary_rays",
                   2_000_000),
}
# variant -> traverse_packet's prefetch flag (K2 when True, else K1)
VARIANTS = {"packet": False, "hbm": True, "giga": True,
            "hbm-nopf": False, "giga-nopf": False}
# powerplant's big-scene build (bench.py:174-175): Tri24 leaves, cheap
# DP leaves; quality 0 keeps the multi-million-triangle build tractable
_BIG_BVH = {"packet": 24, "quality": 0, "leaf_threshold": 12,
            "leaf_cost": 0.45}
_BVH = {"packet": 8, "leaf_threshold": 12}
# camera + emitter per scene (the *_primary_rays viewpoints)
_RENDER_CAMS = {
    "hall": ((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), 60.0, "inside"),
    "crown": ((4.2, 1.8, 1.2), (-4.2, -1.4, -1.2), 42.0, "above"),
    "powerplant": ((-30.0, 60.0, -30.0), (130.0, -40.0, 130.0), 55.0,
                   "above"),
}


def _variants(text):
    names = text.split(",")
    for v in names:
        if v not in VARIANTS:
            raise argparse.ArgumentTypeError(
                f"variant {v!r}: choose from {', '.join(VARIANTS)} (the "
                "dual-queue tiled variants are not ported, ROADMAP A10)")
    return names


def _sizes(text):
    sizes = {}
    for tok in text.split(","):
        if "=" in tok:
            k, v = tok.split("=")
            sizes[k] = int(v)
    return sizes


def _device(args):
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA card; pass --cpu to time the plain "
                 "version on the CPU")
    return torch.device("cuda")


def _time(fn, device, group=1):
    """(milliseconds per call, last result) of `group` back-to-back calls:
    CUDA events around them on a card (the calls queue on the stream, so
    the host's time to issue one hides behind the previous one), the host
    clock on the CPU."""
    if device.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(group):
            out = fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / group, out
    t0 = time.perf_counter()
    for _ in range(group):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / group, out


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark")
    p.add_argument("--scenes", default="hall,crown,powerplant")
    p.add_argument("--dists", default="primary,ao,bounces")
    p.add_argument("--variants", type=_variants, default="packet,hbm")
    p.add_argument("--rays", type=int, default=1024 * 1024)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--sizes", type=_sizes, default={},
                   help="override scene sizes: hall=100000,crown=500000")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain torch version on the CPU")
    p.add_argument("--mode", choices=("traversal", "renderer"),
                   default="traversal")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1088)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--mpl", type=int, default=20,
                   help="max path length (reference bench.sh uses 20)")
    args = p.parse_args(argv)
    device = _device(args)
    if args.mode == "renderer":
        for scene in args.scenes.split(","):
            _render_one(args, device, scene)
        return 0
    for scene in args.scenes.split(","):
        _traverse_one(args, device, scene)
    return 0


def _traverse_one(args, device, scene):
    from rodent_tpu.accel import build_bvh
    from rodent_tpu.utils import testscenes
    from ..core.math import FLT_MAX
    from ..traversal import api
    from ..traversal.packet import (traverse_packet,
                                    traverse_packet_components)
    from ..traversal.sorting import sort_rays

    side = int(np.sqrt(args.rays))
    n = side * side
    make_name, rays_name, dflt = _SCENES[scene]
    verts, idx = getattr(testscenes, make_name)(args.sizes.get(scene, dflt))
    bvh = build_bvh(verts, idx, arity=8,
                    **(_BIG_BVH if scene == "powerplant" else _BVH))
    dev = api.bvh_to_device(bvh, device)
    lo, hi = verts.min(0), verts.max(0)
    org, dirs = getattr(testscenes, rays_name)(side, side)
    prim = api.make_rays(org, dirs, 0.0, FLT_MAX, device=device)

    dists = {}
    if "primary" in args.dists:
        dists["primary"] = (prim, False)
    secondary = [(k, ah) for k, ah in (("ao", True), ("bounces", False))
                 if k in args.dists]
    if secondary:
        # hit points for the secondary distributions (ray_gen role)
        hit = traverse_packet(dev, prim)
        t = hit["t"].cpu().numpy()
        pid = hit["prim_id"].cpu().numpy()
        for kind, ah in secondary:
            o2, d2, tmin2, tmax2 = testscenes.secondary_rays_from_trace(
                kind, org, dirs, t, pid, verts, idx.reshape(-1, 4))
            dists[kind] = (api.make_rays(o2, d2, tmin2, tmax2,
                                         device=device), ah)

    group = 3 if device.type == "cuda" else 1
    for dist, (rays, ah) in dists.items():
        comps = api.components(sort_rays(rays, lo, hi)[0])
        for variant in args.variants:
            def fn(v=variant):
                return traverse_packet_components(dev, *comps, any_hit=ah,
                                                  prefetch=VARIANTS[v])
            _, out = _time(fn, device)             # warm-up
            ms = np.asarray([_time(fn, device, group)[0]
                             for _ in range(args.iters)])
            mr = n / ms / 1e3
            hits = int((out["prim_id"] >= 0).sum())
            print(f"{scene} : {dist} : {variant} : "
                  f"{np.median(mr):.2f} Mrays "
                  f"(avg {mr.mean():.2f}, min {mr.min():.2f}, "
                  f"max {mr.max():.2f}, n={args.iters}; "
                  f"{hits} intersections)", flush=True)


def _render_one(args, device, scene_name):
    """Full path-tracer throughput on one benchmark scene (the reference's
    bench.sh renderer rows)."""
    from rodent_tpu.utils import testscenes
    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.compiler import compile_mesh, select_render_policy
    from ..render.integrator import render_iteration_persistent

    w, h, spp = args.width, args.height, args.spp
    make_name, _, dflt = _SCENES[scene_name]
    eye, dirv, fov, emitter = _RENDER_CAMS[scene_name]
    verts, idx = getattr(testscenes, make_name)(
        args.sizes.get(scene_name, dflt))
    scene = compile_mesh(
        verts, idx, device, max_path_len=args.mpl, emitter=emitter,
        bvh_kwargs=_BIG_BVH if scene_name == "powerplant" else None)
    policy = select_render_policy(scene.device)
    cam = Camera.make(eye, dirv, (0, 1, 0), fov, w, h)
    film = film_mod.new_film(w, h, device)
    film = render_iteration_persistent(scene.device, cam, film, w, h, spp,
                                       0, **policy)       # warm-up
    secs = []
    for it in range(1, args.iters + 1):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = render_iteration_persistent(scene.device, cam, film, w, h,
                                           spp, it, **policy)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    ms = np.sort(w * h * spp / np.asarray(secs) / 1e6)
    mean_lum = float(film.mean()) / (args.iters + 1)
    eng = policy.get("packet", True)
    eng = "packet" if eng is True else eng
    print(f"{scene_name} : render({w}x{h} spp{spp} mpl{args.mpl}, "
          f"traversal={eng}) : {ms[len(ms) // 2]:.2f} Msamples/s "
          f"(min {ms[0]:.2f}, max {ms[-1]:.2f}, n={args.iters}; "
          f"mean film {mean_lum:.4f})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
