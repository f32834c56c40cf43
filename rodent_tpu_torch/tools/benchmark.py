"""benchmark: the multi-config sweep harness (port of
rodent_tpu/tools/benchmark.py, the reference's benchmarks/benchmark.py
role).

Runs scene x ray distribution x kernel variant and prints one line per
config, `scene : distribution : variant : N Mrays (avg A, min B, max C,
n=I; K intersections)`, on the procedural scene fixtures (sponza-class
hall, crown-class, powerplant-class). Variants:

  packet     K1, the traversal kernel (csrc/bvh_traverse.cu)
  packet-k1  K1 everywhere: the legacy body beside K7 on hall's primaries
  hbm, giga  K2, K1 plus the exact next-pop L2 prefetch (the big-scene
             tiers; on the card one kernel serves both TPU transports)
  hbm-nopf, giga-nopf
             K1 again: the no-prefetch A/B rows of the big-scene tiers

On hall's primaries every packet variant but packet-k1 takes the carry-top
body (csrc/bvh_ct.cu, select "fold", the fused slab), as the JAX tool's
per-distribution config (pcfg, rodent_tpu/tools/benchmark.py:176-184)
gives it to every packet variant there: packet, hbm-nopf and giga-nopf
run K7, hbm and giga K7-PF, K7 with the next-pop prefetch (the JAX
variants' tris_hbm / nodes_hbm with prefetch). Other scenes and
distributions take the kernels above, as the JAX tool gives them no
config.
  tiled      the dual-queue engine (traversal/tiled.py, torch ops)
  tiled-c    the same with staged row compaction (compact_stages=5)

The scenes, their full sizes (powerplant is
powerplant-4.3M), their BVH builds, the ray distributions (sorted) and
the timer are those of rodent_tpu_torch.experiments.common: a sample is
CUDA events around a block of back-to-back calls on pre-split ray
components (the kernel and its wrapper), about 20 ms long, after one
warm-up call; the row is the median of --iters samples. With --cpu the
plain torch version runs on the CPU, one call per sample on the host
clock. Without --cpu the tool needs a CUDA card.

--mode renderer runs render_iteration_persistent under the port's
select_render_policy on the same scenes at the reference's benchmark
config 1920x1088 / spp 4 / max path length 20 and prints Msamples/s rows.

Usage:
  python -m rodent_tpu_torch.tools.benchmark [--scenes hall,crown,powerplant]
      [--dists primary,ao,bounces] [--variants packet,packet-k1,hbm]
      [--rays 1048576] [--iters 5] [--sizes hall=260000,...]
      [--mode traversal|renderer] [--cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# variant -> (engine, option): traverse_packet's prefetch flag (K2 when
# True, else K1; on hall's primaries, where every variant but packet-k1
# takes CT_BODY, K7-PF when True, else K7), or the dual-queue engine's
# compact_stages
VARIANTS = {"packet": ("packet", False), "packet-k1": ("packet", False),
            "hbm": ("packet", True),
            "giga": ("packet", True), "hbm-nopf": ("packet", False),
            "giga-nopf": ("packet", False), "tiled": ("tiled", 0),
            "tiled-c": ("tiled", 5)}
# the carry-top body's arguments (K7), the JAX tool's on hall's primaries
CT_BODY = {"carry_top": True, "select": "fold", "fma_slab": True}
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
                f"variant {v!r}: choose from {', '.join(VARIANTS)}")
    return names


def _sizes(text):
    sizes = {}
    for tok in text.split(","):
        if "=" in tok:
            k, v = tok.split("=")
            sizes[k] = int(v)
    return sizes


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark")
    p.add_argument("--scenes", default="hall,crown,powerplant")
    p.add_argument("--dists", default="primary,ao,bounces")
    p.add_argument("--variants", type=_variants,
                   default="packet,packet-k1,hbm")
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
    from ..experiments import common
    device = common.device_of(args, "benchmark")
    if args.mode == "renderer":
        for scene in args.scenes.split(","):
            _render_one(args, device, scene)
        return 0
    for scene in args.scenes.split(","):
        _traverse_one(args, device, scene)
    return 0


def _traverse_one(args, device, scene):
    from ..experiments import common
    from ..traversal import tiled
    from ..traversal.packet import traverse_packet_components

    side = int(np.sqrt(args.rays))
    n = side * side
    verts, idx, dev, _ = common.load(scene, common.build_of(scene), device,
                                     args.sizes.get(scene))
    kinds = [k for k in ("primary", "ao", "bounces")
             if k in args.dists.split(",")]
    dists = common.distributions(scene, verts, idx, dev, side, device, kinds)
    for dist, (comps, ah) in dists.items():
        for variant in args.variants:
            engine, opt = VARIANTS[variant]
            # the JAX tool's per-distribution config (:176-184): every
            # packet variant on hall's primaries through the carry-top body
            # but packet-k1, the port's own A/B row
            kw = (CT_BODY if engine == "packet" and scene == "hall"
                  and dist == "primary" and variant != "packet-k1" else {})

            def fn(engine=engine, opt=opt, kw=kw):
                if engine == "tiled":
                    return tiled.traverse_components(
                        dev, *comps, any_hit=ah, compact_stages=opt)
                return traverse_packet_components(dev, *comps, any_hit=ah,
                                                  prefetch=opt, **kw)
            ms, out = common.samples(fn, device, args.iters)
            mr = n / np.asarray(ms) / 1e3
            hits = int((out["prim_id"] >= 0).sum())
            print(f"{scene} : {dist} : {variant} : "
                  f"{np.median(mr):.2f} Mrays "
                  f"(avg {mr.mean():.2f}, min {mr.min():.2f}, "
                  f"max {mr.max():.2f}, n={len(ms)}; "
                  f"{hits} intersections)", flush=True)


def _render_one(args, device, scene_name):
    """Full path-tracer throughput on one benchmark scene (the reference's
    bench.sh renderer rows)."""
    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.compiler import compile_mesh, select_render_policy
    from ..render.integrator import render_iteration_persistent
    from ..experiments import common
    from ..utils import testscenes

    w, h, spp = args.width, args.height, args.spp
    eye, dirv, fov, emitter = _RENDER_CAMS[scene_name]
    verts, idx = testscenes.SCENES[scene_name][0](
        args.sizes.get(scene_name, common.SIZES[scene_name]))
    scene = compile_mesh(
        verts, idx, device, max_path_len=args.mpl, emitter=emitter,
        bvh_kwargs=common.TRI24 if scene_name == "powerplant" else None)
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
