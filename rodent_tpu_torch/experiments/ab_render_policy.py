"""A/B of the persistent renderer's engine policies and pools (port of
experiments/ab_render_policy.py, with experiments/measure_pool_sort.py
folded in as --variants).

Each row renders --iters timed iterations (after an untimed first one) of
render_iteration_persistent on a procedural scene and prints its
Msamples/s (median, min, max over the iterations; host clock around a
synchronised iteration) and the persistent loop's steps per iteration.
The rows are the routing policies of POLICIES (--policies) and the
per-call sort variants of measure_pool_sort.py (--variants: packet or
tiled, without or with the sort of every traversal), each once per pool of
--pools:

  all-packet     the packet engine for every traversal
  bounce-tiled   the pool's traversal on tiled-c5; shadow rays on packet
  both-tiled     pool and shadow traversals on tiled-c5
  split          depth 0 on packet, the bounces on tiled-c5, shadows on
                 packet
  split-sh-t     depth 0 on packet, bounces and shadows on tiled-c5
  all-tiled      tiled-c5 everywhere; -c0/-c3/-c8 other compaction
                 stages, -sb8/-sb16 sequential sub-batches

tiled-cN is the dual-queue engine (traversal/tiled.py) with N compaction
stages. The packet engine is K1, or K2 with --packet hbm (the big-scene
tiers' prefetching kernel, what select_render_policy takes on
powerplant-4.3M).

The film keys every sample by its id and adds a pixel's samples in sample
order, so it must not change in a single bit across policies, pools and
variants: the tool raises where a row's film differs from the first row's.

Scenes: hall (hall-260K), mathall (the same geometry with every BSDF kind
and two textures), crown (crown-800K), powerplant (2M by default;
--tris 5000000 is powerplant-4.3M), with the cameras of tools.benchmark
and the BVH8 build of experiments.common (Tri24 for powerplant, Tri8 for
the rest).

Usage: python -m rodent_tpu_torch.experiments.ab_render_policy
    [--scene hall|mathall|crown|powerplant] [--tris N] [--wh 960x544]
    [--spp 2] [--mpl 20] [--iters 3] [--sort pool|true|false]
    [--retire 1] [--pool N] [--pools N,N,...] [--policies a,b,...]
    [--variants packet,packet+sort,tiled,tiled+sort] [--packet packet|hbm]
    [--cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..render import film as film_mod
from ..render import integrator
from ..render.camera import Camera
from ..render.compiler import compile_mesh
from ..tools.benchmark import _RENDER_CAMS
from ..utils import testscenes
from ..utils.profiling import synchronize
from . import common

POLICIES = {
    "all-packet": dict(packet=True),
    "bounce-tiled": dict(packet=True, bounce_packet=False, compact=5),
    "both-tiled": dict(packet=True, bounce_packet=False,
                       shadow_packet=False, compact=5),
    "split": dict(packet=True, bounce_packet=False, compact=5,
                  depth_split=True),
    "split-sh-t": dict(packet=True, bounce_packet=False,
                       shadow_packet=False, compact=5, depth_split=True),
    "all-tiled": dict(packet=False, compact=5),
    "all-tiled-c0": dict(packet=False, compact=0),
    "all-tiled-c3": dict(packet=False, compact=3),
    "all-tiled-c8": dict(packet=False, compact=8),
    "all-tiled-sb8": dict(packet=False, compact=5, sub=8),
    "all-tiled-sb16": dict(packet=False, compact=5, sub=16),
}
# measure_pool_sort.py:26-27: the engine, and the sort of every traversal
VARIANTS = {
    "packet": dict(packet=True, sort=False),
    "packet+sort": dict(packet=True, sort=True),
    "tiled": dict(packet=False, sort=False),
    "tiled+sort": dict(packet=False, sort=True),
}
SIZES = {"hall": 260_000, "mathall": 260_000, "crown": 800_000,
         "powerplant": 2_000_000}


def load_scene(name, tris, mpl, device):
    """compile_mesh of a procedural scene with its camera's emitter and
    experiments.common's build; returns (scene, (eye, dir, fov))."""
    eye, dirv, fov, emitter = _RENDER_CAMS["hall" if name == "mathall"
                                           else name]
    build = common.build_of(name)
    if name == "mathall":
        verts, idx = testscenes.make_hall(tris, rich_mats=True)
        mats, texs = testscenes.mat_hall_materials()
        scene = compile_mesh(verts, idx, device, max_path_len=mpl,
                             emitter=emitter, bvh_kwargs=build,
                             materials=mats, tex_images=texs)
    else:
        verts, idx = testscenes.SCENES[name][0](tris)
        scene = compile_mesh(verts, idx, device, max_path_len=mpl,
                             emitter=emitter, bvh_kwargs=build)
    return scene, (eye, dirv, fov)


def engine_word(packet, word):
    """A policy's engine with the packet engine named by --packet."""
    return word if packet is True else packet


def rows(args):
    """(row name, render_iteration_persistent's keyword arguments)."""
    pools = ([int(x) for x in args.pools.split(",")] if args.pools
             else [args.pool])
    sort = args.sort if args.sort == "pool" else args.sort == "true"
    word = True if args.packet == "packet" else "hbm"
    out = []
    for table, names, base in (
            (POLICIES, args.policies,
             dict(sort=sort, retire_every=args.retire)),
            (VARIANTS, args.variants, {})):
        for name in filter(None, names.split(",")):
            if name not in table:
                raise SystemExit(f"ab_render_policy: unknown row {name!r}: "
                                 f"choose from {', '.join(table)}")
            for pool in pools:
                kw = dict(base, **table[name])
                for key in ("packet", "bounce_packet", "shadow_packet"):
                    if key in kw:
                        kw[key] = engine_word(kw[key], word)
                if pool:
                    kw["pool"] = pool
                label = name if len(pools) == 1 else (
                    f"{name}-p{pool // 1024}K" if pool % 1024 == 0
                    else f"{name}-p{pool}")
                out.append((label, kw))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="ab_render_policy")
    p.add_argument("--scene", default="hall", choices=tuple(SIZES))
    p.add_argument("--tris", type=int, default=0,
                   help="the scene's target triangles (0: its default)")
    p.add_argument("--wh", default="960x544")
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--mpl", type=int, default=20)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--sort", default="pool",
                   help="the policies' sort: pool, true or false")
    p.add_argument("--retire", type=int, default=1)
    p.add_argument("--pool", type=int, default=0,
                   help="the persistent pool size (0: the renderer's "
                        "default)")
    p.add_argument("--pools", default="",
                   help="comma list of pool sizes: each row runs once per "
                        "pool")
    p.add_argument("--policies", default=",".join(POLICIES))
    p.add_argument("--variants", default="",
                   help="measure_pool_sort.py's rows: "
                        + ",".join(VARIANTS))
    p.add_argument("--packet", choices=("packet", "hbm"), default="packet",
                   help="the packet engine: K1, or K2 (hbm)")
    common.add_args(p)
    args = p.parse_args(argv)
    device = common.device_of(args, "ab_render_policy")
    table = rows(args)
    print(f"card: {common.card(device)}", flush=True)
    w, h = (int(x) for x in args.wh.split("x"))
    scene, (eye, dirv, fov) = load_scene(args.scene,
                                         args.tris or SIZES[args.scene],
                                         args.mpl, device)
    cam = Camera.make(eye, dirv, (0, 1, 0), fov, w, h)
    print(f"scene={args.scene} tris={scene.mesh.num_tris} {w}x{h} "
          f"spp{args.spp} mpl{args.mpl} sort={args.sort} "
          f"retire={args.retire} packet={args.packet}", flush=True)

    ref = None
    for name, kw in table:
        def step(film, it, kw=kw):
            return integrator.render_iteration_persistent(
                scene.device, cam, film, w, h, args.spp, it,
                return_steps=True, **kw)

        film, _ = step(film_mod.new_film(w, h, device), 0)
        secs, steps = [], []
        for it in range(1, args.iters + 1):
            synchronize(film)
            t0 = time.perf_counter()
            film, st = step(film, it)
            synchronize(film)
            secs.append(time.perf_counter() - t0)
            steps.append(st)
        ms = np.sort(w * h * args.spp / np.asarray(secs) / 1e6)
        if ref is None:
            ref, ident = (name, film), "ref"
        elif torch.equal(film, ref[1]):
            ident = "bit-identical"
        else:
            raise RuntimeError(
                f"ab_render_policy: the film of {name} differs from "
                f"{ref[0]}'s (max |diff| "
                f"{float((film - ref[1]).abs().max()):.3e})")
        print(f"{name:>16}: {ms[len(ms) // 2]:.3f} Msamples/s (min "
              f"{ms[0]:.3f} max {ms[-1]:.3f} n={args.iters}) steps "
              f"{','.join(str(s) for s in steps)} [{ident}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
