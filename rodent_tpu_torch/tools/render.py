"""render: the interactive driver analog, headless (torch port of
rodent_tpu/tools/render.py).

CLI of src/driver/driver.cpp:169-232 (--eye/--dir/--up/--fov/--width/
--height/--bench/-o) plus the scene, spp and max path length, which the
reference bakes in at converter time. Progressive accumulation; bench mode
prints "# min/med/max (Msamples/s)" as driver.cpp:341-348 does, the first
iteration left out of the statistics when there is more than one.

It runs on the CUDA card (K1, or K2 for the hbm/giga tiers); --cpu runs the
plain torch version on the CPU. Under --traversal auto the persistent
renderer takes select_render_policy's engine and pool; --no-packet (with
auto) and --traversal tiled take the dual-queue engine
(traversal/tiled.py), --traversal dense the dense engine
(traversal/dense.py), both torch ops on either device.

--sharded renders over a torch.distributed group (parallel.mesh, the
image plane split over all ranks): under torchrun every rank joins the
group from torchrun's variables and drives the card LOCAL_RANK picks (NCCL,
one card per rank); without them the tool starts a group of one rank. The
tool prints the group's size; rank 0 alone prints and writes files. With
--cpu the group runs over gloo on the CPU.

Usage:
  python -m rodent_tpu_torch.tools.render scene.obj --bench 50 \
      --eye 0 1 2.7 --dir 0 0 -1 -o out.png [--cpu]
  torchrun --nproc-per-node N -m rodent_tpu_torch.tools.render scene.obj \
      --sharded ...
"""
from __future__ import annotations

import argparse
import sys
import time

from ..utils.profiling import StageProfiler, synchronize

# --traversal -> the renderers' packet argument (render.py:93-96)
_PACKET = {"tiled": False, "packet": True, "dense": "dense",
           "hybrid": "hybrid", "hybrid-hbm": "hybrid-hbm",
           "hybrid-giga": "hybrid-giga"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="render")
    p.add_argument("scene")
    p.add_argument("--width", type=int, default=1080)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--eye", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    p.add_argument("--dir", type=float, nargs=3, default=(0.0, 0.0, 1.0))
    p.add_argument("--up", type=float, nargs=3, default=(0.0, 1.0, 0.0))
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--bench", type=int, default=1,
                   help="number of progressive iterations")
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--max-path-len", type=int, default=64)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run the plain torch version on the CPU")
    p.add_argument("--sharded", action="store_true",
                   help="render over all ranks of a torch.distributed "
                        "group (image-plane sharding; torchrun, or a "
                        "group of one rank)")
    p.add_argument("--debug", action="store_true",
                   help="eye-light debug renderer (make_debug_renderer, "
                        "renderer.impala:42-60): no NEE/bounces, spp 1")
    p.add_argument("--no-packet", action="store_true",
                   help="with --traversal auto: the dual-queue engine "
                        "(traversal/tiled.py) for every traversal")
    p.add_argument("--progressive", action="store_true",
                   help="full-width progressive wavefront instead of the "
                        "persistent regeneration pool (the same film)")
    p.add_argument("--profile", action="store_true",
                   help="per-stage wall-time report at exit (the "
                        "reference's cpu_profile percentages, "
                        "mapping_cpu.impala:453-472)")
    p.add_argument("--sort", choices=("auto", "on", "off", "pool"),
                   default="auto",
                   help="re-sort the wavefront every bounce before "
                        "traversal (mapping_cpu.impala:409); auto sorts "
                        "scenes of more than 16K triangles")
    p.add_argument("--traversal", choices=("auto", "tiled", "packet",
                                           "dense", "hybrid", "hybrid-hbm",
                                           "hybrid-giga"),
                   default="auto",
                   help="engine policy: packet (K1) for everything, "
                        "hybrid-hbm/hybrid-giga (K2) for everything, "
                        "tiled (the dual-queue engine) or dense (the "
                        "dense engine) for everything, or auto: the "
                        "scene's tier and select_render_policy")
    return p.parse_args(argv)


def run(argv=None):
    """Renders as main does and returns the film ((H*W, 3) tensor of
    per-iteration means summed over the iterations)."""
    args = parse_args(argv)
    from ..experiments import common
    device = common.device_of(args, "render")
    started, mesh, lead = False, None, True
    if args.sharded and not args.debug:
        import torch.distributed as dist
        from ..parallel import mesh as pmesh
        started = pmesh.init_group(cpu=args.cpu)
        mesh = pmesh.make_mesh(device="cpu" if args.cpu else None)
        device = mesh.device
        lead = dist.get_rank() == 0
    say = print if lead else (lambda *a: None)
    if mesh is not None:
        say(f"# sharded over {dist.get_world_size()} rank(s) "
            f"({dist.get_backend()}), this one on {device}")
    from ..io import png
    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.compiler import (compile_obj, select_packet,
                                   select_render_policy)
    from ..render.integrator import (render_debug, render_iteration,
                                     render_iteration_persistent)

    scene = compile_obj(args.scene, device, max_path_len=args.max_path_len)
    # the persistent renderer takes the whole policy (engine, pool, sort,
    # retirement) under --traversal auto; explicit flags and the
    # progressive/debug renderers take the single-engine knob
    policy = None
    if args.traversal == "auto":
        if args.no_packet:
            packet = False
        else:
            policy = dict(select_render_policy(scene.device))
            packet = select_packet(scene.device)
    else:
        packet = _PACKET[args.traversal]
    num_tris = scene.device["tri_geo"].shape[0]
    sort = ("pool" if args.sort == "pool" else
            (args.sort == "on"
             or (args.sort == "auto" and num_tris > 16384)))
    if policy is not None and args.sort != "auto":
        policy["sort"] = sort  # an explicit --sort overrides the policy
    w, h = args.width, args.height
    cam = Camera.make(args.eye, args.dir, args.up, args.fov, w, h)
    film = film_mod.new_film(w, h, device)

    if args.debug:
        args.spp = 1

        def step(f, i):
            return render_debug(scene.device, cam, f, w, h, i, packet=packet)
    elif mesh is not None:
        from ..parallel import (render_iteration_persistent_sharded,
                                render_iteration_sharded)
        kw = policy if policy is not None else dict(packet=packet, sort=sort)

        def step(f, i):
            if args.progressive:
                return render_iteration_sharded(
                    scene.device, cam, f, w, h, args.spp, i, mesh,
                    packet=packet, sort=sort)
            return render_iteration_persistent_sharded(
                scene.device, cam, f, w, h, args.spp, i, mesh, **kw)
    elif args.progressive:
        def step(f, i):
            return render_iteration(scene.device, cam, f, w, h, args.spp, i,
                                    packet=packet, sort=sort)
    else:
        kw = policy if policy is not None else dict(packet=packet, sort=sort)

        def step(f, i):
            return render_iteration_persistent(scene.device, cam, f, w, h,
                                               args.spp, i, **kw)

    prof = StageProfiler(enabled=args.profile, unit="Msamples")
    samples_per_iter = w * h * args.spp
    times = []
    for it in range(args.bench):
        t0 = time.perf_counter()
        film = step(film, it)
        synchronize(film)
        dt = time.perf_counter() - t0
        times.append(dt)
        prof.add("compile+render" if it == 0 else "render", dt)
        prof.add_rays(samples_per_iter)

    # leave the first (warm-up) iteration out when there is more than one
    stats = times[1:] if len(times) > 1 else times
    msamples = sorted(samples_per_iter / t * 1e-6 for t in stats)
    say("# {:.2f}/{:.2f}/{:.2f} (min/med/max Msamples/s)".format(
        msamples[0], msamples[len(msamples) // 2], msamples[-1]))

    if args.output and lead:
        t0 = time.perf_counter()
        img = film_mod.tonemap(film, w, h, args.bench)
        prof.add("tonemap", time.perf_counter() - t0)
        t0 = time.perf_counter()
        png.write_png(args.output, img)
        prof.add("io", time.perf_counter() - t0)
        print(f"wrote {args.output}")
    if args.profile:
        say(prof.report())
    if started:
        import torch.distributed as dist
        dist.destroy_process_group()
    return film


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
