"""Attribution of the persistent renderer's step by ablation (port of
experiments/profile_renderer.py).

Replaces one subsystem at a time with a stand-in and times a whole
render_iteration_persistent iteration for each (host clock around a
synchronised iteration, after one untimed iteration); the deltas against
the baseline attribute the step. Each stand-in replaces the module
attribute that the step looks up at run time:

  no-splat            integrator._splat_planar (the sample buffer writes)
  no-gathers          integrator.surface_element and gather_material, fed
                      tables whose every gather is row 0, broadcast
  no-texture-fetch    integrator._sample_bank (mathall only: its textures)
  no-camera-emit*     integrator._emit_camera (RNG seeding, jitter, rays)
  no-light-sampling*  light.sample_direct and light.emission
  no-bsdf*            bsdf.eval_pdf and bsdf.sample
  no-shadow-trace     integrator._traverse for any-hit rays: unoccluded
  no-traverse-at-all* integrator._traverse: every ray hits prim 0 at t 1

then the pool sweep, the sort off and on the pool, and retire_every.
(* = the stand-in changes path lengths or content; indicative only.) A
stand-in that the step never calls makes the tool raise, so no row times
an ablation that did not happen. The JAX tool's tiles ablation
(core/tiles.py, the TPU's (R,128) layout) has no counterpart.

Scenes: hall (hall-260K, the default) and mathall (the same geometry with
every BSDF kind and two textures), at 480x272 spp 2, max path length
20; hall takes the
single-call policy (select_packet, the sort of every traversal), mathall
select_render_policy, as the JAX tool does. --tiny runs every ablation on
hall-2K or mathall-2K at 16x12 spp 1, max path length 4, with one timed
iteration (the CPU check of every stand-in).

Usage: python -m rodent_tpu_torch.experiments.profile_renderer
    [--scene hall|mathall] [--wh 480x272] [--spp 2] [--iters 3] [--tiny]
    [--cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..core import vmath as vm
from ..core.rng import randf
from ..render import bsdf as bsdf_mod
from ..render import film as film_mod
from ..render import integrator
from ..render import light as light_mod
from ..render.camera import Camera
from ..render.compiler import select_packet, select_render_policy
from ..utils.profiling import synchronize
from . import ab_render_policy, common


class Row0:
    """A table whose every gather returns its row 0, broadcast: the
    gathers' stand-in, which reads no row per ray."""

    def __init__(self, table):
        self.table = table

    def __getitem__(self, idx):
        return self.table[:1].expand(idx.shape[0], *self.table.shape[1:])


def stand_ins():
    """{ablation: [(module, attribute, stand-in)]} in the JAX tool's
    order."""
    real_surface = integrator.surface_element
    real_material = integrator.gather_material
    real_traverse = integrator._traverse

    def no_splat(planes, slot, color, mask):
        pass

    def fake_surface(scene, rays, hit):
        keys = ("tri_shade", "tri_geo", "vtx_geo")
        return real_surface(dict(scene, **{k: Row0(scene[k]) for k in keys
                                           if k in scene}), rays, hit)

    def fake_material(scene, mat_id):
        return real_material(dict(scene, mat_table={
            k: Row0(v) for k, v in scene["mat_table"].items()}), mat_id)

    def fake_bank(scene, tex_id, uv):
        g = uv[0] * 0.0 + 0.5
        return (g, g, g)

    def fake_emit(camera, width, height, sample, iteration, pix):
        like = pix.to(torch.float32)
        return (vm.splat(camera.eye, like=like),
                vm.normalize(vm.splat(camera.dir, like=like)), pix | 1)

    def fake_sample_direct(lights, lidx, rnd, point):
        _, rnd = randf(rnd)    # the real sampler's two draws, so the RNG
        _, rnd = randf(rnd)    # stream (and RR path lengths) match
        one = lidx.to(torch.float32) * 0.0 + 1.0
        out = {"pos": (one,) * 3, "intensity": (one,) * 3, "cos": one,
               "pdf_area": one, "pdf_dir": one, "has_area": lidx >= 0,
               "valid": lidx >= 0}
        if "ke_tex" in lights:
            out["ke_tex"] = torch.full_like(lidx, -1)
            out["uv"] = (one * 0.0, one * 0.0)
        return out, rnd

    def fake_emission(lights, light_id, out_dir):
        zero = light_id.to(torch.float32) * 0.0
        out = {"intensity": (zero,) * 3, "pdf_area": zero + 1.0,
               "pdf_dir": zero + 1.0, "valid": light_id >= 0}
        if "ke_tex" in lights:
            out["ke_tex"] = torch.full_like(light_id, -1)
        return out

    def fake_eval(mat, surf, in_dir, out_dir, kinds=None):
        one = surf["n"][0] * 0.0 + 0.31830987
        return (one, one, one), one

    def fake_sample(mat, surf, rnd, out_dir, kinds=None):
        for _ in range(3):     # the real sampler's three draws
            _, rnd = randf(rnd)
        one = surf["n"][0] * 0.0 + 1.0
        return surf["n"], one, one, (one, one, one), rnd

    def miss(rays):
        shp = rays["tmin"]
        return {"t": rays["tmax"], "u": torch.zeros_like(shp),
                "v": torch.zeros_like(shp),
                "prim_id": torch.full_like(shp, -1, dtype=torch.int32),
                "geom_id": torch.full_like(shp, -1, dtype=torch.int32)}

    def no_shadow_traverse(scene, rays, any_hit=False, **kw):
        if any_hit:
            return miss(rays)
        return real_traverse(scene, rays, any_hit=any_hit, **kw)

    def no_traverse(scene, rays, any_hit=False, **kw):
        shp = rays["tmin"]
        return {"t": torch.ones_like(shp), "u": torch.zeros_like(shp),
                "v": torch.zeros_like(shp),
                "prim_id": torch.zeros_like(shp, dtype=torch.int32),
                "geom_id": torch.zeros_like(shp, dtype=torch.int32)}

    return {
        "no-splat": [(integrator, "_splat_planar", no_splat)],
        "no-gathers": [(integrator, "surface_element", fake_surface),
                       (integrator, "gather_material", fake_material)],
        "no-texture-fetch": [(integrator, "_sample_bank", fake_bank)],
        "no-camera-emit*": [(integrator, "_emit_camera", fake_emit)],
        "no-light-sampling*": [(light_mod, "sample_direct",
                                fake_sample_direct),
                               (light_mod, "emission", fake_emission)],
        "no-bsdf*": [(bsdf_mod, "eval_pdf", fake_eval),
                     (bsdf_mod, "sample", fake_sample)],
        "no-shadow-trace": [(integrator, "_traverse", no_shadow_traverse)],
        "no-traverse-at-all*": [(integrator, "_traverse", no_traverse)],
    }


def ablated(name, patches, run):
    """run() with each (module, attribute) replaced by its stand-in, each
    call counted; raises where the step never called one of them."""
    calls = {attr: 0 for _, attr, _ in patches}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]

    def counting(attr, fn):
        def wrapped(*a, **kw):
            calls[attr] += 1
            return fn(*a, **kw)
        return wrapped

    try:
        for mod, attr, fn in patches:
            setattr(mod, attr, counting(attr, fn))
        dt = run()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    never = [a for a, c in calls.items() if c == 0]
    if never:
        raise RuntimeError(f"profile_renderer: ablation {name}: the step "
                           f"never called {', '.join(never)}")
    return dt, calls


def main(argv=None):
    p = argparse.ArgumentParser(prog="profile_renderer")
    p.add_argument("--scene", choices=("hall", "mathall"), default="hall")
    p.add_argument("--wh", default="480x272")
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--tiny", action="store_true",
                   help="every ablation at 16x12 spp 1 on a 2K-triangle "
                        "scene, one timed iteration")
    common.add_args(p)
    args = p.parse_args(argv)
    device = common.device_of(args, "profile_renderer")
    print(f"card: {common.card(device)}", flush=True)
    if args.tiny:
        args.wh, args.spp, args.iters = "16x12", 1, 1
    w, h = (int(x) for x in args.wh.split("x"))
    scene, (eye, dirv, fov) = ab_render_policy.load_scene(
        args.scene, 2_000 if args.tiny else ab_render_policy.SIZES["hall"],
        4 if args.tiny else 20, device)
    sdev = scene.device
    cam = Camera.make(eye, dirv, (0, 1, 0), fov, w, h)
    if args.scene == "mathall":
        policy = select_render_policy(sdev)
        packet = policy.pop("packet")
        sort = policy.pop("sort", True)
    else:
        packet, sort, policy = select_packet(sdev), True, {}
    total = w * h * args.spp
    if args.tiny and "pool" in policy:
        # the policy's 64K pool would be all dead slots at the tiny size
        policy["pool"] = min(policy["pool"], total)
    print(f"{args.scene} {w}x{h} spp{args.spp} total {total} "
          f"packet={packet} sort={sort} policy={policy}", flush=True)

    def timed(iters=args.iters, **kw):
        kw = {"packet": packet, "sort": sort, **policy, **kw}

        def fn(film):
            return integrator.render_iteration_persistent(
                sdev, cam, film, w, h, args.spp, 1, **kw)
        f = fn(film_mod.new_film(w, h, device))
        synchronize(f)
        t0 = time.perf_counter()
        for _ in range(iters):
            f = fn(f)
        synchronize(f)
        return (time.perf_counter() - t0) / iters

    base = timed()
    print(f"baseline: {base * 1e3:9.2f} ms/iter "
          f"({total / base / 1e6:7.3f} Msamples/s)", flush=True)

    def report(name, dt, extra=""):
        print(f"{name}: {dt * 1e3:9.2f} ms/iter (delta "
              f"{1e3 * (base - dt):8.2f} ms, {100.0 * (base - dt) / base:6.1f}"
              f"% of step){extra}", flush=True)

    for name, patches in stand_ins().items():
        if name == "no-texture-fetch" and "textures" not in sdev:
            continue
        dt, calls = ablated(name, patches, timed)
        report(name, dt, " calls " + ", ".join(
            f"{a} {c}" for a, c in calls.items()))
    print("(* = ablation perturbs path lengths/content; indicative only)",
          flush=True)

    def rate(label, dt):
        print(f"{label}: {dt * 1e3:9.2f} ms/iter "
              f"({total / dt / 1e6:7.3f} Msamples/s)", flush=True)

    iters = min(args.iters, 3)
    for pool in ((1 << 12,) if args.tiny else (1 << 13, 1 << 15, 1 << 17)):
        rate(f"pool {pool >> 10}K", timed(iters, pool=pool))
    if sort:
        for mode, label in ((False, "sort-off"), ("pool", "sort-pool")):
            rate(label, timed(iters, sort=mode))
        for k in (2, 4):
            rate(f"sort-pool+retire{k}", timed(iters, sort="pool",
                                               retire_every=k))
    for k in (2, 3, 4):
        rate(f"retire_every {k}", timed(iters, retire_every=k))
    return 0


if __name__ == "__main__":
    sys.exit(main())
