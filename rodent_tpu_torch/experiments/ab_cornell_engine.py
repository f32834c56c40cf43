"""A/B of the persistent renderer's traversal engines on a cornell-class
scene (port of experiments/ab_cornell_engine.py).

Each variant renders one untimed iteration of render_iteration_persistent
and then --iters - 1 timed ones (host clock around them, synchronised),
and prints its ms per iteration, Msamples/s and the persistent loop's
steps per timed iteration. The variants are the JAX program's, with the
same names and keyword arguments (VARIANTS): the dense engine, the
dual-queue engine, the packet engine (K1 on the card) and its
refinements, retire_every=2, pools of 16K and 64K and the pool sort.

The scene is the reference's testing/cornell_box.obj at the size of its
ref-cornell.png, where --reference (default $RODENT_REFERENCE, else
./reference; bench.reference_files) exists. Where it does not, the
stand-in runs: the open box of experiments.common.write_boxes (5 walls and
a ceiling lamp, 12 triangles, open at the front as the cornell box is), at
1080x720. Either is viewed with the reference's camera. Both are the
dense tier (packet_mode "dense"), whose select_render_policy is one of the
variants; the program names it.

The film keys every sample by its id and adds a pixel's samples in sample
order, so it does not depend on the engine, the pool, retire_every or the
sort: the program raises where a variant's film differs from the first
variant's in a single bit, and a variant that fails raises.

Usage: python -m rodent_tpu_torch.experiments.ab_cornell_engine
    [--reference DIR] [--wh WxH] [--spp 4] [--iters 8] [--mpl 64]
    [--variants "dense,tiled,packet,..."] [--cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from .. import bench
from ..io import png
from ..render import film as film_mod
from ..render import integrator
from ..render.camera import Camera
from ..render.compiler import compile_obj, packet_mode, select_render_policy
from ..traversal import packet
from ..utils.profiling import synchronize
from . import common

# ab_cornell_engine.py:38-46
VARIANTS = {
    "dense": dict(packet="dense"),
    "tiled": dict(packet=False),
    "packet": dict(packet=True),
    "packet+retire2": dict(packet=True, retire_every=2),
    "packet pool16K": dict(packet=True, pool=1 << 14),
    "packet pool64K": dict(packet=True, pool=1 << 16),
    "packet sortpool": dict(packet=True, sort="pool"),
    "packet 64K r2": dict(packet=True, pool=1 << 16, retire_every=2),
}
# the reference's camera (ab_cornell_engine.py:34, measure_splat.py:27):
# eye, direction, up, fov
CORNELL_VIEW = ((0.0, 1.0, 2.7), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), 60.0)
# the stand-in's size: the classic cornell figure's (README.md)
STANDIN_WH = (1080, 720)


def add_scene_args(p):
    """The scene's arguments, which measure_splat shares."""
    p.add_argument("--reference",
                   default=os.environ.get(bench.REFERENCE_ENV, "reference"),
                   help="the reference checkout, whose testing/ holds "
                        "cornell_box.obj and ref-cornell.png (default: "
                        "$RODENT_REFERENCE, else ./reference); where it is "
                        "absent the stand-in box runs")
    p.add_argument("--wh", default=None,
                   help="the image size WxH (default: ref-cornell.png's, "
                        "else 1080x720)")
    p.add_argument("--spp", type=int, default=4)


def parse_wh(text):
    return None if text is None else tuple(int(x) for x in text.split("x"))


def load_scene(reference, device, max_path_len, wh=None):
    """The cornell programs' scene: the reference's cornell_box.obj at its
    ref-cornell.png's size where the directory `reference` exists (raises
    where it exists and lacks one of them), else the stand-in open box at
    STANDIN_WH; wh overrides the size. reference None asks for the
    stand-in. Returns (scene, the reference image (H, W, 3) or None,
    (w, h), a line saying which scene ran)."""
    files = None if reference is None else bench.reference_files(reference)
    if files is None:
        with tempfile.TemporaryDirectory() as d:
            _, open_box = common.write_boxes(d)
            scene = compile_obj(open_box, device, max_path_len=max_path_len)
        why = ("no reference directory given" if reference is None
               else f"the reference directory {reference} is absent")
        w, h = wh or STANDIN_WH
        return scene, None, (w, h), (
            f"scene: the stand-in, experiments.common's open box "
            f"({scene.mesh.num_tris} triangles, a ceiling lamp), since "
            f"{why}")
    obj, ref_png = files
    ref = png.read_png(ref_png)[..., :3]
    scene = compile_obj(obj, device, max_path_len=max_path_len)
    h, w = ref.shape[:2]
    w, h = wh or (w, h)
    return scene, ref, (w, h), (
        f"scene: the reference's {obj} ({scene.mesh.num_tris} triangles), "
        f"{ref_png} {ref.shape[1]}x{ref.shape[0]}")


def policy_variant(scene):
    """(select_render_policy's dict for the scene, the name of the variant
    that is that policy, or None)."""
    policy = select_render_policy(scene.device)
    return policy, next((n for n, kw in VARIANTS.items() if kw == policy),
                        None)


def run(device, scene, size, spp, iters, variants=tuple(VARIANTS),
        out=print):
    """Each variant: one untimed iteration, then iters - 1 timed ones.
    Raises where a film differs from the first variant's. Returns (the
    rows: name, kw, ms per iteration, Msamples/s, steps of each timed
    iteration, the kernel launches the variant made; the first film)."""
    w, h = size
    cam = Camera.make(*CORNELL_VIEW, w, h)
    _, policy_name = policy_variant(scene)
    rows, first = [], None
    for name in variants:
        kw = VARIANTS[name]
        before = dict(packet.launches)

        def step(film, it, kw=kw):
            return integrator.render_iteration_persistent(
                scene.device, cam, film, w, h, spp, it, return_steps=True,
                **kw)

        film, _ = step(film_mod.new_film(w, h, device), 0)
        synchronize(film)
        steps = []
        t0 = time.perf_counter()
        for it in range(1, iters):
            film, st = step(film, it)
            steps.append(st)
        synchronize(film)
        dt = (time.perf_counter() - t0) / (iters - 1)
        launched = {k: packet.launches[k] - before[k] for k in before}
        if first is None:
            first, ident = (name, film), "ref"
        elif torch.equal(film, first[1]):
            ident = "bit-identical"
        else:
            raise RuntimeError(
                f"ab_cornell_engine: the film of {name} differs from "
                f"{first[0]}'s (max |diff| "
                f"{float((film - first[1]).abs().max()):.3e})")
        row = {"name": name, "kw": kw, "ms": dt * 1e3,
               "msamples": w * h * spp / dt / 1e6, "steps": steps,
               "launches": launched}
        rows.append(row)
        out(f"{name:16s} {row['ms']:9.1f} ms/iter ({row['msamples']:7.3f} "
            f"Msamples/s) steps {','.join(map(str, steps))} K1 launches "
            f"{launched['bvh_traverse']} [{ident}]"
            + (" <- select_render_policy" if name == policy_name else ""))
    return rows, first[1]


def main(argv=None):
    p = argparse.ArgumentParser(prog="ab_cornell_engine")
    add_scene_args(p)
    p.add_argument("--iters", type=int, default=8,
                   help="iterations per variant, the first one untimed")
    p.add_argument("--mpl", type=int, default=64)
    p.add_argument("--variants", default=",".join(VARIANTS),
                   help="comma list of " + ",".join(VARIANTS))
    common.add_args(p)
    args = p.parse_args(argv)
    names = [n for n in args.variants.split(",") if n]
    bad = [n for n in names if n not in VARIANTS]
    if bad or not names:
        raise SystemExit(f"ab_cornell_engine: unknown variants {bad}: "
                         f"choose from {', '.join(VARIANTS)}")
    if args.iters < 2:
        raise SystemExit("ab_cornell_engine: --iters must be at least 2 "
                         "(the first iteration is untimed)")
    device = common.device_of(args, "ab_cornell_engine")
    scene, _, size, line = load_scene(args.reference, device, args.mpl,
                                      parse_wh(args.wh))
    print(line, flush=True)
    print(f"card: {common.card(device)}", flush=True)
    policy, policy_name = policy_variant(scene)
    print(f"cornell {size[0]}x{size[1]} spp{args.spp} mpl{args.mpl} iters "
          f"{args.iters}: packet_mode {packet_mode(scene.device)}, "
          f"select_render_policy {policy} = {policy_name or 'no variant'}",
          flush=True)
    run(device, scene, size, args.spp, args.iters, names,
        out=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
