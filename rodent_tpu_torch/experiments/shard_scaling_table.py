"""The multi-device scaling table (port of
experiments/shard_scaling_table.py): the quantities that set a sharded
render's scaling, without timing one.

(a) measured per-strip persistent-loop step counts at px = 1/2/4/8 on a
    hall render (parallel.accounting.measure_shard_steps: each strip's
    exact call, run strip by strip on one device). A sharded iteration
    waits for its slowest strip, so max/mean is its load-imbalance factor;
(b) padding waste and all-reduce bytes per rank and iteration
    (parallel.accounting.shard_plan), at the probe geometry and at the
    reference's bench config, 1920x1088 spp 4 (bench.sh:60-85).

Step counts do not depend on the device, so the table runs on either: on
the card unless --cpu is given.

Usage: python -m rodent_tpu_torch.experiments.shard_scaling_table
    [--wh 192x108] [--tris 20000] [--spp 2] [--pool 4096] [--cpu]
"""
from __future__ import annotations

import argparse
import sys

from ..parallel.accounting import measure_shard_steps, shard_plan
from ..render.camera import Camera
from ..render.compiler import compile_mesh
from ..utils import testscenes
from . import common

PX = (1, 2, 4, 8)
MESHES = ((1, 1), (4, 2), (2, 4), (8, 1), (4, 4))       # (n_px, n_sp)


def main(argv=None):
    p = argparse.ArgumentParser(prog="shard_scaling_table")
    p.add_argument("--wh", default="192x108")
    p.add_argument("--tris", type=int, default=20_000)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--pool", type=int, default=4096)
    common.add_args(p)
    args = p.parse_args(argv)
    device = common.device_of(args, "shard_scaling_table")
    print(f"card: {common.card(device)}", flush=True)
    w, h = (int(x) for x in args.wh.split("x"))
    verts, idx = testscenes.make_hall(args.tris)
    scene = compile_mesh(verts, idx, device, max_path_len=20,
                         emitter="inside")
    cam = Camera.make((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0,
                      w, h)
    print(f"scene=hall tris={scene.mesh.num_tris} {w}x{h} spp{args.spp} "
          f"pool={args.pool}", flush=True)

    print("\n# px-axis scaling (n_sp=1): measured per-strip step counts")
    print("n_px | steps/strip | max/mean | padded_px (frac) | psum B/dev")
    for n_px in PX:
        plan = shard_plan(w, h, args.spp, n_px)
        row = measure_shard_steps(
            scene.device, cam, w, h, args.spp, n_px,
            pool=min(args.pool, plan["pixels_local"] * args.spp))[0]
        print(f"{n_px:4d} | {' '.join(str(int(s)) for s in row):<28} | "
              f"{row.max() / row.mean():8.3f} | "
              f"{plan['padded_pixels']:4d} ({plan['padded_fraction']:.5f})"
              f" | {plan['collective_bytes_per_device']:6d}", flush=True)

    print("\n# sp-axis collective volume (analytic, ring all-reduce of the "
          "(local,3) f32 partial film)")
    print("config | n_px | n_sp | local_px | psum B/dev/iter | padded frac")
    for label, cw, ch, spp in ((f"probe {w}x{h}", w, h, args.spp),
                               ("reference 1920x1088 spp4", 1920, 1088, 4)):
        for n_px, n_sp in MESHES:
            if spp % n_sp:
                continue
            plan = shard_plan(cw, ch, spp, n_px, n_sp)
            print(f"{label:<24} | {n_px:4d} | {n_sp:4d} | "
                  f"{plan['pixels_local']:8d} | "
                  f"{plan['collective_bytes_per_device']:12d} | "
                  f"{plan['padded_fraction']:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
