"""bench_shading: the shading stage alone (torch port of
rodent_tpu/tools/bench_shading.py).

The reference's tools/bench_shading streams synthetic hits on a quad with
a checkerboard texture and 4 materials, toggling `sorted` (the stream
sorted by shader) and `specialized` (one compiled shader per material
against one generic shader). Here shading is masked evaluation over the
material kinds (render.bsdf) on flat (B,) tensors, so the toggles are:
  --sorted     material ids sorted (coherent gathers) against shuffled
  --mono       every ray material 0 (the bound that per-material
               specialized shaders reach)
One call samples the BSDF and evaluates it at the sampled direction
(bsdf.sample, bsdf.eval_pdf). The checksum line is the JAX tool's: the sum
of the last output of a chain of 1 + --bench calls, each taking the RNG
state the one before returned. The rate is timed apart from the chain
with rodent_tpu_torch.experiments.common's timer (CUDA events around
blocks of calls of about 20 ms on a card; one call per block on the host
clock with --cpu): the median block of --bench blocks.

Usage:
  python -m rodent_tpu_torch.tools.bench_shading [--count N] [--sorted]
      [--mono] [--materials K] [--bench N] [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..experiments import common


def main(argv=None):
    p = argparse.ArgumentParser(prog="bench_shading")
    p.add_argument("--count", type=int, default=1 << 20)
    p.add_argument("--materials", type=int, default=4)
    p.add_argument("--sorted", action="store_true")
    p.add_argument("--mono", action="store_true",
                   help="all rays share material 0 (specialization bound)")
    p.add_argument("--bench", type=int, default=8)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (host clock)")
    args = p.parse_args(argv)
    device = common.device_of(args, "bench_shading")
    from ..core import vmath as vm
    from ..render import bsdf as bsdf_mod

    n = args.count
    r = np.random.RandomState(0)
    # a synthetic surface batch: random normals, 4 canonical materials
    # (diffuse, phong, mirror, mix) as in the reference's material set
    kinds = [bsdf_mod.DIFFUSE, bsdf_mod.PHONG, bsdf_mod.MIRROR,
             bsdf_mod.MIX][:args.materials]
    mat_id = (np.zeros(n, np.int32) if args.mono
              else r.randint(0, len(kinds), n).astype(np.int32))
    if args.sorted:
        mat_id = np.sort(mat_id)
    kind = np.asarray(kinds, np.int32)[mat_id]

    normal = r.randn(n, 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    out_dir = r.randn(n, 3).astype(np.float32)
    out_dir /= np.linalg.norm(out_dir, axis=1, keepdims=True)
    flip = (np.sum(out_dir * normal, axis=1) < 0)
    out_dir[flip] = -out_dir[flip]

    def col(a, i):
        return torch.as_tensor(np.ascontiguousarray(a[:, i]), device=device)

    nv = tuple(col(normal, i) for i in range(3))
    t_, b_, n_ = vm.onb(nv)
    surf = {"t": t_, "b": b_, "n": n_, "face_normal": nv,
            "is_entering": torch.ones_like(n_[0], dtype=torch.bool)}
    shape = n_[0]
    mat = {
        "kind": torch.as_tensor(kind, device=device),
        "kd": vm.splat((0.6, 0.6, 0.6), like=shape),
        "ks": vm.splat((0.3, 0.3, 0.3), like=shape),
        "ns": torch.full_like(shape, 16.0),
        "ni": torch.full_like(shape, 1.5),
        "tf": vm.splat((0.9, 0.9, 0.9), like=shape),
        "mix_k": torch.full_like(shape, 0.4),
    }
    out = tuple(col(out_dir, i) for i in range(3))

    def shade(rnd):
        in_dir, pdf, cos, color, rnd = bsdf_mod.sample(mat, surf, rnd, out)
        ev, pv = bsdf_mod.eval_pdf(mat, surf, in_dir, out)
        mixed = vm.add(vm.mul(color, ev), vm.splat((1.0, 1.0, 1.0),
                                                    like=pdf))
        return vm.scale(mixed, pdf + cos + pv)[0], rnd

    o, rnd = shade(torch.arange(1, n + 1, dtype=torch.int64, device=device))
    for _ in range(args.bench):
        o, rnd = shade(rnd)
    checksum = float(o.sum())
    ms, _ = common.timed(lambda: shade(rnd), device, max(args.bench, 1))
    mode = ("mono" if args.mono else
            "sorted" if args.sorted else "shuffled")
    print(f"# shading {mode}, {len(kinds)} material(s), "
          f"checksum {checksum:.3e}")
    print(f"{n * 1e-6 / (ms * 1e-3):.2f} Mrays/sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
