"""bench_interface: the cost of an opaque against a specialized shading
interface (torch port of rodent_tpu/tools/bench_interface.py).

The reference's tools/bench_interface compares texture descriptors whose
border and filter modes are runtime enums (`opaque`) against ones that
partial evaluation folds as constants (`specialized`). Here the
specialized lookup is render.texture.sample_texture with its modes fixed
(repeat, bilinear); the opaque one evaluates every (border, filter) pair
and selects per ray from runtime int tensors. The checksum is the sum of
the lookups; the rate is timed with rodent_tpu_torch.experiments.common's
timer (CUDA events around blocks of calls of about 20 ms on a card; one
call per block on the host clock with --cpu), the median of --bench
blocks.

Usage:
  python -m rodent_tpu_torch.tools.bench_interface [--count N] [--opaque]
      [--bench N] [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..experiments import common


def main(argv=None):
    p = argparse.ArgumentParser(prog="bench_interface")
    p.add_argument("--count", type=int, default=1 << 20)
    p.add_argument("--opaque", action="store_true",
                   help="runtime border/filter enums instead of fixed ones")
    p.add_argument("--bench", type=int, default=8)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (host clock)")
    args = p.parse_args(argv)
    device = common.device_of(args, "bench_interface")
    from ..render import texture as tx

    r = np.random.RandomState(0)
    img = torch.as_tensor(r.rand(256, 256, 3).astype(np.float32),
                          device=device)
    n = args.count
    uv = torch.as_tensor(r.rand(n, 2).astype(np.float32) * 2.0 - 0.5,
                         device=device)

    if args.opaque:
        # runtime enums: every (border, filter) pair evaluated and one
        # selected per ray, what an interface without specialization pays
        border_mode = torch.zeros(n, dtype=torch.int32, device=device)
        filter_mode = torch.ones(n, dtype=torch.int32, device=device)

        def sample():
            outs = [tx.sample_texture(img, uv, border=b, filter=f)
                    for b in (tx.BORDER_CLAMP, tx.BORDER_REPEAT)
                    for f in (tx.FILTER_NEAREST, tx.FILTER_BILINEAR)]
            sel = border_mode * 2 + filter_mode
            out = outs[0]
            for i in range(1, 4):
                out = torch.where((sel == i)[:, None], outs[i], out)
            return out
    else:
        def sample():
            return tx.sample_texture(img, uv, border=tx.BORDER_REPEAT,
                                     filter=tx.FILTER_BILINEAR)

    ms, o = common.timed(sample, device, max(args.bench, 1))
    mode = "opaque" if args.opaque else "specialized"
    print(f"# texture interface {mode}, checksum {float(o.sum()):.3e}")
    print(f"{n * 1e-6 / (ms * 1e-3):.2f} Mlookups/sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
