"""probe_gather's take_along_axis body against another checkout's, in
turns, beside torch.gather.

The other checkout's csrc/probes.cu (for example the parent commit's,
unpacked with `git archive` into a directory that .gitignore lists) is
built with this checkout's nvcc flags into build/ab_gather_take/, and its
rt_probe_gather body 0 is launched on the same tensors as this checkout's
(probe_gather.run_take) and torch.gather, on every case of
probe_gather.take_cases(). Each call is timed as CUDA-graph replays
(common.launch_ms), in turns (other, this, torch.gather, torch.gather,
this, other), and each output is held against the plain version bit for
bit; a difference raises. Each line gives the times, the ratios to
torch.gather and the share of the bytes bound (probe_gather.take_bound).

Usage: python -m rodent_tpu_torch.experiments.ab_gather_take
    --against DIR [--blocks 3]
    python -m rodent_tpu_torch.experiments.ab_gather_take --cpu
--cpu times the plain version against torch.gather on the host clock,
which says nothing of the card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from ..kernels import build
from . import common, probe_gather

BUILD = build.BUILD_DIR.parent / "ab_gather_take"


def other_library(root):
    """The probes library of the checkout at root, built and loaded."""
    csrc = Path(root) / "rodent_tpu_torch" / "csrc"
    if not (csrc / "probes.cu").exists():
        raise FileNotFoundError(f"{csrc / 'probes.cu'}: no probes source")
    return build.load_library(BUILD, "probes", csrc=csrc)


def other_take(lib, tbl, idx, axis):
    """The other library's take_along_axis (rt_probe_gather body 0) on the
    same contiguous card tensors as run_take takes."""
    out = torch.empty_like(tbl)
    rc = lib.rt_probe_gather(0, tbl.data_ptr(), idx.data_ptr(),
                             out.data_ptr(), tbl.shape[0], axis, 0, 0, 1,
                             torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the other rt_probe_gather failed with CUDA "
                           f"error {rc}")
    return out


def measure(device, lib=None, blocks=3):
    """{case: {"other_ms" (with lib), "ms" (this checkout's kernel),
    "library_ms" (torch.gather), "bound"}}; raises where an output
    differs from the plain version's."""
    res = {}
    for name, tbl, idx, axis in probe_gather.take_cases():
        tbl = torch.from_numpy(tbl).to(device)
        idx = torch.from_numpy(idx).to(device)
        idx64 = idx.long()
        fns = [lambda: probe_gather.run_take(tbl, idx, axis),
               lambda: torch.gather(tbl, axis, idx64)]
        if lib is not None:
            fns.insert(0, lambda: other_take(lib, tbl, idx, axis))
        ms, outs = common.rounds(fns, device, blocks,
                                 graphs=device.type == "cuda")
        want = probe_gather.plain_take(tbl, idx, axis)
        for out in outs:
            if not torch.equal(out, want):
                raise RuntimeError(f"{name}: an output differs from the "
                                   "plain version")
        r = {"ms": ms[-2], "library_ms": ms[-1],
             "bound": probe_gather.take_bound(tbl.shape[0])}
        if lib is not None:
            r["other_ms"] = ms[0]
        res[name] = r
    return res


def report(res):
    """A line per case."""
    lines = []
    for name, r in res.items():
        other = ""
        if "other_ms" in r:
            other = (f"other {r['other_ms']:.5f} ms "
                     f"({r['other_ms'] / r['ms']:.2f}x the kernel), ")
        lines.append(
            f"{name}: {other}kernel {r['ms']:.5f} ms, torch.gather "
            f"{r['library_ms']:.5f} ms (kernel / gather "
            f"{r['ms'] / r['library_ms']:.3f}); bound {r['bound'][0]:.4g} ms "
            f"({r['bound'][1]}), {r['bound'][0] / r['ms']:.1%} of it")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(prog="ab_gather_take")
    common.add_args(p)
    p.add_argument("--against", help="the root of the other checkout")
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    device = common.device_of(args, "ab_gather_take")
    if args.against and device.type != "cuda":
        p.error("--against needs the card")
    print(f"card: {common.card(device)}", flush=True)
    lib = other_library(args.against) if args.against else None
    for line in report(measure(device, lib, args.blocks)):
        print(f"  {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
