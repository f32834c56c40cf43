"""An independent check of the traversal kernel's times: a per-pop cost
model fitted on one scene and asked to predict others (port of
experiments/cost_model.py, with features that fit the card).

A warp runs as long as its longest ray, so K1's time per ray is modelled
from the pops of each warp's longest rays:

    ns per ray = a * (warp-max node pops) + c * (warp-max leaf pops) + e

(each feature the mean over warps of the largest count in a warp; e the
cost of a ray that pops nothing). The three coefficients are fitted by
least squares on hall-260K across its five distributions (primaries
sorted and in pixel order, ao, bounces sorted and in pixel order), then
used to predict crown-800K and powerplant-4.3M from their counted pops
alone: a count, not a timing. Prediction against measurement on the
held-out scenes is the check; a time far from the model's line is a
finding, about the model or about the kernel. Every scene is built
BVH8/Tri8 (powerplant with quality 0), as the JAX script builds them.

Usage: python -m rodent_tpu_torch.experiments.cost_model
    [--scenes crown,powerplant] [--sizes hall=260000,...] [--rays 1048576]
    [--blocks 5] [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..traversal import packet
from . import common


def _sizes(text):
    return {k: int(v) for k, v in (tok.split("=") for tok in text.split(",")
                                   if "=" in tok)}


def measure(scene, tris, side, device, blocks):
    """[(distribution, features (3,), measured ns per ray)] of one
    scene."""
    build = dict(common.TRI8, quality=0) if scene == "powerplant" \
        else common.TRI8
    verts, idx, dev, secs = common.load(scene, build, device, tris)
    n = side * side
    print(f"{scene}: {len(idx) // 4} tris, {dev['nodes'].shape[0]} BVH8 "
          f"nodes, {dev['tris'].shape[0]} Tri8 rows (built in {secs:.1f} s)"
          f"; {n} rays per distribution", flush=True)
    rows = []
    for name, (comps, any_hit) in common.distributions(
            scene, verts, idx, dev, side, device).items():
        ms, _ = common.timed(lambda: packet.traverse_packet_components(
            dev, *comps, any_hit=any_hit), device, blocks,
            warmup_s=common.WARMUP_S)
        s = common.pop_stats(common.counted(dev, comps, any_hit))
        rows.append((name, np.array([s["warp_node"], s["warp_leaf"], 1.0]),
                     ms * 1e6 / n))
        print(f"  {name:>16}: K1 {ms:9.4f} ms = {ms * 1e6 / n:8.4f} ns/ray; "
              f"warp-max node pops {s['warp_node']:8.3f}, leaf pops "
              f"{s['warp_leaf']:7.3f}; mean pops/ray {s['pops_ray']:.3f}",
              flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(prog="cost_model")
    p.add_argument("--scenes", default="crown,powerplant")
    p.add_argument("--sizes", type=_sizes, default={})
    p.add_argument("--rays", type=int, default=1024 * 1024)
    common.add_args(p)
    args = p.parse_args(argv)
    device = common.device_of(args, "cost_model")
    print(f"card: {common.card(device)}", flush=True)
    side = int(np.sqrt(args.rays))
    cal = measure("hall", args.sizes.get("hall"), side, device, args.blocks)
    x = np.stack([f for _, f, _ in cal])
    y = np.array([t for _, _, t in cal])
    (a, c, e), *_ = np.linalg.lstsq(x, y, rcond=None)
    print(f"fit on hall: ns per ray = {a:.5f} * warp-max node pops + "
          f"{c:.5f} * warp-max leaf pops + {e:.5f}", flush=True)
    for name, f, t in cal:
        pred = float(f @ (a, c, e))
        print(f"  hall {name:>16}: fit {pred:8.4f} vs measured {t:8.4f} "
              f"ns/ray ({pred / t - 1.0:+.1%})", flush=True)
    print("held-out predictions:", flush=True)
    for scene in args.scenes.split(","):
        for name, f, t in measure(scene, args.sizes.get(scene), side,
                                  device, args.blocks):
            pred = float(f @ (a, c, e))
            print(f"  {scene} {name:>16}: predicted {1e3 / pred:9.2f} vs "
                  f"measured {1e3 / t:9.2f} Mrays/s (measured / predicted "
                  f"{pred / t:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
