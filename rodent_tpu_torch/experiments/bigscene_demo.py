"""A San-Miguel-class scene end to end (port of
experiments/bigscene_demo.py): a procedural powerplant of about 5M
triangles built by the native builder and traversed at scale.

Two modes:

  --card  one card: build the scene (binned SAH, Tri8 rows, as the JAX
          file builds it), print its table sizes against the card's L2,
          and time 1M sorted primaries through the big-scene path the
          port's tier rule takes there (K2, the prefetching kernel), K1,
          and the dual-queue engine (traversal/tiled.py) for reference,
          each with its hit fraction;
  --mesh  ray-sharded traversal over a torch.distributed group
          (parallel/mesh.py traverse_sharded, `--ranks` processes spawned
          by mesh.run_group): NCCL with one card per rank where there are
          enough cards, else gloo (every rank on the one card, or on the
          CPU with --cpu), on a smaller scene (400,000 triangles unless
          --tris), its hits bit for bit against one process's.

The JAX file's --tpu is --card here. Its --mesh ran 8 virtual devices of
the host in one process; here each rank is a process.

Usage: python -m rodent_tpu_torch.experiments.bigscene_demo --card
    [--tris 5000000] [--side 1024] [--blocks 3]
  python -m rodent_tpu_torch.experiments.bigscene_demo --mesh [--ranks 4]
    [--engine packet|tiled] [--cpu] [--tris 400000]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..accel import build_bvh
from ..core.math import FLT_MAX
from ..parallel import mesh as pmesh
from ..render.compiler import fast_memory_bytes
from ..traversal import api, packet, tiled
from ..traversal.sorting import sort_rays
from ..utils import testscenes
from . import common

# the JAX file's demo build: binned SAH, Tri8 rows
BUILD = {"packet": 8, "quality": 0}
MESH_TRIS = 400_000


def scene(tris, device, side):
    """(device tables, sorted primaries, summary) of powerplant at `tris`
    triangles."""
    t0 = time.perf_counter()
    verts, idx = testscenes.make_powerplant(tris)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    bvh = build_bvh(verts, idx, arity=8, **BUILD)
    t_build = time.perf_counter() - t0
    dev = api.bvh_to_device(bvh, device)
    org, dirs = testscenes.powerplant_primary_rays(side, side)
    rays = api.make_rays(org, dirs, 0.0, FLT_MAX, device=device)
    rays = sort_rays(rays, verts.min(0), verts.max(0))[0]
    mb = {k: dev[k].numel() * 4 / 1e6 for k in ("nodes", "tris")}
    info = {"tris": len(idx) // 4, "nodes": bvh.num_nodes,
            "packets": bvh.num_packets, "scene_s": t_scene,
            "build_s": t_build, "mb": mb,
            "fast_mb": fast_memory_bytes({"bvh": dev}) / 1e6}
    print(f"scene: {info['tris']} tris ({t_scene:.1f} s), BVH8/Tri8 "
          f"{bvh.num_nodes} nodes, {bvh.num_packets} packets ({t_build:.1f} "
          f"s); tables {mb['nodes']:.1f} + {mb['tris']:.1f} MB against "
          f"{info['fast_mb']:.1f} MB of fast memory", flush=True)
    return dev, rays, info


def run_card(device, tris=5_000_000, side=1024, blocks=3):
    """--card: {"info", engine: {"ms", "mrays", "hit"}} for K2, K1 and the
    dual-queue engine."""
    dev, rays, info = scene(tris, device, side)
    comps = api.components(rays)
    n = comps[4].shape[0]
    engines = {
        "K2 (packet-hbm)": lambda: packet.traverse_packet_components(
            dev, *comps, prefetch=True),
        "K1 (packet)": lambda: packet.traverse_packet_components(dev, *comps),
        "tiled": lambda: tiled.traverse_components(dev, *comps)}
    res, hits = {"info": info}, {}
    first = True
    for name, fn in engines.items():
        ms, hit = common.timed(fn, device, blocks,
                               warmup_s=common.WARMUP_S if first else 0.0)
        first = False
        hits[name] = hit["prim_id"] >= 0
        frac = float(hits[name].float().mean())
        res[name] = {"ms": ms, "mrays": n / ms / 1e3, "hit": frac}
        print(f"[{name}] {info['tris']}-tri primary {n / ms / 1e3:.2f} "
              f"Mrays/s ({ms:.4f} ms), hit fraction {frac:.4f}", flush=True)
    for name, h in hits.items():
        if not torch.equal(h, hits["K1 (packet)"]):
            raise RuntimeError(f"{name}: hit/miss differs from K1's")
    return res


def run_mesh(device, ranks=4, tris=MESH_TRIS, side=1024, engine="packet"):
    """--mesh: traverse_sharded over `ranks` spawned processes against one
    process's traversal with the same engine. Returns {"backend", "ranks",
    "seconds", "equal"}; raises where a hit differs."""
    dev, rays, info = scene(tris, device, side)
    if device.type == "cuda" and torch.cuda.device_count() >= ranks:
        backend, place = "nccl", None
    else:
        backend, place = "gloo", device
    one = (tiled.traverse_tiled(dev, rays) if engine == "tiled"
           else packet.traverse_packet(dev, rays))
    calls = [(pmesh.traverse_sharded, (ranks, 1), (dev, rays),
              {"engine": engine})]
    t0 = time.perf_counter()
    out = pmesh.run_group(pmesh.run_calls, ranks, backend, calls, place)
    wall = time.perf_counter() - t0
    for r, (res,) in enumerate(out):
        for k, v in res["out"].items():
            if not np.array_equal(v, one[k].cpu().numpy()):
                raise RuntimeError(f"rank {r}: {k} of the sharded traversal "
                                   "differs from one process's")
    secs = max(res["seconds"] for (res,) in out)
    print(f"mesh: {ranks} {backend} ranks ({engine}), {rays['tmax'].shape[0]}"
          f" rays ray-sharded in {secs:.3f} s ({wall:.1f} s with the "
          f"spawn); every rank's hits bit for bit equal to one process's",
          flush=True)
    return {"backend": backend, "ranks": ranks, "seconds": secs,
            "equal": True}


def main(argv=None):
    p = argparse.ArgumentParser(prog="bigscene_demo")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--card", action="store_true",
                      help="one card at scale (the JAX file's --tpu)")
    mode.add_argument("--mesh", action="store_true",
                      help="ray-sharded over a torch.distributed group")
    p.add_argument("--tris", type=int, default=None,
                   help="scene size (default 5,000,000; 400,000 with "
                        "--mesh)")
    p.add_argument("--side", type=int, default=1024)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--engine", default="packet",
                   choices=("packet", "tiled"))
    common.add_args(p)
    p.set_defaults(blocks=3)
    args = p.parse_args(argv)
    device = common.device_of(args, "bigscene_demo")
    print(f"card: {common.card(device)}", flush=True)
    if args.mesh:
        run_mesh(device, args.ranks, args.tris or MESH_TRIS, args.side,
                 args.engine)
    else:
        run_card(device, args.tris or 5_000_000, args.side, args.blocks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
