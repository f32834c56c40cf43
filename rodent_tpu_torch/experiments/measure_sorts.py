"""The sort-key shootout for incoherent rays on K5 (port of
experiments/measure_sorts.py).

With the octant + origin-Morton key a tile of bounce rays pops about the
whole tree (the union of its rays' nodes). The candidate keys add
direction bits, so that a tile is a narrow cone from a compact origin
region; key_fn() builds each (the JAX file's keys, the same uint32 bit
arithmetic on numpy arrays), and KEYS lists the ones raced, in the JAX
file's order. The rays are hall-260K's ao or bounce rays from the hit
points of its unsorted primaries (testscenes.hall_secondary_rays, tmin
1e-3), each key's order timed through K5 at each of `--rows` with its
pops per tile (mean and largest).

`--iters` of the JAX file becomes `--blocks`.

Usage: python -m rodent_tpu_torch.experiments.measure_sorts
    [--dist bounces|ao] [--rows 8,16,32] [--keys oct+org15+dir,...]
    [--blocks 5] [--cpu --tris 20000 --side 64]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..accel import build_bvh
from ..core.math import FLT_MAX
from ..traversal import api, packet
from ..utils import testscenes
from . import common

KEYS = ("oct+org15+dir", "oct+org", "oct+dir9+org", "org9+oct+dir",
        "org12+oct+dir", "org15+oct+dir", "org18+oct")
ALL_KEYS = KEYS + ("oct+dir6+org", "oct+dir12+org")
ROWS = (8, 16, 32)


def morton10(x):
    """Spreads 10 bits to every third bit (uint32, as sorting._morton10)."""
    x = np.asarray(x).astype(np.uint32) & np.uint32(0x3FF)
    x = (x | (x << np.uint32(16))) & np.uint32(0x030000FF)
    x = (x | (x << np.uint32(8))) & np.uint32(0x0300F00F)
    x = (x | (x << np.uint32(4))) & np.uint32(0x030C30C3)
    x = (x | (x << np.uint32(2))) & np.uint32(0x09249249)
    return x


def qmorton(p, lo, hi, bits):
    """The top `bits` of a 30-bit Morton code of points p (n, 3) quantised
    to 1,024 cells per axis over [lo, hi] (measure_sorts.py:63-70: the
    offsets in numpy, the scaling in float32)."""
    q = []
    for i in range(3):
        tq = (p[:, i] - lo[i]) / max(hi[i] - lo[i], 1e-30)
        tq = np.asarray(tq).astype(np.float32) * np.float32(1024.0)
        q.append(np.clip(tq, np.float32(0), np.float32(1023))
                 .astype(np.uint32))
    m = morton10(q[0]) | (morton10(q[1]) << np.uint32(1)) | (
        morton10(q[2]) << np.uint32(2))
    return (m >> np.uint32(30 - bits)) & np.uint32((1 << bits) - 1)


def octant(d):
    """Direction-sign octant (uint32), as sorting.ray_octant."""
    d = np.asarray(d)
    return ((d[:, 0] > 0).astype(np.uint32)
            | ((d[:, 1] > 0).astype(np.uint32) << np.uint32(1))
            | ((d[:, 2] > 0).astype(np.uint32) << np.uint32(2)))


def key_fn(name, o, d, lo, hi):
    """The uint32 key `name` of rays with origins o and directions d
    ((n, 3) float32 numpy) in a scene box [lo, hi]
    (measure_sorts.py:72-94)."""
    u = np.uint32
    oct_ = octant(d)
    om = qmorton(o, lo, hi, 30)
    dm = qmorton(d, np.array([-1.0, -1, -1]), np.array([1.0, 1, 1]), 30)
    keys = {
        "oct+org": lambda: (oct_ << u(28)) | (om >> u(2)),
        "oct+dir6+org": lambda: ((oct_ << u(28)) | ((dm >> u(24)) << u(22))
                                 | (om >> u(8))),
        "oct+dir9+org": lambda: ((oct_ << u(28)) | ((dm >> u(21)) << u(19))
                                 | (om >> u(11))),
        "oct+dir12+org": lambda: ((oct_ << u(28)) | ((dm >> u(18)) << u(16))
                                  | (om >> u(14))),
        "org9+oct+dir": lambda: (((om >> u(21)) << u(22)) | (oct_ << u(19))
                                 | (dm >> u(11))),
        "org12+oct+dir": lambda: (((om >> u(18)) << u(19)) | (oct_ << u(16))
                                  | (dm >> u(14))),
        "org15+oct+dir": lambda: (((om >> u(15)) << u(16)) | (oct_ << u(13))
                                  | (dm >> u(17))),
        "oct+org15+dir": lambda: ((oct_ << u(29)) | ((om >> u(15)) << u(14))
                                  | (dm >> u(16))),
        "org18+oct": lambda: ((om >> u(12)) << u(3)) | oct_,
    }
    if name not in keys:
        raise ValueError(f"unknown key {name!r}; choose from {ALL_KEYS}")
    return keys[name]()


def secondary(kind, verts, idx, dev, side, device):
    """(o2, d2, tmax2) numpy arrays: hall's `kind` rays from the hit points
    of its unsorted primaries traced by K1, the face normal turned toward
    the ray (measure_sorts.py:52-61)."""
    org, dirs = testscenes.hall_primary_rays(side, side)
    hit = packet.traverse_packet(dev, api.make_rays(org, dirs, 0.0, FLT_MAX,
                                                    device=device))
    t = hit["t"].cpu().numpy()
    pid = hit["prim_id"].cpu().numpy()
    t = np.where(pid >= 0, t, 1.0)
    hp = org + dirs * t[:, None]
    i4 = idx.reshape(-1, 4)
    tri = np.maximum(pid, 0)
    v0, v1, v2 = verts[i4[tri, 0]], verts[i4[tri, 1]], verts[i4[tri, 2]]
    fnrm = np.cross(v0 - v1, v2 - v0)
    fnrm = np.where((fnrm * dirs).sum(1, keepdims=True) > 0, -fnrm, fnrm)
    return testscenes.hall_secondary_rays(kind, hp, fnrm)


def run(device, dist="bounces", rows=ROWS, keys=KEYS, blocks=5, tris=None,
        side=1024):
    """{(key, tile_rows): {"ms", "mrays", "k5" (common.tile_stats)}}."""
    verts, idx = testscenes.make_hall(tris or common.SIZES["hall"])
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, **common.TRI8),
                            device)
    lo, hi = verts.min(0), verts.max(0)
    o2, d2, tmax2 = secondary(dist, verts, idx, dev, side, device)
    n = len(o2)
    base = api.make_rays(o2, d2, np.full(n, 1e-3, np.float32), tmax2,
                         device=device)
    any_hit = dist == "ao"
    print(f"hall-{len(idx) // 4000}K {dist}: {n} rays, "
          f"{'any' if any_hit else 'closest'}-hit", flush=True)
    res, first = {}, True
    for name in keys:
        perm = torch.from_numpy(np.argsort(key_fn(name, o2, d2, lo, hi),
                                           kind="stable")).to(device)
        comps = api.components({k: v[perm] for k, v in base.items()})
        for r in rows:
            def k5(comps=comps, r=r):
                return packet.traverse_packet_components(
                    dev, *comps, any_hit=any_hit, tile_rows=r)
            ms, _ = common.timed(k5, device, blocks,
                                 warmup_s=common.WARMUP_S if first else 0.0)
            first = False
            st = common.tile_stats(common.counted_tile(dev, comps, any_hit,
                                                       tile_rows=r),
                                   128 * r, n)
            res[(name, r)] = {"ms": ms, "mrays": n / ms / 1e3, "k5": st}
            print(f"{name:>14} rows {r:>2}: {n / ms / 1e3:9.2f} Mrays/s "
                  f"({ms:.4f} ms), {st['mean']:.1f} pops per tile (max "
                  f"{st['max']})", flush=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="measure_sorts")
    p.add_argument("--tris", type=int, default=None,
                   help="hall's size (default 260,000)")
    p.add_argument("--rows", default=",".join(map(str, ROWS)))
    p.add_argument("--dist", default="bounces", choices=("bounces", "ao"))
    p.add_argument("--keys", default=",".join(KEYS))
    p.add_argument("--side", type=int, default=1024)
    common.add_args(p)
    args = p.parse_args(argv)
    rows = [int(r) for r in args.rows.split(",")]
    keys = args.keys.split(",")
    if any(r not in api.TILE_ROWS for r in rows):
        p.error(f"--rows {args.rows}: each one of {api.TILE_ROWS}")
    if any(k not in ALL_KEYS for k in keys):
        p.error(f"--keys {args.keys}: each one of {ALL_KEYS}")
    device = common.device_of(args, "measure_sorts")
    print(f"card: {common.card(device)}", flush=True)
    run(device, args.dist, rows, keys, args.blocks, args.tris, args.side)
    return 0


if __name__ == "__main__":
    sys.exit(main())
