"""Dense small-scene traversal (torch port of rodent_tpu/traversal/dense.py):
every Tri packet against every ray, no BVH walk.

For scenes of a few Tri packets (cornell-class quality-gate scenes,
procedural fixtures) a BVH walk is overhead: the whole triangle set is a
handful of rows, so each packet's lanes are tested against every ray with
the sign-trick Moller-Trumbore of the BVH engines (api.mt_lane, the float
operations of pallas_packet._mt_lanes and of tiled.py's leaf unit).

Update rule (dense.py:18-21, :80): strict `t < t_cur`, packets in
ascending order, so the winner is the closest hit; of two equal hits the
first found is kept. A miss keeps t = tmax and ids -1, and a dead slot
(tmax < tmin) never passes the t-window test.

Form taken: vectorised per packet. The JAX engine walks the P x M lanes
one after the other, each lane tested against the running t_cur; a
literal port would issue about 25 torch kernels per lane (3,200 per
traversal at 16 Tri8 packets). Here the M lanes of a packet are one
(B, M) tensor tested against t_cur as the packet begins, and the first
lane holding the minimum is taken where it beats t_cur (as api._leaf_step
does): about 40 kernels per packet. The two forms differ only where a
lane's `tv < t_cur` and `tt <= abs_det * t_cur` round differently for a
t within float ULPs of another lane's, which the tests against the JAX
engine (ids exact) have not met.

any_hit is accepted for the engines' common signature and, as in the JAX
engine, gives the closest hit: its hit/miss answer is the any-hit one.
"""
from __future__ import annotations

import torch

from .api import components, mt_lane

# at 16 Tri8 packets (128 triangles) the dense pass is still far below one
# BVH walk's pop chains on the TPU (dense.py:34-36); the compiler's tier
# rule reads it
DENSE_MAX_PACKETS = 16


def traverse_dense_components(dev, org, dirv, inv_d, inv_o, tmin, tmax,
                              any_hit=False):
    """Flat (B,) components in, {t, u, v, prim_id, geom_id} out (the
    contract of api.traverse_components). inv_d and inv_o are accepted for
    signature parity and unused: there are no box tests."""
    tris = dev["tris"]
    m = tris.shape[1] // 14
    tris_i = tris.view(torch.int32)
    o = [c[:, None] for c in org]
    d = [c[:, None] for c in dirv]
    tmn = tmin[:, None]
    t_cur = tmax.to(torch.float32).clone()
    u = torch.zeros_like(t_cur)
    v = torch.zeros_like(t_cur)
    prim = torch.full(t_cur.shape, -1, dtype=torch.int32,
                      device=t_cur.device)
    geom = torch.full_like(prim, -1)
    for p in range(tris.shape[0]):
        row = tris[p]

        def fld(k):
            return row[k * m:(k + 1) * m][None, :]

        ok, tv, uv, vv = mt_lane(
            [fld(0), fld(1), fld(2)], [fld(3), fld(4), fld(5)],
            [fld(6), fld(7), fld(8)], [fld(9), fld(10), fld(11)],
            o, d, tmn, t_cur[:, None])
        pid = tris_i[p, 12 * m:13 * m]
        best, lane = torch.where(ok & (pid != -1), tv, torch.inf).min(1)
        upd = best < t_cur
        t_cur = torch.where(upd, best, t_cur)
        lane = lane[:, None]
        u = torch.where(upd, uv.gather(1, lane)[:, 0], u)
        v = torch.where(upd, vv.gather(1, lane)[:, 0], v)
        prim = torch.where(upd, pid[lane[:, 0]] & 0x7FFFFFFF, prim)
        geom = torch.where(upd, tris_i[p, 13 * m:14 * m][lane[:, 0]], geom)
    # miss semantics: t == the original tmax (t_cur only moves on hits)
    t_out = torch.where(prim < 0, tmax.to(torch.float32), t_cur)
    return {"t": t_out, "u": u, "v": v, "prim_id": prim, "geom_id": geom}


def traverse_dense(dev, rays, any_hit=False):
    """make_rays dict ((B, 3) org/dir) -> hit dict; the contract of
    api.traverse."""
    return traverse_dense_components(dev, *components(rays),
                                     any_hit=any_hit)


__all__ = ["DENSE_MAX_PACKETS", "traverse_dense_components",
           "traverse_dense"]
