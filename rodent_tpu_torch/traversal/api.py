"""BVH device tables and the plain torch traversal (port of
rodent_tpu/traversal/api.py).

Row layout, identical to the JAX package's (api.py:125-154):

  node row (arity A, 7A floats): [xmin*A | xmax*A | ymin*A | ymax*A |
                                  zmin*A | zmax*A | child*A (i32 bits)]
  tri row  (Tri-M, 14M floats):  [v0x..v0z*M | e1x..e1z*M | e2x..e2z*M |
                                  nx..nz*M | prim*M (i32) | geom*M (i32)]

child codes: > 0 inner node (index + 1), < 0 leaf (~packet index), 0 empty.
prim ids carry the last-packet-of-leaf flag in the sign bit of lane M-1.

`traverse_components` is the port's oracle and the plain version of the
CUDA kernel in traversal/packet.py. It follows the kernel's per-ray
semantics exactly, so the two agree hit for hit on the same device:

- one stack per ray; a popped node pushes its hit children sorted
  far-to-near by entry distance (Batcher network, so the nearest child is
  popped next); any-hit pushes them in slot order;
- a leaf runs sign-trick Moller-Trumbore over its M lanes: lanes test
  `t <= t_cur` (t_cur as the pop began) and the best is taken with the
  strict `t < t_cur` rule in ascending lane order, so of two equal hits
  the first one found is kept (pallas_packet.py:384; api.traverse of the
  JAX package keeps the later one, api.py:237,365);
- any-hit ends a ray at the first leaf that hits.

The rays advance in lockstep: each step pops one entry for every ray whose
stack is not empty, and only those rays are touched.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .primitives import empty_hit, make_rays

# Batcher odd-even merge sorting networks (ascending) — copied from
# rodent_tpu/traversal/api.py (src/core/sort.impala batcher_sort); the CUDA
# kernel carries the same pairs
_SORT_NETWORKS = {
    2: [(0, 1)],
    4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)],
    8: [(0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (2, 4), (3, 5),
        (1, 2), (3, 4), (5, 6)],
}


@dataclasses.dataclass(frozen=True)
class BvhMeta:
    """Per-BVH stack sizing, computed on the host by compute_stack_needs.

    shared_stack: worst-case entries of one mixed node/leaf stack with
        every child of every popped node pushed, adversarial pop order.
    node_stack: the same for a node-only stack."""
    shared_stack: int
    node_stack: int


def compute_stack_needs(child):
    """Worst-case traversal stack requirements for a BVH child table
    (copy of rodent_tpu/traversal/api.py:73-114).

    child: (N, A) int32 — >0 inner (index+1), <0 leaf (~packet), 0 empty.
    Returns (shared_need, node_need) with the recurrence
        S(n) = max(1, max_i(S_desc[i] + k - 1 - i))
    over the k pushed children sorted by need descending; leaves need 1
    slot on the shared stack (multi-packet continuations replace in place)
    and 0 on the node stack. One pass per tree level."""
    child = np.asarray(child)
    n, a = child.shape
    inner = child > 0
    leaf = child < 0
    idx = np.where(inner, child - 1, 0)
    NEG = np.int64(-1) << 40
    ar = np.arange(a, dtype=np.int64)[None, :]
    s_val = np.full(n, -1, np.int64)
    n_val = np.full(n, -1, np.int64)
    pend = np.ones(n, bool)
    while pend.any():
        child_s = np.where(inner, s_val[idx], 0)
        ready = pend & ~((inner & (child_s < 0)).any(axis=1))
        if not ready.any():
            raise ValueError("BVH child graph is not a tree")
        slot = np.where(leaf[ready], 1,
                        np.where(inner[ready], child_s[ready], NEG))
        k = (slot > NEG).sum(axis=1)[:, None]
        srt = -np.sort(-slot, axis=1)
        vals = np.where(ar < k, srt + (k - 1 - ar), NEG)
        s_val[ready] = np.maximum(vals.max(axis=1), 1)
        child_nv = np.where(inner, n_val[idx], 0)
        slot_n = np.where(inner[ready], child_nv[ready], NEG)
        kn = inner[ready].sum(axis=1)[:, None]
        srt_n = -np.sort(-slot_n, axis=1)
        vals_n = np.where(ar < kn, srt_n + (kn - 1 - ar), NEG)
        n_val[ready] = np.maximum(vals_n.max(axis=1), 1)
        pend &= ~ready
    return int(s_val[0]), int(n_val[0])


def bvh_tables(bvh):
    """WideBvh -> (nodes (N, 7A) f32, tris (P, 14M) f32) numpy tables."""
    a = bvh.arity
    nn = bvh.num_nodes
    nodes = np.zeros((nn, 7 * a), np.float32)
    nodes[:, 0:6 * a] = bvh.bounds.reshape(nn, 6 * a)
    nodes[:, 6 * a:7 * a] = bvh.child.view(np.float32)
    m = bvh.packet
    np_ = bvh.num_packets
    tris = np.zeros((np_, 14 * m), np.float32)
    # (P, M, 3) -> [x*M | y*M | z*M] per vector
    for i, arr in enumerate((bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, bvh.tri_n)):
        tris[:, i * 3 * m:(i + 1) * 3 * m] = (
            arr.transpose(0, 2, 1).reshape(np_, 3 * m))
    tris[:, 12 * m:13 * m] = bvh.prim_id.view(np.float32)
    tris[:, 13 * m:14 * m] = bvh.geom_id.view(np.float32)
    return nodes, tris


def bvh_to_device(bvh, device):
    """WideBvh (numpy) -> {"nodes", "tris", "meta"} on `device`."""
    nodes, tris = bvh_tables(bvh)
    s_need, n_need = compute_stack_needs(bvh.child)
    return {
        "nodes": torch.from_numpy(nodes).to(device),
        "tris": torch.from_numpy(tris).to(device),
        "meta": BvhMeta(shared_stack=s_need, node_stack=n_need),
    }


def stack_entries(dev):
    """Stack entries a traversal of this BVH needs: the tree's worst case
    plus two spare slots (pallas_packet.py:1556-1563)."""
    return dev["meta"].shared_stack + 2


def _node_step(dev, org, inv_d, tmin, t_cur, code, any_hit):
    """Slab tests of one node row per ray. Returns the children in push
    order (nearest first for closest-hit, slot order for any-hit) with
    their hit mask: (children (n, A) i32, hit (n, A) bool)."""
    nodes = dev["nodes"]
    a = nodes.shape[1] // 7
    row = nodes[code - 1]
    children = row[:, 6 * a:7 * a].view(torch.int32)
    # (bound - org) * inv_dir: inv_dir is finite (safe_rcp), so this form
    # can overflow to +-inf but never produce inf - inf = NaN
    ts = [(row[:, k * a:(k + 1) * a] - org[k // 2][:, None])
          * inv_d[k // 2][:, None] for k in range(6)]
    entry = torch.maximum(
        torch.maximum(torch.minimum(ts[0], ts[1]),
                      torch.minimum(ts[2], ts[3])),
        torch.maximum(torch.minimum(ts[4], ts[5]), tmin[:, None]))
    exit_ = torch.minimum(
        torch.minimum(torch.maximum(ts[0], ts[1]),
                      torch.maximum(ts[2], ts[3])),
        torch.minimum(torch.maximum(ts[4], ts[5]), t_cur[:, None]))
    hit = (entry <= exit_) & (children != 0)
    if any_hit:
        return children, hit
    keys = list(torch.where(hit, entry, torch.inf).unbind(1))
    ch = list(children.unbind(1))
    hs = list(hit.unbind(1))
    for i, j in _SORT_NETWORKS[a]:
        swap = keys[i] > keys[j]
        keys[i], keys[j] = (torch.where(swap, keys[j], keys[i]),
                            torch.where(swap, keys[i], keys[j]))
        ch[i], ch[j] = (torch.where(swap, ch[j], ch[i]),
                        torch.where(swap, ch[i], ch[j]))
        hs[i], hs[j] = (torch.where(swap, hs[j], hs[i]),
                        torch.where(swap, hs[i], hs[j]))
    return torch.stack(ch, 1), torch.stack(hs, 1)


def _leaf_step(dev, org, dirv, tmin, t_cur, code):
    """Moller-Trumbore over the M lanes of one Tri-M row per ray
    (pallas_packet.py:352-392). Returns (take, t, u, v, prim, geom, last):
    take marks rays whose best lane beats t_cur; last is the sentinel sign
    bit of lane M-1."""
    tris = dev["tris"]
    m = tris.shape[1] // 14
    row = tris[~code]
    rowi = row.view(torch.int32)
    col = [row[:, k * m:(k + 1) * m] for k in range(12)]
    v0, e1, e2, nn = col[0:3], col[3:6], col[6:9], col[9:12]
    pid = rowi[:, 12 * m:13 * m]
    gid = rowi[:, 13 * m:14 * m]
    o = [c[:, None] for c in org]
    d = [c[:, None] for c in dirv]
    cx, cy, cz = v0[0] - o[0], v0[1] - o[1], v0[2] - o[2]
    rx = d[1] * cz - d[2] * cy
    ry = d[2] * cx - d[0] * cz
    rz = d[0] * cy - d[1] * cx
    det = nn[0] * d[0] + nn[1] * d[1] + nn[2] * d[2]
    abs_det = torch.abs(det)
    sign = torch.where(det < 0, -1.0, 1.0)
    uu = (rx * e2[0] + ry * e2[1] + rz * e2[2]) * sign
    vv = (rx * e1[0] + ry * e1[1] + rz * e1[2]) * sign
    tt = (cx * nn[0] + cy * nn[1] + cz * nn[2]) * sign
    t_test = t_cur[:, None]
    ok = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= abs_det)
          & (abs_det != 0.0)
          & (tt >= abs_det * tmin[:, None]) & (tt <= abs_det * t_test)
          & (pid != -1))
    inv_det = 1.0 / torch.where(abs_det != 0.0, abs_det, 1.0)
    tv = tt * inv_det
    # sequential strict `tv < t_cur` over ascending lanes == the first lane
    # holding the minimum (torch.min returns the first index of a tie)
    best, lane = torch.min(torch.where(ok, tv, torch.inf), dim=1)
    take = best < t_cur
    lane = lane[:, None]
    return (take, best,
            torch.gather(uu * inv_det, 1, lane)[:, 0],
            torch.gather(vv * inv_det, 1, lane)[:, 0],
            torch.gather(pid, 1, lane)[:, 0] & 0x7FFFFFFF,
            torch.gather(gid, 1, lane)[:, 0],
            pid[:, m - 1] < 0)


def traverse_components(dev, org, dirv, inv_d, tmin, tmax, any_hit=False,
                        count_pops=False):
    """Closest-hit (any_hit=False) or first-hit (any_hit=True) traversal of
    flat (B,) component rays: org, dirv, inv_d are Vec3 tuples. A ray with
    tmax < tmin is dead. Returns {t, u, v, prim_id, geom_id}; on a miss
    t = tmax and prim_id = geom_id = -1.

    count_pops=True adds the pop counters of the legacy Pallas body
    (pallas_packet.py:690-699) as (B,) int32: "pops", every retired stack
    entry, and "leaf_pops", the leaf entries alone (one Tri-row fetch
    each). On the TPU they count per tile, whose rays share one stack
    (rows 0 and 1 of each 8-row block, :870-875); here each ray has its
    own stack, so they count per ray, and a dead ray counts 0."""
    device = tmin.device
    b = tmin.shape[0]
    stack = torch.zeros((b, stack_entries(dev)), dtype=torch.int32,
                        device=device)
    stack[:, 0] = 1                       # root node ref (1-based)
    sptr = (tmax >= tmin).to(torch.int64)  # dead rays never start
    t = tmax.to(torch.float32).clone()
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    prim = torch.full((b,), -1, dtype=torch.int32, device=device)
    geom = torch.full((b,), -1, dtype=torch.int32, device=device)
    if count_pops:
        pops = torch.zeros(b, dtype=torch.int32, device=device)
        leaf_pops = torch.zeros(b, dtype=torch.int32, device=device)
    while True:
        act = torch.nonzero(sptr > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp = sptr[act] - 1
        code = stack[act, sp]
        sptr[act] = sp
        is_node = code > 0
        if count_pops:
            pops[act] += 1
            leaf_pops[act[~is_node]] += 1

        rays = act[is_node]
        if rays.numel():
            nsp = sp[is_node]
            children, hit = _node_step(
                dev, [c[rays] for c in org], [c[rays] for c in inv_d],
                tmin[rays], t[rays], code[is_node], any_hit)
            hit64 = hit.to(torch.int64)
            k = hit64.sum(1, keepdim=True)
            rank = torch.cumsum(hit64, 1) - hit64
            # the first child in push order ends on top of the stack
            pos = nsp[:, None] + k - 1 - rank
            rr = rays[:, None].expand_as(pos)
            stack[rr[hit], pos[hit]] = children[hit]
            sptr[rays] = nsp + k[:, 0]

        rays = act[~is_node]
        if rays.numel():
            lsp = sp[~is_node]
            lcode = code[~is_node]
            take, lt, lu, lv, lp, lg, last = _leaf_step(
                dev, [c[rays] for c in org], [c[rays] for c in dirv],
                tmin[rays], t[rays], lcode)
            upd = rays[take]
            t[upd] = lt[take]
            u[upd] = lu[take]
            v[upd] = lv[take]
            prim[upd] = lp[take]
            geom[upd] = lg[take]
            # a leaf of several packets continues with code - 1
            cont = ~last
            stack[rays[cont], lsp[cont]] = lcode[cont] - 1
            sptr[rays] = lsp + cont.to(torch.int64)
            if any_hit:
                sptr[upd] = 0
    out = {"t": t, "u": u, "v": v, "prim_id": prim, "geom_id": geom}
    if count_pops:
        out["pops"] = pops
        out["leaf_pops"] = leaf_pops
    return out


def components(rays):
    """make_rays dict ((B, 3) org/dir) -> the traversal contract's
    arguments: (org, dir, inv_dir, inv_org) Vec3 tuples of contiguous (B,)
    tensors, then tmin and tmax."""
    def cols(x):
        return tuple(c.contiguous() for c in x.unbind(-1))
    return (cols(rays["org"]), cols(rays["dir"]), cols(rays["inv_dir"]),
            cols(rays["inv_org"]), rays["tmin"], rays["tmax"])


def traverse(dev, rays, any_hit=False, count_pops=False):
    """traverse_components over a make_rays dict ((B, 3) org/dir)."""
    org, dirv, inv_d, _, tmin, tmax = components(rays)
    return traverse_components(dev, org, dirv, inv_d, tmin, tmax,
                               any_hit=any_hit, count_pops=count_pops)


def occluded(dev, rays):
    """Any-hit query; True where the ray is blocked."""
    return traverse(dev, rays, any_hit=True)["prim_id"] >= 0


def intersect_bruteforce(dev, rays):
    """O(B x T) all-triangles closest hit, the test oracle (the Embree role
    of SURVEY.md §4). Ties go to the lowest packet, then the lowest lane."""
    org, dirv = components(rays)[:2]
    out = empty_hit(rays["tmax"])
    b = out["t"].shape[0]
    for q in range(dev["tris"].shape[0]):
        code = torch.full((b,), ~q, dtype=torch.int64, device=out["t"].device)
        take, *vals = _leaf_step(dev, org, dirv, rays["tmin"], out["t"],
                                 code)[:6]
        for key, val in zip(("t", "u", "v", "prim_id", "geom_id"), vals):
            out[key] = torch.where(take, val, out[key])
    return out


__all__ = ["make_rays", "traverse", "traverse_components", "occluded",
           "bvh_to_device", "bvh_tables", "intersect_bruteforce",
           "BvhMeta", "compute_stack_needs", "stack_entries", "components"]
