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

`traverse_tile_components` is the plain version of K5 (csrc/bvh_tile.cu):
_kernel's own contract, in which a tile of rays shares ONE stack
(pallas_packet.py:1-24); `traverse(..., tile_rows=...)` takes it.
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


def _leaf_step(dev, org, dirv, tmin, t_cur, code, t_run=None):
    """Moller-Trumbore over the M lanes of one Tri-M row per ray
    (pallas_packet.py:352-392). A lane passes `t <= t_cur` (t_cur as the
    pop began) and the best lane is taken where it beats t_run (the
    running t of a leaf chain; t_cur when None). Returns (take, t, u, v,
    prim, geom, last): take marks rays whose best lane beats t_run; last
    is the sentinel sign bit of lane M-1."""
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
    # sequential strict `tv < t_run` over ascending lanes == the first lane
    # holding the minimum (torch.min returns the first index of a tie)
    best, lane = torch.min(torch.where(ok, tv, torch.inf), dim=1)
    take = best < (t_cur if t_run is None else t_run)
    lane = lane[:, None]
    return (take, best,
            torch.gather(uu * inv_det, 1, lane)[:, 0],
            torch.gather(vv * inv_det, 1, lane)[:, 0],
            torch.gather(pid, 1, lane)[:, 0] & 0x7FFFFFFF,
            torch.gather(gid, 1, lane)[:, 0],
            pid[:, m - 1] < 0)


# _kernel's ablations that have a counterpart here (pallas_packet.py:548,
# :575-578, :639-644)
ABLATIONS = ("nonodetest", "noleaftest", "nosort")
LEAF_CHAINS = (1, 2, 4)
# the tile route: 128-ray rows per tile, and its one ablation (:794-799)
TILE_ROWS = (1, 2, 4, 8, 16, 32)
TILE_ABLATIONS = ("nopure",)


def check_options(any_hit, ablate=(), pops=1, leaf_chain=1, frustum=False,
                  tile_rows=None):
    """Validates the options of the legacy Pallas body _kernel
    (pallas_packet.py:395-876) that the port carries; returns `ablate` as
    a sorted tuple. tile_rows=None is the per-ray route, which raises
    ValueError for:

    - "nopure" and frustum=True: both belong to one stack shared by a
      tile of rays (_kernel's octant-pure ordered slab test, :794-799,
      and its 128-ray row intervals, :493-550); pass tile_rows= for them;
    - "nosort" with any-hit, which pushes in slot order anyway;
    - pops=2 with "nonodetest": _kernel's phased body has no such
      ablation (node_vec always slab-tests).

    With tile_rows (one of TILE_ROWS), the tile route takes frustum or
    "nopure", one at a time (with "nopure", _kernel never reaches the
    frustum test), and none of the per-ray options."""
    ablate = tuple(sorted(set(ablate)))
    if tile_rows is not None:
        if tile_rows not in TILE_ROWS:
            raise ValueError(f"tile_rows={tile_rows}: one of {TILE_ROWS}")
        for ab in ablate:
            if ab not in TILE_ABLATIONS:
                raise ValueError(f"ablate {ab!r} with tile_rows: the tile "
                                 f"route takes {TILE_ABLATIONS} only")
        if frustum and ablate:
            raise ValueError("frustum and ablate 'nopure' at once: with "
                             "'nopure', _kernel never reaches the frustum "
                             "test; ask for one")
        if pops != 1 or leaf_chain != 1:
            raise ValueError("pops and leaf_chain belong to the per-ray "
                             "route; the tile route pops one entry a time")
        return ablate
    if frustum:
        raise ValueError("frustum=True tests 128-ray rows against one stack "
                         "shared by a tile: pass tile_rows= (the tile "
                         "route)")
    for ab in ablate:
        if ab == "nopure":
            raise ValueError("ablate 'nopure' drops the octant-pure slab "
                             "test of a tile: pass tile_rows= (the tile "
                             "route)")
        if ab not in ABLATIONS:
            raise ValueError(f"unknown ablation {ab!r}; choose from "
                             f"{ABLATIONS}")
    if any_hit and "nosort" in ablate:
        raise ValueError("ablate 'nosort' applies to closest-hit only: "
                         "any-hit pushes children in slot order")
    if pops not in (1, 2):
        raise ValueError(f"pops={pops}: 1 or 2")
    if pops == 2 and "nonodetest" in ablate:
        raise ValueError("pops=2 has no 'nonodetest': the phased body "
                         "always slab-tests")
    if leaf_chain not in LEAF_CHAINS:
        raise ValueError(f"leaf_chain={leaf_chain}: one of {LEAF_CHAINS}")
    return ablate


def stack_entries(dev, pops=1):
    """Stack entries a traversal of this BVH needs: the tree's worst case
    plus two spare slots (pallas_packet.py:1556-1563). pops=2 expands the
    second popped entry before the first one's subtree, which can hold
    up to A - 1 more entries per level; the bound is doubled for it."""
    need = dev["meta"].shared_stack + 2
    return need if pops == 1 else 2 * need


def _leaf_chain(dev, org, dirv, tmin, t_test, carry, code, chain,
                leaftest, read=None):
    """One leaf pop per ray: up to `chain` consecutive Tri rows of the
    leaf starting at `code` (pallas_packet.py:651-663), every row tested
    against t_test (t as the pop began) and folded into the running carry
    (t, u, v, prim, geom) with the strict `<` rule. leaftest=False skips
    the lanes and follows the continuation alone (ablation "noleaftest").
    read: a (P,) bool tensor that marks every Tri row the pop reads, or
    None. Returns (carry, cont): cont is the code to push (the next row of
    a leaf longer than the chain), else 0."""
    tris = dev["tris"]
    m = tris.shape[1] // 14
    carry = [c.clone() for c in carry]
    cur = code.clone()
    for step in range(chain):
        idx = (torch.arange(cur.shape[0], device=cur.device) if step == 0
               else torch.nonzero(cur < 0).squeeze(1))
        if idx.numel() == 0:
            break
        cc = cur[idx]
        if read is not None:
            read[~cc] = True
        if leaftest:
            take, *vals, last = _leaf_step(
                dev, [c[idx] for c in org], [c[idx] for c in dirv],
                tmin[idx], t_test[idx], cc, t_run=carry[0][idx])
            upd = idx[take]
            for k in range(5):
                carry[k][upd] = vals[k][take]
        else:
            last = tris[~cc].view(torch.int32)[:, 13 * m - 1] < 0
        cur[idx] = torch.where(last, torch.zeros_like(cc), cc - 1)
    return carry, cur


def traverse_components(dev, org, dirv, inv_d, tmin, tmax, any_hit=False,
                        count_pops=False, ablate=(), pops=1, leaf_chain=1,
                        frustum=False, count_rows=False):
    """Closest-hit (any_hit=False) or first-hit (any_hit=True) traversal of
    flat (B,) component rays: org, dirv, inv_d are Vec3 tuples. A ray with
    tmax < tmin is dead. Returns {t, u, v, prim_id, geom_id}; on a miss
    t = tmax and prim_id = geom_id = -1.

    count_pops=True adds the pop counters of the legacy Pallas body
    (pallas_packet.py:690-699) as (B,) int32: "pops", every retired stack
    entry, and "leaf_pops", the leaf entries alone (one Tri-row fetch
    each, or one chain of them). On the TPU they count per tile, whose
    rays share one stack (rows 0 and 1 of each 8-row block, :870-875);
    here each ray has its own stack, so they count per ray, and a dead ray
    counts 0.

    count_rows=True adds "nodes_read" (N,) and "tris_read" (P,) bool: the
    rows of the node and Tri tables that the rays' pops read at least
    once, the least a kernel doing the same pops must load
    (experiments.common.bound_ms).

    The other options are _kernel's, with its semantics (check_options
    lists what is refused):
      ablate "nonodetest": a node pushes every nonzero child in slot
          order without a slab test (:575-578): hits stay right, pops
          grow; "noleaftest": a leaf skips its lanes and follows its
          continuation (:639-644): every ray misses; "nosort": closest-hit
          pushes hit children in slot order (:548, :582, :773);
      pops=2: the phased body (:679-789): pop two entries, test both
          against t as the iteration began, merge the two leaf folds
          first-wins with strict <, push the second entry's children
          first, so the first entry's nearest child ends on top;
      leaf_chain=N: one leaf pop consumes up to N consecutive Tri rows
          (:651-663) and still counts one pop and one leaf pop."""
    ablate = check_options(any_hit, ablate, pops, leaf_chain, frustum)
    nodetest = "nonodetest" not in ablate
    leaftest = "noleaftest" not in ablate
    sort_any = any_hit or "nosort" in ablate
    device = tmin.device
    b = tmin.shape[0]
    a = dev["nodes"].shape[1] // 7
    cap = stack_entries(dev, pops)
    stack = torch.zeros((b, cap), dtype=torch.int32, device=device)
    stack[:, 0] = 1                       # root node ref (1-based)
    sptr = (tmax >= tmin).to(torch.int64)  # dead rays never start
    t = tmax.to(torch.float32).clone()
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    prim = torch.full((b,), -1, dtype=torch.int32, device=device)
    geom = torch.full((b,), -1, dtype=torch.int32, device=device)
    if count_pops:
        pops_n = torch.zeros(b, dtype=torch.int32, device=device)
        leaf_n = torch.zeros(b, dtype=torch.int32, device=device)
    nodes_read = tris_read = None
    if count_rows:
        nodes_read = torch.zeros(dev["nodes"].shape[0], dtype=torch.bool,
                                 device=device)
        tris_read = torch.zeros(dev["tris"].shape[0], dtype=torch.bool,
                                device=device)
    while True:
        act = torch.nonzero(sptr > 0).squeeze(1)
        if act.numel() == 0:
            break
        n = act.numel()
        sp = sptr[act]
        codes = []
        for _ in range(pops):
            has = sp > 0
            code = stack[act, (sp - 1).clamp(min=0)]
            codes.append(torch.where(has, code, torch.zeros_like(code)))
            sp = sp - has.to(torch.int64)
        if count_pops:
            for code in codes:
                pops_n[act] += (code != 0).to(torch.int32)
                leaf_n[act] += (code < 0).to(torch.int32)
        # every entry of the iteration starts from the same carry
        start = (t[act], u[act], v[act], prim[act], geom[act])
        merged = None
        pushes = []
        for code in codes:
            carry = start
            push = torch.zeros((n, a), dtype=torch.int32, device=device)
            mask = torch.zeros((n, a), dtype=torch.bool, device=device)
            nd = torch.nonzero(code > 0).squeeze(1)
            if nd.numel():
                rays = act[nd]
                if count_rows:
                    nodes_read[code[nd] - 1] = True
                if nodetest:
                    children, hit = _node_step(
                        dev, [c[rays] for c in org],
                        [c[rays] for c in inv_d], tmin[rays],
                        start[0][nd], code[nd], sort_any)
                else:
                    children = dev["nodes"][code[nd] - 1][
                        :, 6 * a:].view(torch.int32)
                    hit = children != 0
                push[nd] = children
                mask[nd] = hit
            lf = torch.nonzero(code < 0).squeeze(1)
            if lf.numel():
                rays = act[lf]
                part, cont = _leaf_chain(
                    dev, [c[rays] for c in org], [c[rays] for c in dirv],
                    tmin[rays], start[0][lf], [c[lf] for c in start],
                    code[lf], leaf_chain, leaftest, tris_read)
                carry = [c.clone() for c in start]
                for k in range(5):
                    carry[k][lf] = part[k]
                push[lf, 0] = cont
                mask[lf, 0] = cont != 0
            if merged is None:
                merged = list(carry)
            else:   # first-wins: a later entry replaces on a strict <
                sel = carry[0] < merged[0]
                merged = [torch.where(sel, c, mm)
                          for c, mm in zip(carry, merged)]
            pushes.append((push, mask))
        t[act], u[act], v[act], prim[act], geom[act] = merged
        # the last entry's children go in first, so the first entry's
        # first child in push order ends on top
        for push, mask in reversed(pushes):
            m64 = mask.to(torch.int64)
            k = m64.sum(1)
            pos = sp[:, None] + k[:, None] - 1 - (torch.cumsum(m64, 1) - m64)
            live = pos[mask]
            if live.numel() and int(live.max()) >= cap:
                raise ValueError(f"traversal stack of {cap} entries "
                                 f"overflowed (pops={pops})")
            rr = act[:, None].expand_as(pos)
            stack[rr[mask], pos[mask]] = push[mask]
            sp = sp + k
        sptr[act] = sp
        if any_hit:   # a ray ends at the iteration that found a hit
            sptr[act[merged[3] >= 0]] = 0
    out = {"t": t, "u": u, "v": v, "prim_id": prim, "geom_id": geom}
    if count_pops:
        out["pops"] = pops_n
        out["leaf_pops"] = leaf_n
    if count_rows:
        out["nodes_read"] = nodes_read
        out["tris_read"] = tris_read
    return out


_F32_MAX = 3.402823466e38   # a miss's key in the tile kernels


def tile_pad(x, nt, size, fill=0.0):
    """(B,) -> (nt, size): the rays of each tile in a row, padded as
    pack_rays pads (pallas_packet.py:1462-1484): zeros, tmax = -1."""
    pad = nt * size - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_full((pad,), fill)])
    return x.reshape(nt, size)


def mt_lane(v0, e1, e2, nn, o, d, tmin, t_test):
    """Sign-trick Moller-Trumbore of one Tri lane against rays, in the
    float operation order of _mt_lanes (pallas_packet.py:368-383): returns
    (ok, t, u, v); ok where the lane passes `t <= t_test`. Each argument
    broadcasts against the rays' shape."""
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
    ok = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= abs_det)
          & (abs_det != 0.0) & (tt >= abs_det * tmin)
          & (tt <= abs_det * t_test))
    inv_det = 1.0 / torch.where(abs_det != 0.0, abs_det, 1.0)
    return ok, tt * inv_det, uu * inv_det, vv * inv_det


def tile_leaf_lanes(tris, code, o, d, tmin, t_test, miss):
    """Moller-Trumbore of one Tri row per tile (code: (k,) leaf refs)
    against the tile's rays ((k, T) components), all M lanes at once. A
    lane counts where it passes `t <= t_test` and its pid is not -1; of
    those the leftmost with the smallest t is kept, which is what a
    sequential fold over the lanes with the strict `<` keeps (_mt_lanes,
    pallas_packet.py:352-392; pallas_pair.py:246-261). Returns (best t,
    with `miss` where no lane counts, lane, u, v, pid, geom) per ray, the
    attributes those of the kept lane (of lane 0 where none counts)."""
    m = tris.shape[1] // 14
    row = tris[~code]
    rowi = row.view(torch.int32)

    def fld(f):
        return row[:, f * m:(f + 1) * m][:, None, :]

    def at(x, lane):
        return x.expand(lane.shape + (m,)).gather(2, lane[..., None])[..., 0]

    ok, tv, uv, vv = mt_lane(
        [fld(0), fld(1), fld(2)], [fld(3), fld(4), fld(5)],
        [fld(6), fld(7), fld(8)], [fld(9), fld(10), fld(11)],
        [c[:, :, None] for c in o], [c[:, :, None] for c in d],
        tmin[:, :, None], t_test[:, :, None])
    pid = rowi[:, 12 * m:13 * m][:, None, :]
    best, lane = torch.where(ok & (pid != -1), tv, miss).min(2)
    return (best, lane, at(uv, lane), at(vv, lane), at(pid, lane),
            at(rowi[:, 13 * m:14 * m][:, None, :], lane))


def _tile_signs(inv):
    """Per tile ((nt, size) tiles of inv_dir components): whether all its
    rays' components are >= 0, per axis, and whether the tile is octant
    pure, all its rays sharing their signs on every axis
    (pallas_packet.py:487-491). Returns (pos, pure)."""
    pos = [(c >= 0.0).all(1) for c in inv]
    neg = [(c < 0.0).all(1) for c in inv]
    return pos, (pos[0] | neg[0]) & (pos[1] | neg[1]) & (pos[2] | neg[2])


def tile_purity(inv_d, tile_rows):
    """(nt,) bool: the tiles of tile_rows * 128 rays (padded as pack_rays
    pads) that are octant pure, where the tile route takes the pure slab
    test or, with frustum=True, the row-frustum test."""
    size = 128 * tile_rows
    nt = -(-inv_d[0].shape[0] // size)
    return _tile_signs([tile_pad(c, nt, size) for c in inv_d])[1]


def _tile_slab_keys(rows, a, o, inv, tmin, t_test, pos=None):
    """Per-child tile-min entry keys (k, A) of k node rows against their
    tiles' rays (k, T): _slab_parts + the reduction of _finalize_children
    (pallas_packet.py:237-329), in the unfused form (b - o) * inv. pos:
    the tiles' per-axis direction signs, (k,) bool each, for the pure form
    (a per-tile near/far select); None for the mixed form (per-ray
    min/max)."""
    def bnd(j):
        return rows[:, j * a:(j + 1) * a][:, :, None]

    o = [c[:, None, :] for c in o]
    inv = [c[:, None, :] for c in inv]
    if pos is not None:
        p = [q[:, None, None] for q in pos]
        bs = [torch.where(p[k], bnd(2 * k), bnd(2 * k + 1)) for k in range(3)]
        bf = [torch.where(p[k], bnd(2 * k + 1), bnd(2 * k)) for k in range(3)]
        ent = torch.maximum(
            torch.maximum((bs[0] - o[0]) * inv[0], (bs[1] - o[1]) * inv[1]),
            torch.maximum((bs[2] - o[2]) * inv[2], tmin[:, None, :]))
        ext = torch.minimum(
            torch.minimum((bf[0] - o[0]) * inv[0], (bf[1] - o[1]) * inv[1]),
            torch.minimum((bf[2] - o[2]) * inv[2], t_test[:, None, :]))
    else:
        ts = [(bnd(j) - o[j // 2]) * inv[j // 2] for j in range(6)]
        ent = torch.maximum(
            torch.maximum(torch.minimum(ts[0], ts[1]),
                          torch.minimum(ts[2], ts[3])),
            torch.maximum(torch.minimum(ts[4], ts[5]), tmin[:, None, :]))
        ext = torch.minimum(
            torch.minimum(torch.maximum(ts[0], ts[1]),
                          torch.maximum(ts[2], ts[3])),
            torch.minimum(torch.maximum(ts[4], ts[5]), t_test[:, None, :]))
    return torch.where(ent <= ext, ent, _F32_MAX).amin(2)


def _tile_frustum_keys(rows, pos, fr, t_test, tile_rows):
    """Per-child conservative keys (k, 8) of node_step_frustum
    (pallas_packet.py:511-539): each child's box against each 128-ray
    row's interval box in sign-mirrored coordinates (fr: the rows'
    o2_lo/hi, i2_lo/hi per axis and tmin_row, (k, R) each), the same
    float operations in the same order, then the minimum over the rows."""
    k = rows.shape[0]
    t_ub = t_test.reshape(k, tile_rows, 128).amax(2)[:, :, None]
    ent = ext = None
    for ax in range(3):
        lo = rows[:, 16 * ax:16 * ax + 8][:, None, :]
        hi = rows[:, 16 * ax + 8:16 * ax + 16][:, None, :]
        p = pos[ax][:, None, None]
        b_n = torch.where(p, lo, -hi)
        b_f = torch.where(p, hi, -lo)
        o2_lo, o2_hi, i2_lo, i2_hi = [x[:, :, None] for x in fr[ax]]
        a_ = b_n - o2_hi
        e_k = a_ * torch.where(a_ >= 0.0, i2_lo, i2_hi)
        b_ = b_f - o2_lo
        x_k = b_ * torch.where(b_ >= 0.0, i2_hi, i2_lo)
        ent = e_k if ent is None else torch.maximum(ent, e_k)
        ext = x_k if ext is None else torch.minimum(ext, x_k)
    ent = torch.maximum(ent, fr[3][:, :, None])
    ext = torch.minimum(ext, t_ub)
    return torch.where(ent <= ext, ent, _F32_MAX).amin(1)


def traverse_tile_components(dev, org, dirv, inv_d, tmin, tmax,
                             any_hit=False, tile_rows=16, frustum=False,
                             ablate=(), count_rows=False):
    """The tile route: _kernel's own contract (pallas_packet.py:1-24,
    :395-876, pops=1), the plain version of K5. The rays, flat (B,)
    components, go in tiles of tile_rows * 128 consecutive rays (the last
    one padded with zero rays whose tmax is -1); each tile walks the union
    of its rays' node sets from ONE stack, and every live tile pops one
    entry per step:

    - a node row is slab-tested against every ray of the tile: in the
      pure form (one near/far select for the tile) where all of the
      tile's rays share their direction signs on every axis, padding
      included, else in the mixed form (per-ray min/max); a child's key
      is its minimum entry distance over the tile; closest-hit pushes the
      hit children sorted near-first (Batcher network), any-hit in slot
      order;
    - frustum=True: on pure tiles, each child is tested against every
      128-ray row's interval box instead (node_step_frustum, a
      conservative push set; the hits stay exact);
    - ablate=("nopure",): every tile takes the mixed form;
    - a leaf row runs Moller-Trumbore over its lanes for every ray, lanes
      tested against t as the pop began and kept on a strict <; the next
      row of the leaf is pushed unless lane M-1's pid sign bit is set;
    - any-hit tests a ray that has its hit at t = -FLT_MAX, and a tile
      stops when every ray has its hit or is dead.

    Returns {t, u, v, prim_id, geom_id} per ray (t = tmax on a miss) and
    "pops" and "leaf_pops" per tile, (nt,) int32, as _kernel's count_pops
    (rows 0 and 1 of each tile's 8-row block, :870-875); count_rows=True
    adds "nodes_read" and "tris_read" (traverse_components)."""
    ablate = check_options(any_hit, ablate, frustum=frustum,
                           tile_rows=tile_rows)
    nodes, tris = dev["nodes"], dev["tris"]
    a = nodes.shape[1] // 7
    m = tris.shape[1] // 14
    if frustum and a != 8:
        raise ValueError(f"frustum=True reads BVH8 rows (16 floats per "
                         f"axis, pallas_packet.py:525-526); got BVH{a}")
    device = tmin.device
    b = tmin.shape[0]
    size = 128 * tile_rows
    nt = -(-b // size)
    o = [tile_pad(c, nt, size) for c in org]
    d = [tile_pad(c, nt, size) for c in dirv]
    inv = [tile_pad(c, nt, size) for c in inv_d]
    tmn = tile_pad(tmin, nt, size)
    tmx = tile_pad(tmax.to(torch.float32), nt, size, -1.0)
    pos, pure = _tile_signs(inv)
    if "nopure" in ablate:
        pure = torch.zeros_like(pure)
    fr = None
    if frustum:
        def rows_of(x):
            return x.reshape(nt, tile_rows, 128)
        fr = []
        for ax in range(3):
            o2 = rows_of(torch.where(pos[ax][:, None], o[ax], -o[ax]))
            i2 = rows_of(inv[ax].abs())
            fr.append((o2.amin(2), o2.amax(2), i2.amin(2), i2.amax(2)))
        fr.append(rows_of(tmn).amin(2))

    t = tmx.clone()
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    prim = torch.full((nt, size), -1, dtype=torch.int32, device=device)
    geom = torch.full_like(prim, -1)
    cap = stack_entries(dev)
    stack = torch.zeros((nt, cap), dtype=torch.int32, device=device)
    stack[:, 0] = 1
    sp = torch.ones(nt, dtype=torch.int64, device=device)
    done = torch.zeros(nt, dtype=torch.bool, device=device)
    pops = torch.zeros(nt, dtype=torch.int32, device=device)
    leaf_pops = torch.zeros_like(pops)
    if count_rows:
        nodes_read = torch.zeros(nodes.shape[0], dtype=torch.bool,
                                 device=device)
        tris_read = torch.zeros(tris.shape[0], dtype=torch.bool,
                                device=device)
    while True:
        act = torch.nonzero((sp > 0) & ~done).squeeze(1)
        if act.numel() == 0:
            break
        spa = sp[act] - 1
        code = stack[act, spa]
        pops[act] += 1
        leaf_pops[act] += (code < 0).to(torch.int32)
        t_test = t[act]
        if any_hit:   # done rays stop widening the push sets (:706-709)
            t_test = torch.where(prim[act] >= 0, -_F32_MAX, t_test)
        push = torch.zeros((act.numel(), a), dtype=torch.int32,
                           device=device)
        nd = torch.nonzero(code > 0).squeeze(1)
        if nd.numel():
            tl = act[nd]
            rows = nodes[code[nd] - 1]
            if count_rows:
                nodes_read[code[nd] - 1] = True
            tt = t_test[nd]
            args = ([c[tl] for c in o], [c[tl] for c in inv], tmn[tl], tt)
            keys = _tile_slab_keys(rows, a, *args)
            pt = torch.nonzero(pure[tl]).squeeze(1)
            if pt.numel():
                if frustum:
                    kp = _tile_frustum_keys(
                        rows[pt], [q[tl[pt]] for q in pos],
                        [tuple(x[tl[pt]] for x in f) for f in fr[:3]]
                        + [fr[3][tl[pt]]], tt[pt], tile_rows)
                else:
                    kp = _tile_slab_keys(rows[pt], a,
                                         *[[c[pt] for c in x] for x in
                                           args[:2]], args[2][pt], tt[pt],
                                         [q[tl[pt]] for q in pos])
                keys[pt] = kp
            ch = rows[:, 6 * a:].view(torch.int32)
            valid = (ch != 0) & (keys < _F32_MAX)
            keys = list(torch.where(valid, keys, _F32_MAX).unbind(1))
            ch = list(torch.where(valid, ch, 0).unbind(1))
            if not any_hit:
                for i, j in _SORT_NETWORKS[a]:
                    swap = keys[i] > keys[j]
                    keys[i], keys[j] = (torch.where(swap, keys[j], keys[i]),
                                        torch.where(swap, keys[i], keys[j]))
                    ch[i], ch[j] = (torch.where(swap, ch[j], ch[i]),
                                    torch.where(swap, ch[i], ch[j]))
            push[nd] = torch.stack(ch, 1)
        lf = torch.nonzero(code < 0).squeeze(1)
        if lf.numel():
            tl = act[lf]
            lc = code[lf]
            if count_rows:
                tris_read[~lc] = True
            rowi = tris[~lc].view(torch.int32)
            best, lane, uv, vv, pid, gid = tile_leaf_lanes(
                tris, lc, [c[tl] for c in o], [c[tl] for c in d], tmn[tl],
                t_test[lf], torch.inf)
            upd = best < t[tl]
            t[tl] = torch.where(upd, best, t[tl])
            u[tl] = torch.where(upd, uv, u[tl])
            v[tl] = torch.where(upd, vv, v[tl])
            prim[tl] = torch.where(upd, pid & 0x7FFFFFFF, prim[tl])
            geom[tl] = torch.where(upd, gid, geom[tl])
            last = rowi[:, 13 * m - 1] < 0
            push[lf, 0] = torch.where(last, torch.zeros_like(lc), lc - 1)
        # the last child first, so child 0 ends on top (:836-840)
        for r in range(a - 1, -1, -1):
            ok = push[:, r] != 0
            if bool(ok.any()) and int(spa[ok].max()) >= cap:
                raise ValueError(f"tile stack of {cap} entries overflowed")
            stack[act[ok], spa[ok]] = push[ok, r]
            spa = spa + ok.to(torch.int64)
        sp[act] = spa
        if any_hit:
            done[act] = ((tmx[act] < tmn[act]) | (prim[act] >= 0)).all(1)
    out = {"t": t.reshape(-1)[:b], "u": u.reshape(-1)[:b],
           "v": v.reshape(-1)[:b], "prim_id": prim.reshape(-1)[:b],
           "geom_id": geom.reshape(-1)[:b], "pops": pops,
           "leaf_pops": leaf_pops}
    if count_rows:
        out["nodes_read"] = nodes_read
        out["tris_read"] = tris_read
    return out


def components(rays):
    """make_rays dict ((B, 3) org/dir) -> the traversal contract's
    arguments: (org, dir, inv_dir, inv_org) Vec3 tuples of contiguous (B,)
    tensors, then tmin and tmax."""
    def cols(x):
        return tuple(c.contiguous() for c in x.unbind(-1))
    return (cols(rays["org"]), cols(rays["dir"]), cols(rays["inv_dir"]),
            cols(rays["inv_org"]), rays["tmin"], rays["tmax"])


def traverse(dev, rays, any_hit=False, count_pops=False, **options):
    """traverse_components over a make_rays dict ((B, 3) org/dir);
    options: ablate, pops, leaf_chain, frustum, count_rows. With
    tile_rows=, traverse_tile_components instead (options frustum, ablate,
    count_rows; its per-tile counters with count_pops=True)."""
    org, dirv, inv_d, _, tmin, tmax = components(rays)
    if options.get("tile_rows") is not None:
        check_options(any_hit, options.get("ablate", ()),
                      options.pop("pops", 1), options.pop("leaf_chain", 1),
                      options.get("frustum", False), options["tile_rows"])
        out = traverse_tile_components(dev, org, dirv, inv_d, tmin, tmax,
                                       any_hit=any_hit, **options)
        if not count_pops:
            del out["pops"], out["leaf_pops"]
        return out
    options.pop("tile_rows", None)
    return traverse_components(dev, org, dirv, inv_d, tmin, tmax,
                               any_hit=any_hit, count_pops=count_pops,
                               **options)


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
           "BvhMeta", "compute_stack_needs", "stack_entries", "components",
           "check_options", "ABLATIONS", "LEAF_CHAINS",
           "traverse_tile_components", "TILE_ROWS", "TILE_ABLATIONS",
           "tile_pad", "tile_purity", "tile_leaf_lanes", "mt_lane"]
