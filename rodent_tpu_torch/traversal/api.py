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


def check_options(any_hit, ablate=(), pops=1, leaf_chain=1, frustum=False):
    """Validates the options of the legacy Pallas body _kernel
    (pallas_packet.py:395-876) that the port carries; returns `ablate` as
    a sorted tuple. Raises ValueError for the rest:

    - "nopure" drops _kernel's octant-pure ordered slab test (:794-799);
      a per-ray stack never takes that test, so there is nothing to drop;
    - frustum=True tests 128-ray row intervals against one shared stack
      (:493-550), which needs a warp-shared stack: ROADMAP B3a;
    - "nosort" changes nothing for any-hit, which pushes in slot order;
    - pops=2 with "nonodetest": _kernel's phased body has no such
      ablation (node_vec always slab-tests)."""
    ablate = tuple(sorted(set(ablate)))
    if frustum:
        raise ValueError("frustum=True is not ported: it needs a "
                         "warp-shared stack (ROADMAP B3a, the next slice)")
    for ab in ablate:
        if ab == "nopure":
            raise ValueError("ablate 'nopure' has no counterpart: a "
                             "per-ray stack never takes the octant-pure "
                             "ordered slab test")
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
    options: ablate, pops, leaf_chain, frustum, count_rows."""
    org, dirv, inv_d, _, tmin, tmax = components(rays)
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
           "check_options", "ABLATIONS", "LEAF_CHAINS"]
