"""The dual-queue lockstep traversal with staged row compaction (torch port
of rodent_tpu/traversal/tiled.py).

Every ray keeps two stacks, one of inner-node refs and one of leaf-packet
refs, and the bundle advances in lockstep trips. Each trip pops one node
per ray (a wide slab test, its hit children sorted near-first by the
Batcher network) and, under a leaf gate, one leaf packet per ray (a
Tri-M Moller-Trumbore over its lanes): the lockstep analog of the
reference's interleaved while-while traversal (mapping_gpu.impala:94-178).

Semantics kept bit for bit against the JAX engine (tiled.py:73-354):

- the leaf gate is a count over the whole bundle: the leaf unit runs where
  `leaf_cnt * 4 >= live_cnt`, or where no node can progress without it
  (`node_ok == 0 & leaf_cnt > 0`) (:172);
- the leaf unit pops one packet per ray, tests its lanes against t as the
  trip began and takes the first lane holding the smallest t wherever one
  passes, even at an equal t (`upd = isfinite(best)`, :233: not the strict
  `t < t_cur` of api._leaf_step); a multi-packet leaf pushes its
  continuation `code - 1` unless lane M-1's pid sign bit marks the last
  packet;
- the node unit stalls a ray whose leaf stack could overflow this trip
  (`lptr + arity + 1 > S_L`); it pushes the hit leaf children in sorted
  order onto the leaf stack and the inner ones so that the nearest ends on
  top of the node stack;
- a push whose slot is at or past the stack's size is dropped while the
  pointer still moves (the JAX one-hot writes), and a pop from such a slot
  reads 0;
- any-hit clears both stacks of a ray once it has a hit;
- S_N = max(meta.node_stack, 4) (or stack_depth), S_L = 16.

PyTorch's idiom, not the TPU's: the stacks are (B, S + 1) int32 tensors
read with `gather` and written with `scatter_`; column S is a dump that
takes the dropped pushes and is never popped. The slab test and the
Batcher network are api._node_step's. The JAX `lax.cond` of the leaf unit
and the `while_loop` cond read the same state, so one host read per trip
serves both: the leaf unit runs only on trips whose gate is on.

Staged compaction (compact_stages > 0) decides on rows of 128 slots, as
the JAX engine's (R, 128) tiles do: the flat bundle is padded with dead
slots to whole rows; each stage runs the loop until the rows that still
have work fit in half the width, moves them to the front (stable, so the
cone-sort order holds), retires the dead half's hits and goes on at half
the width. Hits are identical with and without it.

sub_batches=k splits the rows into k chunks traced one after the other,
each with its own leaf gate, under the JAX engine's conditions (the rows
divide into chunks of at least 8 rows; no counters).

debug_counters=True adds "counters": iters (trips), leaf_iters (trips
whose leaf unit ran) and live_sum (the sum over trips of live rays, in
float32 as the JAX engine sums it). Whatever the options, `trips` counts
the trips and the leaf-unit trips of every call since reset_trips(), for
callers that cannot ask for counters (the renderers).

Not ported (TPU measurement machinery): the waterfall hooks `ablate=` and
`fixed_iters=`, and the `_LEAF_GATHER` shard modes (:68).
"""
from __future__ import annotations

import numpy as np
import torch

from .api import _node_step, components, mt_lane

NODE_STACK_DEPTH = 24
LEAF_STACK_DEPTH = 16
ROW = 128          # the rows of the JAX engine's (R, 128) tiles
_HIT_KEYS = ("t", "u", "v", "prim_id", "geom_id")

# trips of every lockstep loop since the last reset_trips()
trips = {"trips": 0, "leaf_trips": 0}


def reset_trips():
    for k in trips:
        trips[k] = 0


def _pop(stack, ptr, can):
    """One pop per ray where `can`: (code, new ptr). A slot at or past the
    stack's size (its last column is the dump) reads 0."""
    s = stack.shape[1] - 1
    top = ptr - 1
    code = stack.gather(1, top.clamp(0, s - 1)[:, None])[:, 0]
    code = torch.where(can & (top < s), code, 0)
    return code, torch.where(can, top, ptr)


def _push(stack, pos, vals, mask):
    """Writes vals (B, k) at slots pos (B, k) where mask; slots at or past
    the stack's size go to the dump column."""
    s = stack.shape[1] - 1
    pos = torch.where(mask & (pos < s), pos, s)
    stack.scatter_(1, pos, vals)


def _ranks(mask):
    """Exclusive prefix counts of mask (B, A) along the children, one add
    per child, as the JAX engine counts them: torch's scan kernel over a
    short innermost dimension took 6.8 ms per call on 1M x 8 on the H100,
    70% of a traversal's device time."""
    ranks = [torch.zeros_like(mask[:, 0])]
    for i in range(mask.shape[1] - 1):
        ranks.append(ranks[-1] + mask[:, i])
    return torch.stack(ranks, 1)


def _leaf_unit(dev, rays, st):
    """Pops one leaf packet per ray, tests its M lanes and pushes the
    continuation of a multi-packet leaf (tiled.py:187-240)."""
    tris = dev["tris"]
    m = tris.shape[1] // 14
    lcode, lptr = _pop(st["lstack"], st["lptr"], st["lptr"] > 0)
    is_leaf = lcode < 0
    row = tris[torch.where(is_leaf, ~lcode, 0)]
    rowi = row.view(torch.int32)

    def fld(k):
        return row[:, k * m:(k + 1) * m]

    t0 = st["t"]
    ok, tv, uv, vv = mt_lane(
        [fld(0), fld(1), fld(2)], [fld(3), fld(4), fld(5)],
        [fld(6), fld(7), fld(8)], [fld(9), fld(10), fld(11)],
        [c[:, None] for c in rays["org"]], [c[:, None] for c in rays["dir"]],
        rays["tmin"][:, None], t0[:, None])
    pid = rowi[:, 12 * m:13 * m]
    ok = ok & (pid != -1) & is_leaf[:, None]
    best, lane = torch.where(ok, tv, torch.inf).min(1)
    upd = torch.isfinite(best)
    lane = lane[:, None]
    cont = is_leaf & ~(pid[:, m - 1] < 0)
    _push(st["lstack"], lptr[:, None], (lcode - 1)[:, None], cont[:, None])
    st["lptr"] = lptr + cont.to(lptr.dtype)
    st["t"] = torch.where(upd, best, t0)
    st["u"] = torch.where(upd, uv.gather(1, lane)[:, 0], st["u"])
    st["v"] = torch.where(upd, vv.gather(1, lane)[:, 0], st["v"])
    st["prim_id"] = torch.where(upd, pid.gather(1, lane)[:, 0] & 0x7FFFFFFF,
                                st["prim_id"])
    st["geom_id"] = torch.where(
        upd, rowi[:, 13 * m:14 * m].gather(1, lane)[:, 0], st["geom_id"])


def _node_unit(dev, rays, st, any_hit, s_l):
    """Pops one inner node per ray whose leaf stack has room, slab-tests its
    children and pushes the hit ones (tiled.py:252-341)."""
    arity = dev["nodes"].shape[1] // 7
    nptr, lptr = st["nptr"], st["lptr"]
    can = (nptr > 0) & (lptr + arity + 1 <= s_l)
    ncode, nptr = _pop(st["nstack"], nptr, can)
    is_node = ncode > 0
    children, hit = _node_step(dev, rays["org"], rays["inv_d"], rays["tmin"],
                               st["t"], torch.where(is_node, ncode, 1),
                               any_hit)
    hit = hit & is_node[:, None]
    inner = hit & (children > 0)
    leaf = hit & (children < 0)
    inner_i = inner.to(nptr.dtype)
    leaf_i = leaf.to(nptr.dtype)
    k_n = inner_i.sum(1)
    k_l = leaf_i.sum(1)
    # leaf children in sorted order above lptr
    _push(st["lstack"], lptr[:, None] + _ranks(leaf_i), children, leaf)
    # inner children: the first in sorted order ends on top
    _push(st["nstack"], (nptr + k_n - 1)[:, None] - _ranks(inner_i),
          children, inner)
    st["lptr"] = lptr + k_l
    st["nptr"] = nptr + k_n
    if any_hit:
        done = st["prim_id"] >= 0
        st["nptr"] = torch.where(done, 0, st["nptr"])
        st["lptr"] = torch.where(done, 0, st["lptr"])


def _stage_loop(dev, rays, st, stop_rows, any_hit, s_l, counters=None):
    """One lockstep loop at the bundle's current width (tiled.py:73-354):
    runs until at most `stop_rows` rows of ROW slots still have work
    (stop_rows=0: until every ray is done). One host read per trip carries
    the loop's condition, the leaf gate and the live count."""
    arity = dev["nodes"].shape[1] // 7
    while True:
        nptr, lptr = st["nptr"], st["lptr"]
        has_node = nptr > 0
        has_leaf = lptr > 0
        live = has_node | has_leaf
        if stop_rows <= 0:
            go = live.any()
        else:
            go = live.view(-1, ROW).any(1).sum() > stop_rows
        leaf_cnt = has_leaf.sum()
        live_cnt = live.sum()
        node_ok = (has_node & (lptr + arity + 1 <= s_l)).sum()
        do_leaf = (leaf_cnt * 4 >= live_cnt) | ((node_ok == 0)
                                                & (leaf_cnt > 0))
        go, do_leaf, n_live = torch.stack(
            [go.long(), do_leaf.long(), live_cnt]).tolist()
        if not go:
            return
        if do_leaf:
            _leaf_unit(dev, rays, st)
        _node_unit(dev, rays, st, any_hit, s_l)
        trips["trips"] += 1
        trips["leaf_trips"] += do_leaf
        if counters is not None:
            counters["iters"] += 1
            counters["leaf_iters"] += do_leaf
            counters["live_sum"] = np.float32(counters["live_sum"]
                                              + np.float32(n_live))


def _rows(x, order=None, n=None):
    """x (W * ROW, ...) seen as rows: the rows `order` (all rows when
    None), then the first n of them (all when None), flat again."""
    r = x.view((-1, ROW) + x.shape[1:])
    if order is not None:
        r = r[order]
    if n is not None:
        r = r[:n]
    return r.reshape((-1,) + x.shape[1:])


def _map_rows(tree, order=None, n=None):
    if isinstance(tree, dict):
        return {k: _map_rows(v, order, n) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_rows(v, order, n) for v in tree)
    return _rows(tree, order, n)


def _traverse_staged(dev, rays, st, any_hit, s_l, max_stages):
    """The staged-halving cascade (tiled.py:470-506): loops at R, R/2,
    R/4, ... rows with row compaction between stages. Returns the hit dict
    at the full width, in the original slot order."""
    n_rows = st["nptr"].shape[0] // ROW
    row_ids = torch.arange(n_rows, device=st["nptr"].device)
    outs = {k: st[k].view(n_rows, ROW).clone() for k in _HIT_KEYS}
    width = n_rows
    for _ in range(max_stages):
        next_w = width // 2
        if next_w < 8:
            break
        _stage_loop(dev, rays, st, next_w, any_hit, s_l)
        live_row = ((st["nptr"] > 0) | (st["lptr"] > 0)).view(
            width, ROW).any(1)
        # live rows first; stable, so the cone-sort order holds in each
        order = torch.sort((~live_row).to(torch.uint8), stable=True).indices
        rays = _map_rows(rays, order)
        st = _map_rows(st, order)
        row_ids = row_ids[order]
        for k in _HIT_KEYS:   # retire the all-dead tail half
            outs[k][row_ids[next_w:]] = st[k].view(width, ROW)[next_w:]
        rays = _map_rows(rays, n=next_w)
        st = _map_rows(st, n=next_w)
        row_ids = row_ids[:next_w]
        width = next_w
    _stage_loop(dev, rays, st, 0, any_hit, s_l)
    for k in _HIT_KEYS:
        outs[k][row_ids] = st[k].view(width, ROW)
    return {k: v.reshape(-1) for k, v in outs.items()}


def traverse_components(dev, org, dirv, inv_d, inv_o, tmin, tmax,
                        any_hit=False, stack_depth=None,
                        debug_counters=False, compact_stages=0,
                        sub_batches=0):
    """Closest-hit or any-hit traversal of flat (B,) component rays (org,
    dirv, inv_d, inv_o Vec3 tuples) through the dual-queue engine. A ray
    with tmax < tmin is dead. Returns {t, u, v, prim_id, geom_id} (t = tmax
    and ids -1 on a miss), and "counters" with debug_counters=True.
    compact_stages > 0 takes the staged compaction (bundles of at least 8
    rows, without counters); sub_batches=k > 1 traces k chunks of rows one
    after the other (see the module docstring)."""
    b = tmin.shape[0]
    n_rows = -(-b // ROW)
    k = sub_batches
    if (k > 1 and n_rows % k == 0 and n_rows // k >= 8
            and not debug_counters):
        step = n_rows // k * ROW
        parts = [traverse_components(
            dev, *[tuple(c[i:i + step] for c in x)
                   for x in (org, dirv, inv_d, inv_o)],
            tmin[i:i + step], tmax[i:i + step], any_hit=any_hit,
            stack_depth=stack_depth, compact_stages=compact_stages)
            for i in range(0, b, step)]
        return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
    meta = dev.get("meta")
    s_n = stack_depth or (max(meta.node_stack, 4) if meta is not None
                          else NODE_STACK_DEPTH)
    s_l = LEAF_STACK_DEPTH
    device = tmin.device
    pad = n_rows * ROW - b

    def padded(x, fill=0.0):
        x = x.to(torch.float32)
        return torch.cat([x, x.new_full((pad,), fill)]) if pad else x

    rays = {"org": tuple(padded(c) for c in org),
            "dir": tuple(padded(c) for c in dirv),
            "inv_d": tuple(padded(c) for c in inv_d),
            "tmin": padded(tmin)}
    tmax_p = padded(tmax, -1.0)
    bp = n_rows * ROW
    nstack = torch.zeros((bp, s_n + 1), dtype=torch.int32, device=device)
    nstack[:, 0] = 1                       # the root (1-based node ref)
    st = {"nstack": nstack,
          "lstack": torch.zeros((bp, s_l + 1), dtype=torch.int32,
                                device=device),
          "nptr": (tmax_p >= rays["tmin"]).to(torch.int64),
          "lptr": torch.zeros(bp, dtype=torch.int64, device=device),
          "t": tmax_p.clone(),
          "u": torch.zeros(bp, dtype=torch.float32, device=device),
          "v": torch.zeros(bp, dtype=torch.float32, device=device),
          "prim_id": torch.full((bp,), -1, dtype=torch.int32, device=device),
          "geom_id": torch.full((bp,), -1, dtype=torch.int32,
                                device=device)}
    counters = None
    if compact_stages and not debug_counters and n_rows >= 8:
        out = _traverse_staged(dev, rays, st, any_hit, s_l, compact_stages)
    else:
        if debug_counters:
            counters = {"iters": 0, "leaf_iters": 0,
                        "live_sum": np.float32(0.0)}
        _stage_loop(dev, rays, st, 0, any_hit, s_l, counters)
        out = {key: st[key] for key in _HIT_KEYS}
    out = {key: val[:b] for key, val in out.items()}
    out["t"] = torch.where(out["prim_id"] < 0, tmax.to(torch.float32),
                           out["t"])
    if counters is not None:
        out["counters"] = counters
    return out


def traverse_tiled(dev, rays, any_hit=False, stack_depth=None,
                   debug_counters=False, compact_stages=0, sub_batches=0):
    """make_rays dict ((B, 3) org/dir) -> hit dict; the contract of
    api.traverse with the options of traverse_components."""
    return traverse_components(dev, *components(rays), any_hit=any_hit,
                               stack_depth=stack_depth,
                               debug_counters=debug_counters,
                               compact_stages=compact_stages,
                               sub_batches=sub_batches)


def occluded_tiled(dev, rays):
    """Any-hit query; True where the ray is blocked."""
    return traverse_tiled(dev, rays, any_hit=True)["prim_id"] >= 0


__all__ = ["NODE_STACK_DEPTH", "LEAF_STACK_DEPTH", "traverse_components",
           "traverse_tiled", "occluded_tiled", "trips", "reset_trips"]
