"""The pair-layout traversal (port of experiments/pallas_pair.py): its plain
torch version and K6, bvh_traverse_pair, in csrc/bvh_tile.cu.

A tile of `tile_rays` consecutive rays walks the BVH with one stack whose
entries are whole nodes: the 8 children's keys (each child's minimum
entry distance over the tile, FLT_MAX for a miss or an empty slot), their
8 codes and a count of the children still to visit. A pop takes the
nearest remaining child (the lowest slot on ties, pallas_pair.py:341-363),
strips its key and lowers the count; the entry leaves the stack at 0. A
node pushes one entry if any child was hit (the unordered per-ray slab
test of :196-208, t as the pop began, no any-hit deactivation); a leaf
folds Moller-Trumbore over its 8 lanes per ray, keeping the lower lane on
ties (:251-261), and pushes its next Tri row as an entry of one child with
key 0 (:389-397). Any-hit stops a tile when every ray has its hit or is
dead (:400-406). On a miss t = tmax and the ids are -1.

Contract of pallas_pair.py:441-477 with these differences:
- BVH8 with Tri8 rows only, as there (:101, :113); tile_rays one of
  PAIR_TILES;
- `streams` (independent tiles interleaved in one TPU grid step) has no
  meaning on a card whose blocks run side by side: it is not accepted, and
  pops are counted per tile (a TPU step's count is the sum over its
  `streams` consecutive tiles);
- no pair tables: pack_tables (:87-124) lays rows out for the TPU's matrix
  unit; the port reads the normal node and Tri rows, so the ablations of
  that unit, "nomatmul" and "fastmatmul" (:174-180), raise;
- the iteration guard 4 * nodes + 4 * Tri rows + 1024 (:305) raises where
  it is reached, instead of returning a tile cut short (K6 marks the tile's
  pops -1);
- beside the pops, the leaf pops are counted per tile.

CUDA tensors launch K6 (or raise), CPU tensors take the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels.build import load_library
from . import packet
from .api import _F32_MAX, _tile_slab_keys, components, stack_entries, \
    tile_leaf_lanes, tile_pad

TILE_RAYS = 2048
PAIR_TILES = (128, 256, 512, 1024, 2048)
# pallas_pair.py's ablations with a counterpart, in the bit order of
# csrc/bvh_tile.cu (kNoStrip ... kNoLeaf)
ABLATIONS = ("nostrip", "nosort", "nonode", "noleaf")
MATMUL_ABLATIONS = ("nomatmul", "fastmatmul")
PAIR_STACK_MAX = 128     # K6's largest stack (entries of 17 words)


def check_pair(dev, tile_rays, ablate=()):
    """Validates a pair traversal's arguments; returns `ablate` sorted."""
    a = dev["nodes"].shape[1] // 7
    m = dev["tris"].shape[1] // 14
    if a != 8 or m != 8:
        raise ValueError(f"the pair traversal takes BVH8 with Tri8 rows only "
                         f"(pallas_pair.py:101, :113); got BVH{a}, Tri{m}")
    if tile_rays not in PAIR_TILES:
        raise ValueError(f"tile_rays={tile_rays}: one of {PAIR_TILES}")
    ablate = tuple(sorted(set(ablate)))
    for ab in ablate:
        if ab in MATMUL_ABLATIONS:
            raise ValueError(f"ablate {ab!r} ablates the TPU matrix unit's "
                             "broadcast of a row (pallas_pair.py:174-180); "
                             "the port reads the rows directly and has none")
        if ab not in ABLATIONS:
            raise ValueError(f"unknown ablation {ab!r}; choose from "
                             f"{ABLATIONS}")
    return ablate


def max_iters(dev):
    """The iteration guard of pallas_pair.py:305."""
    return 4 * dev["nodes"].shape[0] + 4 * dev["tris"].shape[0] + 1024


def traverse_pair_components(dev, org, dirv, inv_d, tmin, tmax,
                             any_hit=False, tile_rays=TILE_RAYS, ablate=(),
                             count_pops=False, count_rows=False):
    """The plain version of K6 on flat (B,) component rays (org, dirv,
    inv_d Vec3 tuples); every live tile pops one entry per step. Returns
    {t, u, v, prim_id, geom_id} per ray and, with count_pops=True, "pops"
    and "leaf_pops" per tile, (nt,) int32; count_rows=True adds
    "nodes_read" and "tris_read" (api.traverse_components). Ablations:
    "nostrip" (a popped child keeps its key, so the nearest child pops as
    often as the entry's count), "nosort" (the first child with a finite
    key instead of the nearest), "nonode" (a node pushes nothing),
    "noleaf" (a leaf tests no lane and never continues)."""
    ablate = check_pair(dev, tile_rays, ablate)
    nodes, tris = dev["nodes"], dev["tris"]
    device = tmin.device
    b = tmin.shape[0]
    nt = -(-b // tile_rays)
    o = [tile_pad(c, nt, tile_rays) for c in org]
    d = [tile_pad(c, nt, tile_rays) for c in dirv]
    inv = [tile_pad(c, nt, tile_rays) for c in inv_d]
    tmn = tile_pad(tmin, nt, tile_rays)
    tmx = tile_pad(tmax.to(torch.float32), nt, tile_rays, -1.0)
    t = tmx.clone()
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    prim = torch.full((nt, tile_rays), -1, dtype=torch.int32, device=device)
    geom = torch.full_like(prim, -1)

    cap = stack_entries(dev)
    keys = torch.full((nt, cap, 8), _F32_MAX, device=device)
    codes = torch.zeros((nt, cap, 8), dtype=torch.int32, device=device)
    cnt = torch.zeros((nt, cap), dtype=torch.int32, device=device)
    keys[:, 0, 0] = 0.0          # the root entry: one child, code 1
    codes[:, 0, 0] = 1
    cnt[:, 0] = 1
    sp = torch.ones(nt, dtype=torch.int64, device=device)
    done = torch.zeros(nt, dtype=torch.bool, device=device)
    pops = torch.zeros(nt, dtype=torch.int32, device=device)
    leaf_pops = torch.zeros_like(pops)
    if count_rows:
        nodes_read = torch.zeros(nodes.shape[0], dtype=torch.bool,
                                 device=device)
        tris_read = torch.zeros(tris.shape[0], dtype=torch.bool,
                                device=device)
    guard = max_iters(dev)
    step = 0
    ar = torch.arange(nt, device=device)
    while True:
        # one host sync a step: every tile's popped code, the live tiles
        # grouped by it (node, leaf, none) and the last step's overflow
        # check (its pushes write a clamped slot, so sp passes cap)
        live = (sp > 0) & ~done
        top = (sp - 1).clamp(0, cap - 1)
        kr = keys[ar, top]
        if "nosort" in ablate:
            # the first finite key; with none, slot 7 and nothing stripped
            finite = kr < _F32_MAX
            strip = finite.any(1)
            slot = torch.where(strip, torch.argmax(finite.to(torch.int8), 1),
                               7)
        else:
            low = kr <= kr.amin(1, keepdim=True)
            slot = torch.argmax(low.to(torch.int8), 1)
            strip = torch.ones_like(low[:, 0])
        code = codes[ar, top].gather(1, slot[:, None])[:, 0]
        kind = torch.where(live, torch.where(
            code > 0, 1, torch.where(code < 0, 2, 3)), 0)
        n_dead, n_node, n_leaf, _, over = torch.cat([
            torch.bincount(kind, minlength=4),
            (sp > cap).any().view(1).to(torch.int64)]).tolist()
        if over:
            raise ValueError(f"pair stack of {cap} entries overflowed")
        if n_dead == nt:
            break
        if step >= guard:
            raise ValueError(f"pair traversal reached its guard of {guard} "
                             "iterations (pallas_pair.py:305)")
        step += 1
        act = torch.argsort(kind, stable=True)[n_dead:]
        top, slot, strip, code = top[act], slot[act], strip[act], code[act]
        pops[act] += (code != 0).to(torch.int32)
        leaf_pops[act] += (code < 0).to(torch.int32)
        if "nostrip" not in ablate:
            keys[act, top, slot] = torch.where(strip, _F32_MAX,
                                               keys[act, top, slot])
        rem = cnt[act, top] - 1
        cnt[act, top] = rem
        spa = torch.where(rem <= 0, top, top + 1)

        new_keys = torch.full((act.numel(), 8), _F32_MAX, device=device)
        new_codes = torch.zeros((act.numel(), 8), dtype=torch.int32,
                                device=device)
        new_cnt = torch.zeros(act.numel(), dtype=torch.int32, device=device)
        if n_node and "nonode" not in ablate:
            tl = act[:n_node]
            rows = nodes[code[:n_node] - 1]
            if count_rows:
                nodes_read[code[:n_node] - 1] = True
            ch = rows[:, 48:56].view(torch.int32)
            kk = _tile_slab_keys(rows, 8, [c[tl] for c in o],
                                 [c[tl] for c in inv], tmn[tl], t[tl])
            kk = torch.where(ch != 0, kk, _F32_MAX)
            new_keys[:n_node] = kk
            new_codes[:n_node] = ch
            new_cnt[:n_node] = (kk < _F32_MAX).sum(1).to(torch.int32)
        if n_leaf and "noleaf" not in ablate:
            lf = slice(n_node, n_node + n_leaf)
            tl = act[lf]
            lc = code[lf]
            if count_rows:
                tris_read[~lc] = True
            rowi = tris[~lc].view(torch.int32)
            tc = t[tl]
            # the lanes fold to the leftmost smallest t, FLT_MAX for a lane
            # that fails (:246-261); then the ray takes it on best < t
            best, _, pu, pv, pp, pg = tile_leaf_lanes(
                tris, lc, [c[tl] for c in o], [c[tl] for c in d], tmn[tl],
                tc, _F32_MAX)
            pp = torch.where(pp == -1, -1, pp & 0x7FFFFFFF)
            upd = best < tc
            t[tl] = torch.where(upd, best, tc)
            u[tl] = torch.where(upd, pu, u[tl])
            v[tl] = torch.where(upd, pv, v[tl])
            prim[tl] = torch.where(upd, pp, prim[tl])
            geom[tl] = torch.where(upd, pg, geom[tl])
            cont = rowi[:, 103] >= 0     # lane 7's pid: not the last row
            new_keys[lf, 0] = torch.where(cont, 0.0, _F32_MAX)
            new_codes[lf, 0] = torch.where(cont, lc - 1, 0)
            new_cnt[lf] = cont.to(torch.int32)
        # a row that pushes nothing writes its slot's own entry back
        push = new_cnt > 0
        at = torch.clamp(spa, max=cap - 1)
        keys[act, at] = torch.where(push[:, None], new_keys, keys[act, at])
        codes[act, at] = torch.where(push[:, None], new_codes,
                                     codes[act, at])
        cnt[act, at] = torch.where(push, new_cnt, cnt[act, at])
        sp[act] = spa + push.to(torch.int64)
        if any_hit:
            done[act] = ((tmx[act] < tmn[act]) | (prim[act] >= 0)).all(1)
    miss = prim < 0
    out = {"t": torch.where(miss, tmx, t).reshape(-1)[:b],
           "u": u.reshape(-1)[:b], "v": v.reshape(-1)[:b],
           "prim_id": prim.reshape(-1)[:b],
           "geom_id": torch.where(miss, -1, geom).reshape(-1)[:b]}
    if count_pops:
        out["pops"] = pops
        out["leaf_pops"] = leaf_pops
    if count_rows:
        out["nodes_read"] = nodes_read
        out["tris_read"] = tris_read
    return out


def _launch(dev, comps, any_hit, tile_rays, ablate, cap=None, iters=None):
    """K6 on CUDA tensors; comps: the 11 (n,) ray
    components in the C entry's order (inv_dir xyz, org xyz, dir xyz,
    tmin, tmax). cap and iters replace the stack the tree needs and the
    iteration guard."""
    nodes, tris = dev["nodes"], dev["tris"]
    n = packet.check_inputs("bvh_traverse_pair", comps, nodes, tris)
    cap = stack_entries(dev) if cap is None else cap
    if not 1 <= cap <= PAIR_STACK_MAX:
        raise ValueError(f"a stack of {cap} entries: bvh_traverse_pair "
                         f"holds 1 to {PAIR_STACK_MAX}")
    nt = -(-n // tile_rays)
    device = nodes.device

    def empty(dtype, size=n):
        return torch.empty(size, dtype=dtype, device=device)

    out = {"t": empty(torch.float32), "u": empty(torch.float32),
           "v": empty(torch.float32), "prim_id": empty(torch.int32),
           "geom_id": empty(torch.int32), "pops": empty(torch.int32, nt),
           "leaf_pops": empty(torch.int32, nt)}
    if n == 0:
        return out
    mask = sum(1 << ABLATIONS.index(ab) for ab in ablate)
    lib = load_library(kind="tile")
    ptrs = (ctypes.c_void_p * 11)(*(x.data_ptr() for x in comps))
    err = packet.call_on_card(
        device, lib.rt_bvh_traverse_pair, nodes.data_ptr(), tris.data_ptr(),
        ptrs, n, tile_rays, int(bool(any_hit)), cap, mask,
        max_iters(dev) if iters is None else iters,
        *(out[k].data_ptr() for k in ("t", "u", "v", "prim_id", "geom_id",
                                      "pops", "leaf_pops")))
    if err != 0:
        raise RuntimeError(f"bvh_traverse_pair launch failed with CUDA "
                           f"error {err}")
    packet.launches["bvh_traverse_pair"] += 1
    return out


def traverse_pair_packet_components(dev, org, dirv, inv_d, inv_o, tmin, tmax,
                                    any_hit=False, tile_rays=TILE_RAYS,
                                    ablate=(), count_pops=False):
    """The pair traversal on component rays (the packet contract of
    traversal/packet.py): K6 on CUDA tensors, the plain version on CPU
    tensors. A tile that would overflow its stack or reach the guard (the
    plain version raises there) stops in K6 with its pops -1, which
    count_pops=True returns; the wrapper does not synchronise to look."""
    del inv_o
    ablate = check_pair(dev, tile_rays, ablate)
    if tmin.device.type == "cuda":
        out = _launch(dev, [*inv_d, *org, *dirv, tmin, tmax], any_hit,
                      tile_rays, ablate)
        if not count_pops:
            del out["pops"], out["leaf_pops"]
        return out
    if tmin.device.type == "cpu":
        return traverse_pair_components(dev, org, dirv, inv_d, tmin, tmax,
                                        any_hit, tile_rays, ablate,
                                        count_pops)
    raise ValueError(f"traverse_pair: unsupported device {tmin.device}")


def traverse_pair(dev, rays, any_hit=False, tile_rays=TILE_RAYS, ablate=(),
                  count_pops=False):
    """traverse_pair_packet_components over a make_rays dict."""
    return traverse_pair_packet_components(
        dev, *components(rays), any_hit=any_hit, tile_rays=tile_rays,
        ablate=ablate, count_pops=count_pops)
