"""A CPU rehearsal of the group stack of csrc/bvh_traverse.cu.

The kernel's second body keeps one stack entry per expanded node: the
node's row index and its hit slots still to visit, 3 bits a slot, with
their count, in one 64-bit word. A node's first hit child and a leaf's
next row are the next pop through a register; the other hit children
form the current group, which lives in registers: a pop takes its next
slot and re-reads that child's code from the node row; expanding a node
with two or more hit children pushes the current group if it still has
slots. The claim is
that it pops exactly the entries of the first body (one entry per hit
child), in the same order, so it returns the same bits and counts the same
pops, and that its stack never holds more than the tree's depth.

The walker below is a test-only numpy copy of that discipline, one ray at
a time, in the float32 operation order of the plain version. It is held
against rodent_tpu_torch.traversal.api.traverse_components (the plain
version of K1 and K3) on small random soups and a make_hall(2_000) scene,
closest- and any-hit: hits bit for bit, pop counts equal, and its deepest
stack within the tree's depth and the compiled cap that
rodent_tpu_torch.experiments.ab_body.group_cap picks for it.
"""
import numpy as np
import pytest
import torch

from rodent_tpu_torch.accel import build_bvh
from rodent_tpu_torch.experiments import ab_body
from rodent_tpu_torch.traversal import api
from rodent_tpu_torch.utils import testscenes
from test_traversal import random_tri_soup

torch.set_num_threads(1)

F32 = np.float32


def pack(node, slots, count):
    """A group as the kernel's 64-bit stack word: the row index low, the
    slots (3 bits each, 24 bits) and the count (bits 24-27) high."""
    return node | (slots | count << 24) << 32


def unpack(word):
    hi = word >> 32
    return word & 0xFFFFFFFF, hi & 0xFFFFFF, hi >> 24


def node_slots(row, a, o, inv, tmin, t_cur, any_hit):
    """The hit slots of one node row in visit order: slab tests as
    api._node_step computes them, then for closest-hit the Batcher network
    over (entry key, slot)."""
    child = row[6 * a:].view(np.int32)
    with np.errstate(over="ignore"):     # inv_dir is finite, a product not
        ts = [(row[k * a:(k + 1) * a] - o[k // 2]) * inv[k // 2]
              for k in range(6)]
    entry = np.maximum(np.maximum(np.minimum(ts[0], ts[1]),
                                  np.minimum(ts[2], ts[3])),
                       np.maximum(np.minimum(ts[4], ts[5]), tmin))
    exit_ = np.minimum(np.minimum(np.maximum(ts[0], ts[1]),
                                  np.maximum(ts[2], ts[3])),
                       np.minimum(np.maximum(ts[4], ts[5]), t_cur))
    hit = list((entry <= exit_) & (child != 0))
    slot = list(range(a))
    if not any_hit:
        key = list(np.where(hit, entry, F32(np.inf)))
        for i, j in api._SORT_NETWORKS[a]:
            if key[i] > key[j]:
                key[i], key[j] = key[j], key[i]
                slot[i], slot[j] = slot[j], slot[i]
                hit[i], hit[j] = hit[j], hit[i]
    return [s for s, h in zip(slot, hit) if h]


def leaf_row(row, m, o, d, tmin, t_cur):
    """Moller-Trumbore over one Tri-M row as api._leaf_step computes it:
    ((t, u, v, prim, geom) of the lane taken, or None; whether the row is
    its leaf's last)."""
    rowi = row.view(np.int32)
    col = [row[k * m:(k + 1) * m] for k in range(12)]
    v0, e1, e2, nn = col[0:3], col[3:6], col[6:9], col[9:12]
    pid, gid = rowi[12 * m:13 * m], rowi[13 * m:]
    cx, cy, cz = v0[0] - o[0], v0[1] - o[1], v0[2] - o[2]
    rx = d[1] * cz - d[2] * cy
    ry = d[2] * cx - d[0] * cz
    rz = d[0] * cy - d[1] * cx
    det = nn[0] * d[0] + nn[1] * d[1] + nn[2] * d[2]
    abs_det = np.abs(det)
    sign = np.where(det < 0, F32(-1.0), F32(1.0))
    uu = (rx * e2[0] + ry * e2[1] + rz * e2[2]) * sign
    vv = (rx * e1[0] + ry * e1[1] + rz * e1[2]) * sign
    tt = (cx * nn[0] + cy * nn[1] + cz * nn[2]) * sign
    ok = ((uu >= 0) & (vv >= 0) & (uu + vv <= abs_det) & (abs_det != 0)
          & (tt >= abs_det * tmin) & (tt <= abs_det * t_cur) & (pid != -1))
    inv_det = F32(1.0) / np.where(abs_det != 0, abs_det, F32(1.0))
    tv = np.where(ok, tt * inv_det, F32(np.inf))
    lane = int(np.argmin(tv))           # the first lane of the minimum
    last = bool(pid[m - 1] < 0)
    if not tv[lane] < t_cur:
        return None, last
    return (tv[lane], uu[lane] * inv_det[lane], vv[lane] * inv_det[lane],
            int(pid[lane] & 0x7FFFFFFF), int(gid[lane])), last


def walk(nodes, tris, o, d, inv, tmin, tmax, any_hit):
    """One ray through the group stack: ((t, u, v, prim, geom), pops,
    leaf pops, deepest stack)."""
    a, m = nodes.shape[1] // 7, tris.shape[1] // 14
    best = (tmax, F32(0.0), F32(0.0), -1, -1)
    stack = []
    node, slots, count = 0, 0, 0          # the current group
    nxt = 1 if tmax >= tmin else 0        # root, then a leaf's next row
    pops = leaf_pops = deepest = 0
    while True:
        code, nxt = nxt, 0
        if code == 0:
            if count == 0:
                if not stack:
                    break
                node, slots, count = unpack(stack.pop())
            code = int(nodes[node, 6 * a:].view(np.int32)[slots & 7])
            slots >>= 3
            count -= 1
        pops += 1
        if code > 0:
            hit = node_slots(nodes[code - 1], a, o, inv, tmin, best[0],
                             any_hit)
            if hit:                     # the first hit child pops next
                nxt = int(nodes[code - 1, 6 * a:].view(np.int32)[hit[0]])
            if len(hit) > 1:            # the others become the group
                if count:
                    stack.append(pack(node, slots, count))
                    deepest = max(deepest, len(stack))
                node, count = code - 1, len(hit) - 1
                slots = sum(s << (3 * k) for k, s in enumerate(hit[1:]))
        else:
            leaf_pops += 1
            got, last = leaf_row(tris[~code], m, o, d, tmin, best[0])
            if got is not None:
                best = got
            if not last:
                nxt = code - 1
            if any_hit and got is not None:
                break
    return best, pops, leaf_pops, deepest


def walk_all(dev, rays, any_hit):
    nodes, tris = dev["nodes"].numpy(), dev["tris"].numpy()
    o, d, inv, _, tmin, tmax = [
        np.stack([x.numpy() for x in c]) if isinstance(c, tuple)
        else c.numpy() for c in api.components(rays)]
    out = {k: [] for k in ("t", "u", "v", "prim_id", "geom_id", "pops",
                           "leaf_pops")}
    deepest = 0
    for i in range(tmin.shape[0]):
        hit, pops, leaf, deep = walk(nodes, tris, o[:, i], d[:, i],
                                     inv[:, i], tmin[i], tmax[i], any_hit)
        for k, val in zip(("t", "u", "v", "prim_id", "geom_id"), hit):
            out[k].append(val)
        out["pops"].append(pops)
        out["leaf_pops"].append(leaf)
        deepest = max(deepest, deep)
    dtypes = {"t": np.float32, "u": np.float32, "v": np.float32}
    return {k: np.array(v, dtypes.get(k, np.int32)) for k, v in out.items()}, \
        deepest


def _child(dev):
    a = dev["nodes"].shape[1] // 7
    return dev["nodes"][:, 6 * a:].contiguous().view(torch.int32).numpy()


def _chain(depth):
    """Device tables of a BVH2 whose inner nodes form one chain of the
    given depth (each row's slot 0 the next row, slot 1 a leaf)."""
    child = np.zeros((depth + 1, 2), np.int32)
    child[:, 1] = ~0
    child[:-1, 0] = np.arange(2, depth + 2)
    child[-1, 0] = ~0
    nodes = np.zeros((depth + 1, 14), np.float32)
    nodes[:, 12:] = child.view(np.float32)
    return {"nodes": torch.from_numpy(nodes)}


def _soup(arity, m, seed):
    verts, idx = random_tri_soup(300, seed=seed)
    return api.bvh_to_device(build_bvh(verts, idx, arity=arity, packet=m),
                             "cpu")


def _rays(n, seed, tmax):
    r = np.random.RandomState(seed)
    org = r.randn(n, 3).astype(np.float32) * 3.0
    d = r.randn(n, 3).astype(np.float32)
    d[:8, 0] = 0.0                      # axis-parallel rays
    tm = np.full(n, tmax, np.float32)
    tm[8:12] = -1.0                     # dead rays
    return api.make_rays(org, d, 0.0, tm)


def _check(dev, rays, any_hit):
    got, deepest = walk_all(dev, rays, any_hit)
    want = api.traverse(dev, rays, any_hit=any_hit, count_pops=True)
    for key, val in want.items():       # bit for bit: floats as int32
        np.testing.assert_array_equal(got[key].view(np.int32),
                                      val.numpy().view(np.int32), err_msg=key)
    depth = ab_body.compute_depth(_child(dev))
    assert deepest <= depth <= ab_body.group_cap(dev)
    return deepest


@pytest.mark.parametrize("arity,m", [(2, 4), (4, 8), (8, 8), (8, 24)])
@pytest.mark.parametrize("any_hit", [False, True])
def test_group_stack_matches_plain_on_soups(arity, m, any_hit):
    """Random 300-triangle soups, 160 rays (axis-parallel and dead ones
    among them): the walker's hits equal the plain version's bit for bit,
    its pops and leaf pops equal the plain counters, and its deepest stack
    stays within the tree's depth."""
    dev = _soup(arity, m, seed=10 * arity + m)
    rays = _rays(160, seed=arity + m, tmax=2.0 if any_hit else 1e30)
    deepest = _check(dev, rays, any_hit)
    assert deepest >= 1


@pytest.mark.parametrize("any_hit", [False, True])
def test_group_stack_matches_plain_on_hall(any_hit):
    """make_hall(2_000) as BVH8/Tri8, 16x16 primaries (any-hit: cut at
    t 2): the same three claims."""
    verts, idx = testscenes.make_hall(2_000)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8),
                            "cpu")
    org, d = testscenes.hall_primary_rays(16, 16)
    rays = api.make_rays(org, d, 0.0, 2.0 if any_hit else 1e30)
    _check(dev, rays, any_hit)


def test_compute_depth_and_group_cap():
    """compute_depth counts inner levels below the root; group_cap picks
    the smallest compiled stack that holds it and refuses deeper trees."""
    assert ab_body.compute_depth(np.array([[~0, 0]], np.int32)) == 0
    chain = np.array([[2, ~0], [3, ~1], [~2, ~3]], np.int32)
    assert ab_body.compute_depth(chain) == 2
    with pytest.raises(ValueError, match="not a tree"):
        ab_body.compute_depth(np.array([[1, 0]], np.int32))
    assert ab_body.compute_depth(_child(_chain(5))) == 5
    assert ab_body.group_cap(_soup(2, 4, seed=3)) == ab_body.GROUP_CAPS[0]
    for depth, cap in ((16, 16), (17, 64), (64, 64)):
        assert ab_body.group_cap(_chain(depth)) == cap
    with pytest.raises(ValueError, match="depth 65"):
        ab_body.group_cap(_chain(65))


def test_body_argument():
    """ab_body.launch runs K1-K3 in either body from the group library on
    the card; on the CPU both bodies are the plain version, with K3's
    counters. It takes an entry of BODIES and of VARIANTS only."""
    dev = _soup(8, 8, seed=4)
    rays = _rays(64, seed=5, tmax=1e30)
    comps = api.components(rays)
    want = api.traverse(dev, rays, count_pops=True)
    for body in ab_body.BODIES:
        for variant in ab_body.VARIANTS:
            got = ab_body.launch(dev, comps, variant, body=body)
            keys = want if variant == "K3" else ("t", "u", "v", "prim_id",
                                                 "geom_id")
            assert set(got) == set(keys)
            for key in keys:
                assert torch.equal(got[key], want[key]), (body, key)
    for kw in (dict(body="v2"), dict(variant="K4")):
        with pytest.raises(ValueError, match="ab_body.launch"):
            ab_body.launch(dev, comps, **kw)
