"""What the port's traversal tools share: the scenes at their full size
and their BVH builds, the ray distributions, the card's name and power
limit, CUDA-event timing (in turns), per-warp and per-tile pop statistics,
and the least time the card could take for a traversal launch (its bound,
per-ray kernels and tile kernels); for the micro-probes (probe_*.py,
vpu_dtype_bench.py), the call into their library, the launch that fills
the card and their bound; and a reader of the card's assembly (SASS, as
cuobjdump and nvdisasm print it) for vpu_dtype_bench and sass_audit; and
a box with a ceiling lamp, closed and open, as OBJ + MTL text (the cornell
programs' stand-in). The experiments here, tools/benchmark.py and
chip_smoke.py all take them from this module."""
from __future__ import annotations

import ctypes
import dataclasses
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..accel import build_bvh
from ..core.math import FLT_MAX
from ..kernels.build import find_nvcc, load_library
from ..traversal import api, packet, pair
from ..traversal.sorting import sort_rays
from ..utils import testscenes

# scene -> its full size, the generator's target_tris (the generators and
# primary-ray fixtures are testscenes.SCENES): hall-260K, crown-800K and
# powerplant-4.3M (make_powerplant(5_000_000) makes 4,347,968 triangles)
SIZES = {"hall": 260_000, "crown": 800_000, "powerplant": 5_000_000}
# BVH8 builds: Tri8 leaves (bench.py's primary row) and the big-scene
# Tri24 build (bench.py:174-175), binned SAH (quality 0) to keep the
# multi-million-triangle build tractable, with cheap DP leaves
TRI8 = {"packet": 8, "leaf_threshold": 12}
TRI24 = {"packet": 24, "quality": 0, "leaf_threshold": 12,
         "leaf_cost": 0.45}
# powerplant-4.3M's render camera (eye, look at, up, fov): chip_smoke.py
# phase 9's persistent render and the pool step ab_body times
BIG_CAM = ((-30.0, 60.0, -30.0), (130.0, -40.0, 130.0), (0, 1, 0), 55.0)
DISTS = ("primary", "primary-unsorted", "ao", "bounces", "bounces-unsorted")
WARP = 32
# seconds of calls before a run's first timed turn: a card left idle, as
# during a scene build, runs its first launches at lower clocks
WARMUP_S = 0.5

# NVIDIA's published H100 SXM peaks at 700 W: float32 outside the tensor
# cores, and device memory
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
# Operations per pop, counted from csrc/bvh_traverse.cu (adds, multiplies,
# min/max, compares, selects and logical operations on a ray's values;
# loads, stores and loop control not counted):
#   one child's slab test (slab_test): 6 subtracts, 6 multiplies, 6 min/max
#     of the pairs, 6 min/max into entry and exit, entry <= exit, child !=
#     0, their and, the key's select = 28;
#   one child's push: its count, its test, two index operations = 4;
#   the Batcher network (sort_children): 1 compare and 6 selects for each
#     of its 1/5/19 exchanges at arity 2/4/8;
#   one Tri lane (mt_lane): 3 (org offset) + 9 (cross product) + 5 (det)
#     + 1 (abs) + 2 (sign) + 18 (u, v, t) + 14 (the accept test) + 3 (the
#     reciprocal) + 1 (t) + 2 (the strict < and its and) + 1 (pid == -1)
#     = 59;
#   a Tri row's continuation: its test and its push = 2.
SLAB_OPS, PUSH_OPS, LANE_OPS, CONT_OPS = 28, 4, 59, 2
SORT_SWAPS = {2: 1, 4: 5, 8: 19}
# K7, the carry-top body (csrc/bvh_ct.cu), per node pop:
#   one child's ordered slab test: 6 planes of a multiply and an add (the
#     fused form's FMA counts as both, as the unfused subtract and
#     multiply) = 12, 6 min/max into entry and exit, entry <= exit and the
#     key's select, child != 0, key < FLT_MAX and their and, the key's and
#     the child's selects = 25;
#   one child's push as K1's (PUSH_OPS);
#   the choice: the min-fold's compare and 2 selects for each of A - 1
#     slots, any-hit's compare and select for each of A slots, or Batcher's
#     network, 1 compare and 4 selects an exchange (no hit mask to swap);
#   a leaf pop as K1's (LANE_OPS a lane, CONT_OPS).
CT_SLAB_OPS = 25
# The tile kernels (csrc/bvh_tile.cu), where a node pop tests every ray of
# the tile against every child:
#   one ray and child, pure slab form (slab_key<true>): 6 subtracts, 6
#     multiplies, 6 min/max into entry and exit, entry <= exit, the key's
#     select and the tile minimum = 21; the mixed form adds the 6 min/max
#     of the pairs = 27;
#   one 128-ray row and child of a frustum pop: per axis 2 subtracts, 2
#     compares, 2 selects and 2 multiplies, 4 min/max across the axes,
#     the row's tmin and t, entry <= exit, the key's select and the
#     minimum over rows = 33; and per ray, its t into the row's largest;
#   any-hit: the done ray's -FLT_MAX, a compare and a select per ray and
#     pop;
#   K6's Tri lane: mt_test (59 less the strict < and its and), the
#     FLT_MAX select of a failed lane and the fold's compare and 5 selects
#     = 63.
TILE_PURE_OPS, TILE_MIXED_OPS, FRUSTUM_OPS, PAIR_LANE_OPS = 21, 27, 33, 63


# A closed box with a ceiling lamp (14 triangles, the dense tier), and the
# same box open at z = +1 (12 triangles): chip_smoke.py phase 16's engines
# and tools, and the cornell programs' stand-in (ab_cornell_engine)
BOX_OBJ = """mtllib box.mtl
v -1 0 -1
v  1 0 -1
v  1 2 -1
v -1 2 -1
v -1 0  1
v  1 0  1
v  1 2  1
v -1 2  1
v -0.3 1.99 -0.3
v  0.3 1.99 -0.3
v  0.3 1.99  0.3
v -0.3 1.99  0.3
usemtl wall
f 1 2 3 4
f 5 8 7 6
f 1 5 6 2
f 4 3 7 8
usemtl red
f 1 4 8 5
usemtl green
f 2 6 7 3
usemtl lamp
f 9 10 11 12
"""
BOX_MTL = """newmtl wall
Kd 0.8 0.8 0.8
newmtl red
Kd 0.6 0.1 0.1
newmtl green
Kd 0.1 0.6 0.1
Ks 0.2 0.2 0.2
Ns 20
newmtl lamp
Ke 6 6 6
"""
BOX_FRONT = "f 5 8 7 6\n"


def write_boxes(out_dir):
    """Writes the closed and the open box (OBJ + MTL) into out_dir and
    returns their paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "box.mtl").write_text(BOX_MTL)
    paths = []
    for name, text in (("box", BOX_OBJ),
                       ("open", BOX_OBJ.replace(BOX_FRONT, ""))):
        paths.append(str(out_dir / f"{name}.obj"))
        Path(paths[-1]).write_text(text)
    return paths


def add_args(p):
    p.add_argument("--cpu", action="store_true",
                   help="the plain torch version on the CPU, at small "
                        "sizes: no number of such a run is a card's")
    p.add_argument("--blocks", type=int, default=5,
                   help="timed blocks per turn (the median is kept)")


def device_of(args, prog):
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        sys.exit(f"{prog}: no CUDA card; pass --cpu to run the plain "
                 "version on the CPU")
    return torch.device("cuda")


def card(device):
    """The card's name and power limit as nvidia-smi gives them, the line
    every time of a run stands beside; on the CPU, a line saying that no
    number of the run is a card's."""
    if device.type != "cuda":
        return ("cpu: the plain torch version, host clock; not a card "
                "measurement")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sm_clock_mhz():
    """The card's SM clock now and its largest, in MHz, as nvidia-smi
    reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    now, top = (float(x) for x in out.split(","))
    return now, top


def device_idle(fn):
    """One call of fn under torch.profiler on the card: {"wall_ms",
    "kernel_ms" (the kernels' device time), "busy_ms" (the union of their
    spans), "idle" (the share of the wall time the device ran no kernel),
    "kernels"}. fn must end in work on the card; the call is synchronised
    before the clock stops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_ms": wall,
            "kernel_ms": sum(e.time_range.elapsed_us() for e in dev) * 1e-3,
            "busy_ms": busy * 1e-3, "idle": 1.0 - busy * 1e-3 / wall,
            "kernels": len(dev)}


def build_of(scene):
    """The BVH8 build a scene is traced with: the big-scene Tri24 build for
    powerplant, Tri8 for the rest."""
    return TRI24 if scene == "powerplant" else TRI8


def load(scene, build, device, tris=None):
    """(verts, idx, device tables, seconds) of a procedural scene and its
    BVH8 build."""
    make = testscenes.SCENES[scene][0]
    t0 = time.perf_counter()
    verts, idx = make(tris or SIZES[scene])
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, **build), device)
    return verts, idx, dev, time.perf_counter() - t0


def interleave(a, b):
    """Two sets of ray components (api.components' tuples, of one length)
    merged ray by ray: a's first ray, b's first, a's second, ..."""
    if isinstance(a, tuple):
        return tuple(interleave(x, y) for x, y in zip(a, b))
    return torch.stack([a, b], 1).reshape(-1)


def distributions(scene, verts, idx, dev, side, device, kinds=DISTS):
    """{kind: (ray components, any_hit)} of side x side rays: the scene's
    primaries, sorted (octant + Morton key) or, as "primary-unsorted", in
    pixel order; "ao" (any-hit) and "bounces" rays from the primaries' hit
    points (testscenes.secondary_rays_from_trace, the fixture of the JAX
    package's benchmarks), sorted unless the kind ends in "-unsorted";
    "interleaved" (closest-hit), the sorted primaries and bounces merged
    ray by ray (interleave), twice the rays, so that nearly every warp
    holds rays at node pops and rays at leaf pops at once."""
    if "interleaved" in kinds:
        rest = dict.fromkeys([k for k in kinds if k != "interleaved"]
                             + ["primary", "bounces"])
        out = distributions(scene, verts, idx, dev, side, device, rest)
        out["interleaved"] = (interleave(out["primary"][0],
                                         out["bounces"][0]), False)
        return {k: out[k] for k in kinds}
    org, dirs = testscenes.SCENES[scene][1](side, side)
    lo, hi = verts.min(0), verts.max(0)
    prim = api.make_rays(org, dirs, 0.0, FLT_MAX, device=device)
    out, hit = {}, None
    for kind in kinds:
        base, _, order = kind.partition("-")
        rays = prim
        if base != "primary":
            if hit is None:
                hit = packet.traverse_packet(dev, prim)
            o2, d2, tmin2, tmax2 = testscenes.secondary_rays_from_trace(
                base, org, dirs, hit["t"].cpu().numpy(),
                hit["prim_id"].cpu().numpy(), verts, idx.reshape(-1, 4))
            rays = api.make_rays(o2, d2, tmin2, tmax2, device=device)
        if order != "unsorted":
            rays = sort_rays(rays, lo, hi)[0]
        out[kind] = (api.components(rays), base == "ao")
    return out


def samples(fn, device, blocks=5, block_ms=20.0, warmup_s=0.0, calls=None):
    """(milliseconds per call of each of `blocks` blocks, last result).
    On a card: one warm-up call timed with CUDA events, more calls until
    warmup_s seconds have passed (WARMUP_S before a run's first turn), then
    blocks of back-to-back calls between two events, each block about
    block_ms long, or of `calls` calls where that is given.
    A call of over half a second is its own warm-up: its first time is
    the first sample, and at most 3 blocks of one call are taken. On the
    CPU: one call per block on the host clock. `fn` must not synchronise,
    or the host's time between launches is timed with it."""
    if device.type != "cuda":
        out = []
        for _ in range(blocks):
            t0 = time.perf_counter()
            res = fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out, res
    t0 = time.perf_counter()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = fn()
    e1.record()
    torch.cuda.synchronize()
    first = e0.elapsed_time(e1)
    while time.perf_counter() - t0 < warmup_s:
        res = fn()
        torch.cuda.synchronize()
    iters = calls or max(1, min(50, int(np.ceil(block_ms
                                                / max(first, 1e-3)))))
    out = []
    if first > 500.0:
        blocks = min(blocks, 3) - 1
        out.append(first)
    for _ in range(blocks):
        e0.record()
        for _ in range(iters):
            res = fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / iters)
    return out, res


def timed(fn, device, blocks=5, block_ms=20.0, warmup_s=0.0):
    """(median milliseconds per call over the blocks of samples(), last
    result)."""
    ms, res = samples(fn, device, blocks, block_ms, warmup_s)
    return float(np.median(ms)), res


def rounds(fns, device, blocks=5, warmup_s=0.0, graphs=False):
    """Calls timed in turns: each of fns in order, then in reverse order
    (A, B, C, C, B, A), the first turn after warmup_s seconds of warm-up;
    with graphs, each turn as CUDA-graph replays (launch_ms, no warm-up).
    Returns (each call's ms, the mean of its two turns; each call's last
    result)."""
    ms = [0.0] * len(fns)
    res = [None] * len(fns)
    order = list(range(len(fns)))
    for j, i in enumerate(order + order[::-1]):
        if graphs:
            t, res[i] = launch_ms(fns[i], device, blocks)
        else:
            t, res[i] = timed(fns[i], device, blocks,
                              warmup_s=warmup_s if j == 0 else 0.0)
        ms[i] += t / 2
    return ms, res


def in_turns(first, second, device, blocks=5, warmup_s=0.0):
    """Two calls timed in turns (first, second, second, first), the first
    turn after warmup_s seconds of warm-up. Returns (first's ms, second's
    ms, first's result, second's result), each time the mean of its two
    turns."""
    (a, b), (ra, rb) = rounds([first, second], device, blocks, warmup_s)
    return a, b, ra, rb


def pop_stats(out):
    """Pop statistics of a counted run ("pops" and "leaf_pops" per ray in
    launch order; a warp is 32 consecutive rays): totals over the rays,
    means per ray, and the means over warps of each warp's largest count,
    since a warp runs as long as its longest ray. Raises where a ray's
    stack overflowed (K4 with pops=2 marks it -1)."""
    pops = out["pops"].to(torch.int64)
    leaf = out["leaf_pops"].to(torch.int64)
    n = pops.shape[0]
    if n and int(pops.min()) < 0:
        raise RuntimeError("a ray's traversal stack overflowed (pops -1)")

    def warp_max(x):
        x = torch.nn.functional.pad(x, (0, (-n) % WARP))
        return float(x.view(-1, WARP).max(1).values.double().mean())

    s = {"n": n, "pops": int(pops.sum()), "leaf": int(leaf.sum())}
    s["node"] = s["pops"] - s["leaf"]
    s["pops_ray"] = s["pops"] / n
    s["leaf_ray"] = s["leaf"] / n
    s["warp_pops"] = warp_max(pops)
    s["warp_node"] = warp_max(pops - leaf)
    s["warp_leaf"] = warp_max(leaf)
    return s


def counted(dev, comps, any_hit=False, option=None):
    """One counted launch, K3 or K4 with `option`, without synchronising
    (pop_stats checks the counters)."""
    kw = packet.OPTION_ARGS[option] if option else {}
    return packet.traverse_packet_components(dev, *comps, any_hit=any_hit,
                                             count_pops=True, **kw)


def counted_tile(dev, comps, any_hit=False, tile_rows=16, frustum=False,
                 ablate=()):
    """One counted launch of the tile route (K5 on the card), without
    synchronising: per-tile "pops" and "leaf_pops" beside the hits."""
    return packet.traverse_packet_components(
        dev, *comps, any_hit=any_hit, count_pops=True, tile_rows=tile_rows,
        frustum=frustum, ablate=ablate)


def counted_pair(dev, comps, any_hit=False, tile_rays=pair.TILE_RAYS,
                 ablate=()):
    """One counted launch of the pair traversal (K6 on the card)."""
    return pair.traverse_pair_packet_components(
        dev, *comps, any_hit=any_hit, tile_rays=tile_rays, ablate=ablate,
        count_pops=True)


def ct_plain(dev, comps, any_hit=False, select="fold", fma_slab=True):
    """K7's plain version on these rays (api.traverse_ct_components) with
    its counters and the rows it reads: its hits, "pops", "leaf_pops",
    "nodes_read" and "tris_read", which K7 must equal and its bound counts
    (bound_ms with select=)."""
    return api.traverse_components(
        dev, comps[0], comps[1], comps[2], comps[4], comps[5],
        any_hit=any_hit, count_pops=True, count_rows=True, carry_top=True,
        select=select, fma_slab=fma_slab)


def tile_stats(out, size, n_rays):
    """Pop statistics of a counted tile run ("pops" and "leaf_pops" per
    tile of `size` rays): totals, the mean and the largest pops per tile,
    and the pops per ray-equivalent, the pops a ray would make if each
    tile pop were one per ray (total pops x size / rays,
    experiments/measure_packet.py:125-127). Raises where a tile stopped
    (pops -1)."""
    pops = out["pops"].to(torch.int64)
    leaf = out["leaf_pops"].to(torch.int64)
    if pops.numel() and int(pops.min()) < 0:
        raise RuntimeError("a tile's stack overflowed or reached its "
                           "iteration guard (pops -1)")
    s = {"tiles": pops.numel(), "pops": int(pops.sum()),
         "leaf": int(leaf.sum())}
    s["node"] = s["pops"] - s["leaf"]
    s["mean"] = s["pops"] / max(s["tiles"], 1)
    s["max"] = int(pops.max()) if pops.numel() else 0
    s["ray_equiv"] = s["pops"] * size / max(n_rays, 1)
    return s


def tile_bound_ms(dev, out, size, n_rays, rows, any_hit=False, pure=None,
                  frustum=False, nopure=False, pair_kernel=False):
    """bound_ms for the tile kernels: the work of a tile pop is the pop
    times the tile's `size` rays (a frustum node pop on a pure tile: its
    tile_rows x 8 interval tests and each ray's t into its row's largest),
    over the float32 peak, against the bytes of the rays, the per-tile
    counters and the table rows read once (rows, as in bound_ms). out: a
    counted run ("pops", "leaf_pops" per tile); pure: the tiles' octant
    purity (api.tile_purity), where K5 takes the pure slab form or, with
    frustum, the frustum test; pair_kernel: K6 (mixed form, no any-hit
    deactivation, its lane fold). Returns (ms, "operations" or
    "bytes")."""
    a = dev["nodes"].shape[1] // 7
    m = dev["tris"].shape[1] // 14
    node = (out["pops"] - out["leaf_pops"]).double()
    leaf = out["leaf_pops"].double()
    ah = 2 if any_hit and not pair_kernel else 0
    per_pop = a * PUSH_OPS + (0 if any_hit else 7 * SORT_SWAPS[a])
    mixed = size * (a * TILE_MIXED_OPS + ah) + per_pop
    if pair_kernel:
        node_ops = torch.full_like(node, float(mixed))
        leaf_ops = size * m * PAIR_LANE_OPS + CONT_OPS
    else:
        if frustum:
            fast = size // 128 * a * FRUSTUM_OPS + size * (1 + ah) + per_pop
        else:
            fast = size * (a * TILE_PURE_OPS + ah) + per_pop
        use = pure.to(node.device) & (not nopure)
        node_ops = torch.where(use, float(fast), float(mixed))
        leaf_ops = size * (m * LANE_OPS + ah) + CONT_OPS
    ops = float((node * node_ops).sum()) + float(leaf.sum()) * leaf_ops
    t_ops = ops / PEAK_OPS
    t_bytes = (n_rays * 64 + node.numel() * 8 + rows[0] * 28 * a
               + rows[1] * 56 * m) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def option_turns(dev, comps, device, options, any_hit=False, blocks=5):
    """Each K4 option against K3 in turns (K3, option, option, K3) on the
    same rays, counters on for both, after WARMUP_S seconds of K3 calls.
    Returns {option: {"ms", "k3_ms", "out"}} and, under "K3", K3's mean
    time over all turns and its result."""
    def run(option=None):
        return lambda: counted(dev, comps, any_hit, option)

    res, k3 = {}, []
    for i, name in enumerate(options):
        k3_ms, ms, k3_out, out = in_turns(run(), run(name), device, blocks,
                                          WARMUP_S if i == 0 else 0.0)
        res[name] = {"ms": ms, "k3_ms": k3_ms, "out": out}
        res["K3"] = {"out": k3_out}
        k3.append(k3_ms)
    if options:
        res["K3"]["ms"] = float(np.mean(k3))
    return res


def head(comps, k):
    """The first k rays of a ray components tuple (api.components)."""
    return tuple(tuple(c[:k] for c in x) if isinstance(x, tuple) else x[:k]
                 for x in comps)


def plain_args(option):
    """The plain version's arguments for K4's `option` (row_loads changes
    nothing the plain version computes)."""
    if option is None:
        return {}
    return {k: v for k, v in packet.OPTION_ARGS[option].items()
            if k != "row_loads"}


def rows_read(dev, comps, any_hit=False, option=None, ct=None):
    """(node rows, Tri rows) of the tables that a launch on these rays
    reads at least once, counted by the plain version (count_rows=True)
    with K4's `option`, or with ct, K7's {"select", "fma_slab"}, by the
    carry-top body's. nonodetest is not run: its rays pop the whole tree,
    so it reads every row."""
    if option == "nonodetest":
        return dev["nodes"].shape[0], dev["tris"].shape[0]
    kw = dict(carry_top=True, **ct) if ct else plain_args(option)
    out = api.traverse_components(dev, comps[0], comps[1], comps[2],
                                  comps[4], comps[5], any_hit=any_hit,
                                  count_rows=True, **kw)
    return int(out["nodes_read"].sum()), int(out["tris_read"].sum())


def pop_ops(arity, m, any_hit=False, option=None, select=None):
    """(operations per node pop, per Tri row) of a traversal kernel, from
    the counts above; option: K4's option; select: K7's ("fold" or
    "sort"), for the carry-top body."""
    leaf = CONT_OPS + (0 if option == "noleaftest" else m * LANE_OPS)
    if select is not None:
        node = arity * (CT_SLAB_OPS + PUSH_OPS)
        if any_hit:
            node += 2 * arity
        elif select == "fold":
            node += 3 * (arity - 1)
        else:
            node += 5 * SORT_SWAPS[arity]
        return node, leaf
    node = arity * (SLAB_OPS + PUSH_OPS)
    if not any_hit and option != "nosort":
        node += 7 * SORT_SWAPS[arity]
    if option == "nonodetest":
        node = arity * PUSH_OPS
    return node, leaf


def bound_ms(dev, n_rays, node_pops, tri_rows, rows, any_hit=False,
             option=None, counters=False, select=None):
    """The least time the card could take for one traversal launch, and
    what binds it: the larger of its operations (node_pops and tri_rows,
    this run's totals over all rays, times pop_ops, with K7's select for
    the carry-top body) over the float32 peak, and its bytes over the
    memory rate: each ray's 11 input and 5 output words, 8 bytes of
    counters with counters=True, and the table rows read, rows = (node
    rows, Tri rows) from rows_read, each once. Returns (ms, "operations"
    or "bytes")."""
    arity = dev["nodes"].shape[1] // 7
    m = dev["tris"].shape[1] // 14
    node, leaf = pop_ops(arity, m, any_hit, option, select)
    t_ops = (node * node_pops + leaf * tri_rows) / PEAK_OPS
    t_bytes = (n_rays * (64 + (8 if counters else 0))
               + rows[0] * 28 * arity + rows[1] * 56 * m) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# The micro-probes. Peaks for their bounds: the H100 SXM5's rates outside
# the tensor cores from NVIDIA's Hopper architecture white paper, per type
# (int16 has no published rate: its packed pairs are counted against the
# int32 rate), and device memory.
PROBE_PEAKS = {"float32": 66.9e12, "bfloat16": 133.8e12, "int32": 33.5e12,
               "int16": 33.5e12}
# probe -> its number in rt_probe_occupancy (csrc/probes.cu)
PROBE_IDS = {"gather": 0, "mosaic3": 1, "chain": 2, "body": 3,
             "dyn_cost": 4, "vpu": 5}


def probe_call(entry, *args):
    """Calls the C entry `entry` of the probes library on the current
    stream (pointers as ints: tensor.data_ptr()); raises where the launch
    was refused."""
    fn = getattr(load_library(kind="probes"), entry)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {rc}")


def full_copies(probe, body, arg=0, arg2=0, per_block=1.0):
    """(copies, copies per SM) of a probe's launch that fills every SM at
    its kernel's occupancy: SMs x resident blocks per SM x copies per block
    (per_block < 1 where a copy spans several blocks)."""
    n = ctypes.c_int(0)
    rc = load_library(kind="probes").rt_probe_occupancy(
        PROBE_IDS[probe], body, arg, arg2, ctypes.byref(n))
    if rc != 0 or n.value < 1:
        raise RuntimeError(f"rt_probe_occupancy({probe}, {body}): CUDA "
                           f"error {rc}, {n.value} blocks per SM")
    per_sm = n.value * per_block
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return int(sms * per_sm), per_sm


def probe_bound_ms(ops, nbytes, dtype="float32"):
    """The least time for a probe launch: its operations over the type's
    peak against its bytes (inputs read once, outputs written once) over
    the memory rate. Returns (ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / PROBE_PEAKS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# launches captured in one CUDA graph to time a probe (launch_ms)
GRAPH_LAUNCHES = 20


def launch_ms(fn, device, blocks=3):
    """(ms per call of fn, its last output). On a card: GRAPH_LAUNCHES
    calls captured in one CUDA graph, whose replays are timed (timed()),
    so that a kernel shorter than the host's time per call (the wrapper's,
    tens of microseconds) is not timed as that; the wrappers count the
    captured calls, not the replays. On the CPU: timed()."""
    if device.type != "cuda":
        return timed(fn, device, blocks)
    out = fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(GRAPH_LAUNCHES):
            out = fn()
    ms, _ = timed(graph.replay, device, blocks)
    return ms / GRAPH_LAUNCHES, out


def probe_shapes(fn, device, full, per_sm, iters, blocks=3):
    """One timed probe at both launch shapes (launch_ms): fn(copies)
    launches it without synchronising. Returns {"ms1", "ns1" (ns per
    iteration of the single copy), "ms", "copies", "ns_sm" (ns per
    iteration per SM at the full shape), "out1", "out"} (the outputs of
    the two shapes)."""
    ms1, out1 = launch_ms(lambda: fn(1), device, blocks)
    ms, out = launch_ms(lambda: fn(full), device, blocks)
    return {"ms1": ms1, "ns1": ms1 * 1e6 / iters, "ms": ms,
            "copies": full, "ns_sm": ms * 1e6 / iters / per_sm,
            "out1": out1, "out": out}


# The card's assembly. cuobjdump -sass and nvdisasm print one instruction
# a line, "/*0a30*/  @!P0 FSETP.GT.AND P1, PT, R3, R4, PT ;", under a
# header per function ("Function : <name>" and ".text.<name>:"
# respectively); nvdisasm also prints branch labels (".L_x_12:") and, with
# -gi on a build with -lineinfo, the source line of the instructions that
# follow with the call sites they were inlined at ('//## File "f.cu",
# line 12 inlined at "f.cu", line 40').
_FUNCTION = re.compile(r"^\s*(?:Function : (\S+)|\.text\.(\S+):)\s*$")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_LINE = re.compile(r'//## File "([^"]+)", line (\d+)')
_INLINED = re.compile(r'inlined at "([^"]+)", line (\d+)')
_TARGET_ADDR = re.compile(r"\b0x([0-9a-f]+)")
_TARGET_LABEL = re.compile(r"`\((\.L_x_\d+)\)")


@dataclasses.dataclass
class Sass:
    """One function's instructions: (address, text, frames), frames the
    source lines (file, line) from the innermost to the outermost call
    site, () without line information; and its labels' addresses."""
    insns: list
    labels: dict


def parse_sass(text):
    """{function name: Sass} of a cuobjdump -sass or nvdisasm listing.
    nvdisasm -gi may print several source lines before one instruction
    (an inlined helper's line with its call sites, then the caller's
    line): they add up to the instruction's frames."""
    funcs, cur, pending, frames, fresh = {}, None, [], (), True
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = funcs.setdefault(m.group(1) or m.group(2), Sass([], {}))
            pending, frames, fresh = [], (), True
            continue
        if cur is None:
            continue
        m = _LINE.search(line)
        if m:
            found = ((m.group(1), int(m.group(2))),) + tuple(
                (f, int(n)) for f, n in _INLINED.findall(line))
            frames = found if fresh else frames + found
            fresh = False
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTRUCTION.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                cur.labels[label] = addr
            pending = []
            cur.insns.append((addr, " ".join(m.group(2).split()), frames))
            fresh = True
    return funcs


def opcode(text, full=False):
    """An instruction's mnemonic without its predicate: its base ("FSETP")
    or, with full=True, with its modifiers ("FSETP.GT.AND")."""
    words = text.split()
    op = words[1] if words[0].startswith("@") else words[0]
    return op if full else op.split(".")[0]


def branch_target(sass, text):
    """The address a BRA instruction jumps to, or None for another
    instruction or an indirect branch."""
    if opcode(text) != "BRA":
        return None
    m = _TARGET_ADDR.search(text)
    if m:
        return int(m.group(1), 16)
    m = _TARGET_LABEL.search(text)
    return sass.labels.get(m.group(1)) if m else None


def loops(sass):
    """[(target, branch address)] of every backward branch, in address
    order: each loop's first instruction and its closing branch. A branch
    to itself, the trap behind a function's EXIT, is no loop."""
    out = []
    for addr, text, _ in sass.insns:
        t = branch_target(sass, text)
        if t is not None and t < addr:
            out.append((t, addr))
    return out


def sass_tool(name):
    """A CUDA toolkit binary (cuobjdump, nvdisasm) beside nvcc."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(f"{name}: no CUDA toolkit (nvcc not found)")
    return str(Path(nvcc).with_name(name))


def read_sass(lib_path):
    """{function: Sass} of a kernel library, through cuobjdump -sass."""
    return parse_sass(subprocess.run(
        [sass_tool("cuobjdump"), "-sass", str(lib_path)],
        capture_output=True, text=True, check=True).stdout)
