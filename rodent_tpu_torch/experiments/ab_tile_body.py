"""K5 and K6 in their two schedules on the card: what each instance holds,
both held bit for bit against the plain version, and the two timed in
turns against each other and beside K1.

csrc/bvh_tile.cu carries two schedules of K5 (the tile stack of
pallas_packet._kernel) and K6 (pallas_pair's stack of whole nodes),
SCHEDULES: the warp schedule ("warp": each thread's rays in registers, a
copy of the stack in every warp, one block barrier per node pop and none
per closest-hit leaf pop) and the first schedule ("v1", the TPU's: the
rays and the popped row in shared memory, thread 0 pops, 3-4 block
barriers per node pop). Both pop the same entries in the same order, so
both must return the plain version's bits, counters included. The
wrappers (traversal/packet.py tile_rows=, traversal/pair.py) launch the
"tile" library, which holds WRAPPED; the other schedule is built into its
own library (LIBRARY). launch() takes either, WRAPPED through the
wrappers themselves; each launch counts in traversal/packet.py's
launches, under launch_count()'s key. On hall-260K's 1M sorted
primaries, ao and bounce rays (configs(): K5 at tile_rows 1, 2, 4 and 16,
frustum off and on, nopure at 16 on the primaries; K6 at tiles of 256,
1,024 and 2,048 rays) and, with --powerplant, powerplant-4.3M's sorted
primaries (K5 at tile_rows 2 and 16, frustum off and on), this tool:

- times K1 and both schedules in turns (K1, v1, warp, warp, v1, K1),
  beside the bound of the pops made (common.tile_bound_ms), which both
  schedules share;
- holds both schedules bit for bit against the plain version, hits and
  per-tile pops, on the first whole tiles that pop at most PLAIN_POPS
  times (at most SUBSET rays; the plain version steps once per pop), and
  against each other on all rays;
- prints each instance's registers, static and dynamic shared memory,
  local memory and resident blocks per SM (resources()).

check_stops() holds both schedules against each other on a stack (K5) or
an iteration guard (K6) too small for some tiles, whose pops read -1.
chip_smoke.py phase 12 runs all of it.

Usage: python -m rodent_tpu_torch.experiments.ab_tile_body [--blocks 3]
    [--powerplant]
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import time

import torch

from ..kernels import build
from ..traversal import api, packet, pair
from . import common

# K5's and K6's two schedules, in the order the A/B times them (after K1)
SCHEDULES = ("v1", "warp")
WRAPPED = "warp"            # the schedule of the "tile" library
LIBRARY = {"warp": "tile", "v1": "tile_v1"}
KERNELS = ("K5", "K6")
NAMES = {"K5": "bvh_traverse_tile", "K6": "bvh_traverse_pair"}
# the configurations timed: K5's tile_rows on hall and powerplant, K6's
# tiles on hall
HALL_ROWS = (1, 2, 4, 16)
PAIR_TILES = (256, 1024, 2048)
BIG_ROWS = (2, 16)
# the plain version steps once per pop: it checks the whole tiles that pop
# at most this often, at most SUBSET rays of them
PLAIN_POPS = 1000
SUBSET = 65_536
# the out-of-range stacks of check_stops (K5) and guards (K6: fractions of
# the plain version's largest tile, in iterations)
STOP_CAPS = (2, 4, 8)


def launch_count(schedule, kernel):
    """Launches of `kernel` in `schedule` since packet.reset_launches()."""
    return packet.launches[packet.launch_key(NAMES[kernel],
                                             LIBRARY[schedule])]


def check_args(kernel, schedule, size, mode="plain", ablate=(),
               stack_cap=None, max_iters=None):
    """Validates launch()'s arguments (K6's ablations: pair.check_pair)."""
    if schedule not in SCHEDULES or kernel not in KERNELS:
        raise ValueError(f"ab_tile_body: schedule {schedule!r}, kernel "
                         f"{kernel!r}; takes {SCHEDULES} x {KERNELS}")
    if kernel == "K5":
        if size not in api.TILE_ROWS:
            raise ValueError(f"K5: tile_rows={size}: one of {api.TILE_ROWS}")
        if mode not in packet.TILE_MODES or ablate:
            raise ValueError(f"K5 takes a mode of {packet.TILE_MODES} and no "
                             f"ablation; got {mode!r}, {ablate!r}")
        if max_iters is not None:
            raise ValueError("K5 has no iteration guard")
        top = packet.TILE_STACK_MAX
    else:
        if mode != "plain":
            raise ValueError(f"K6 has no mode {mode!r}: its ablations are "
                             f"{pair.ABLATIONS}")
        if size not in pair.PAIR_TILES:
            raise ValueError(f"K6: tile_rays={size}: one of "
                             f"{pair.PAIR_TILES}")
        top = pair.PAIR_STACK_MAX
    if stack_cap is not None and not 1 <= stack_cap <= top:
        raise ValueError(f"{kernel}: stack_cap={stack_cap}: 1 to {top}")
    if max_iters is not None and max_iters < 0:
        raise ValueError(f"K6: max_iters={max_iters} < 0")


def launch(dev, comps, kernel="K5", schedule=WRAPPED, any_hit=False,
           size=16, mode="plain", ablate=(), stack_cap=None, max_iters=None):
    """K5 (size: tile_rows, mode: an entry of packet.TILE_MODES) or K6
    (size: tile_rays, ablate: of pair.ABLATIONS) in `schedule`. comps: the
    ray components in api.components' order. Returns the hits and the
    per-tile "pops" and "leaf_pops". stack_cap and K6's max_iters replace
    the stack the tree needs and the guard (a tile that reaches either
    stops with pops -1); without them WRAPPED goes through the wrappers
    (traverse_packet_components tile_rows=, traverse_pair_packet_components).
    CPU tensors take the plain version, the same for both schedules, which
    has no such replacement."""
    check_args(kernel, schedule, size, mode, ablate, stack_cap, max_iters)
    if kernel == "K6":
        ablate = pair.check_pair(dev, size, ablate)
    o, d, inv, _, tmin, tmax = comps
    if tmin.device.type == "cpu":
        if stack_cap is not None or max_iters is not None:
            raise ValueError("ab_tile_body.launch: the plain version raises "
                             "where the stack overflows and has no other "
                             "stack or guard; stack_cap and max_iters need "
                             "CUDA tensors")
        return launch_plain(dev, comps, kernel, any_hit, size, mode, ablate)
    if tmin.device.type != "cuda":
        raise ValueError(f"ab_tile_body.launch: unsupported device "
                         f"{tmin.device}")
    if schedule == WRAPPED and stack_cap is None and max_iters is None:
        if kernel == "K5":
            return packet.traverse_packet_components(
                dev, *comps, any_hit=any_hit, count_pops=True,
                tile_rows=size, frustum=mode == "frustum",
                ablate=("nopure",) if mode == "nopure" else ())
        return pair.traverse_pair_packet_components(
            dev, *comps, any_hit=any_hit, tile_rays=size, ablate=ablate,
            count_pops=True)
    flat = [*inv, *o, *d, tmin, tmax]
    if kernel == "K5":
        return packet._launch_tile(dev, flat, any_hit, size, mode,
                                   LIBRARY[schedule], stack_cap)
    return pair._launch(dev, flat, any_hit, size, ablate, LIBRARY[schedule],
                        stack_cap, max_iters)


def resources(kernel, schedule, m, any_hit, size, mode, stack_cap):
    """What one instance of `schedule` holds on this card: {"regs" per
    thread, "smem_static" and "smem_dynamic" bytes per block, "local"
    bytes per thread, "blocks" resident per SM, "threads" per block}."""
    tile = 128 * size if kernel == "K5" else size
    out = (ctypes.c_int * 6)()
    lib = build.load_library(kind=LIBRARY[schedule])
    err = lib.rt_bvh_tile_resources(
        KERNELS.index(kernel), m, int(bool(any_hit)),
        packet.TILE_MODES.index(mode), tile, stack_cap, out)
    if err != 0:
        raise RuntimeError(f"rt_bvh_tile_resources ({schedule} {kernel}) "
                           f"failed with CUDA error {err}")
    return dict(zip(("regs", "smem_static", "smem_dynamic", "local",
                     "blocks", "threads"), out))


def label(kernel, size, mode="plain"):
    """'K5 rows 16 frustum', 'K6 tile 2048', ... (chip_smoke's keys)."""
    if kernel == "K6":
        return f"K6 tile {size}"
    return f"K5 rows {size}" + ("" if mode == "plain" else f" {mode}")


def configs(scene, name):
    """[(kernel, size, mode)] the A/B runs on one distribution."""
    if scene == "powerplant":
        return [("K5", r, m) for r in BIG_ROWS for m in ("plain", "frustum")]
    out = [("K5", r, m) for r in HALL_ROWS for m in ("plain", "frustum")]
    if name == "primary":
        out.append(("K5", 16, "nopure"))
    return out + [("K6", t, "plain") for t in PAIR_TILES]


def equal(k, p, what):
    """Raises unless every output of p equals k's bit for bit."""
    for key in p:
        if not torch.equal(k[key], p[key]):
            bad = int((k[key] != p[key]).sum())
            raise RuntimeError(f"{what}: {key} differs on {bad} entries")


def check_subset(dev, comps, any_hit, kernel, size, mode, outs, what):
    """Every schedule's output (outs: {schedule: launch()}) against the
    plain version on the first whole tiles that pop at most PLAIN_POPS
    times, at most SUBSET rays (the tile that pops least where none
    does); tiles are independent. Returns (rays, tiles, (node rows, Tri
    rows) the plain version read there)."""
    tile = 128 * size if kernel == "K5" else size
    pops = outs[WRAPPED]["pops"]
    keep = torch.nonzero((pops >= 0) & (pops <= PLAIN_POPS))[
        :max(SUBSET // tile, 1), 0]
    if keep.numel() == 0:
        keep = pops.argmin().reshape(1)
    idx = (keep[:, None] * tile + torch.arange(tile, device=keep.device)
           ).reshape(-1)
    idx = idx[idx < comps[4].shape[0]]
    o, d, inv, _, tmin, tmax = tuple(
        tuple(c[idx] for c in x) if isinstance(x, tuple) else x[idx]
        for x in comps)
    if kernel == "K5":
        p = api.traverse_tile_components(
            dev, o, d, inv, tmin, tmax, any_hit, size, mode == "frustum",
            ("nopure",) if mode == "nopure" else (), count_rows=True)
    else:
        p = pair.traverse_pair_components(dev, o, d, inv, tmin, tmax,
                                          any_hit, size, count_pops=True,
                                          count_rows=True)
    rows = (int(p.pop("nodes_read").sum()), int(p.pop("tris_read").sum()))
    for schedule, out in outs.items():
        equal({k: v[keep] if k in ("pops", "leaf_pops") else v[idx]
               for k, v in out.items()}, p,
              f"{what} {schedule} ({idx.numel()} rays)")
    return idx.numel(), keep.numel(), rows


def check_stops(dev, comps, any_hit, kernel, size, mode="plain",
                ablate=()):
    """Both schedules on a stack of STOP_CAPS entries (K5) or at guards
    of 1/4, 1/2 and 3/4 of the plain version's largest tile (K6): equal to
    each other in every output, a tile either stopped (pops -1) or equal
    to the plain version's pops, and some tile stopped. Returns the tiles
    that stopped, summed over the stacks or guards."""
    plain = launch_plain(dev, comps, kernel, any_hit, size, mode, ablate)
    if kernel == "K5":
        limits = [{"stack_cap": c} for c in STOP_CAPS]
    else:
        top = int(plain["pops"].max())
        limits = [{"max_iters": top * q // 4} for q in (1, 2, 3)]
    stopped = 0
    for lim in limits:
        outs = {s: launch(dev, comps, kernel, s, any_hit, size, mode,
                          ablate, **lim) for s in SCHEDULES}
        equal(outs["v1"], outs["warp"], f"{kernel} {lim}: warp against v1")
        k = outs[WRAPPED]["pops"]
        stop = k < 0
        if not bool(((k == plain["pops"]) | stop).all()):
            raise RuntimeError(f"{kernel} {lim}: a tile that did not stop "
                               "differs from the plain version's pops")
        stopped += int(stop.sum())
    if stopped == 0:
        raise RuntimeError(f"{kernel}: no tile stopped at {limits}")
    return stopped


def launch_plain(dev, comps, kernel, any_hit, size, mode="plain",
                 ablate=()):
    """The plain version of launch() on the tensors' own device."""
    o, d, inv, _, tmin, tmax = comps
    if kernel == "K5":
        return api.traverse_tile_components(
            dev, o, d, inv, tmin, tmax, any_hit, size, mode == "frustum",
            ("nopure",) if mode == "nopure" else ())
    return pair.traverse_pair_components(dev, o, d, inv, tmin, tmax,
                                         any_hit, size, ablate,
                                         count_pops=True)


def measure(dev, comps, any_hit, device, kernel, size, mode="plain",
            blocks=3, what=""):
    """One configuration: K1 and both schedules timed in turns (K1, v1,
    warp, warp, v1, K1); the two schedules equal to each other on all rays
    and to the plain version on a subset (check_subset); the bound of the
    pops made; each schedule's resources. Returns {"k1_ms", "ms":
    {schedule: ms}, "out": {schedule: output, with its counters}, "k1":
    K1's output, "bound": (ms, by), "stats": common.tile_stats, "subset":
    (rays, tiles), "rows", "resources": {schedule: resources()}}."""
    n = comps[4].shape[0]
    tile = 128 * size if kernel == "K5" else size

    def k1():
        return packet.traverse_packet_components(dev, *comps,
                                                 any_hit=any_hit)

    def sched(s):
        return lambda: launch(dev, comps, kernel, s, any_hit, size, mode)
    ms, res = common.rounds([k1] + [sched(s) for s in SCHEDULES], device,
                            blocks)
    outs = dict(zip(SCHEDULES, res[1:]))
    what = f"{what} {label(kernel, size, mode)}"
    equal(outs["v1"], outs["warp"], f"{what}: warp against v1")
    rays, tiles, rows = check_subset(dev, comps, any_hit, kernel, size, mode,
                                     outs, what)
    counted = outs[WRAPPED]
    pure = api.tile_purity(comps[2], size) if kernel == "K5" else None
    bound = common.tile_bound_ms(dev, counted, tile, n, rows, any_hit, pure,
                                 mode == "frustum", mode == "nopure",
                                 pair_kernel=kernel == "K6")
    m = dev["tris"].shape[1] // 14
    cap = api.stack_entries(dev)
    return {"k1_ms": ms[0], "ms": dict(zip(SCHEDULES, ms[1:])), "out": outs,
            "k1": res[0], "bound": bound,
            "stats": common.tile_stats(counted, tile, n),
            "subset": (rays, tiles), "rows": rows,
            "resources": {s: resources(kernel, s, m, any_hit, size, mode,
                                       cap) for s in SCHEDULES}}


def line(scene, name, kernel, size, mode, r):
    """One configuration's report line: per schedule its ms, share of the
    bound, ratio to K1 and resources; warp over v1."""
    b_ms, by = r["bound"]
    cells = []
    for s in SCHEDULES:
        res = r["resources"][s]
        cells.append(
            f"{s} {r['ms'][s]:.4f} ms ({b_ms / r['ms'][s]:.1%} of the "
            f"bound, {r['ms'][s] / r['k1_ms']:.2f}x K1; {res['regs']} regs, "
            f"{res['smem_static']}+{res['smem_dynamic']} B shared, "
            f"{res['local']} B local, {res['blocks']} blocks of "
            f"{res['threads']}/SM)")
    st = r["stats"]
    return (f"{scene} {name} {label(kernel, size, mode)}: K1 "
            f"{r['k1_ms']:.4f} ms; {'; '.join(cells)}; warp/v1 "
            f"{r['ms']['warp'] / r['ms']['v1']:.4f}; bound {b_ms:.4f} ms "
            f"({by}); pops per tile {st['mean']:.1f} (max {st['max']}); "
            f"{r['subset'][0]} rays in {r['subset'][1]} tiles == plain")


def run(device, dists, scene, dev, blocks=3, on_result=None):
    """measure() over configs() of every distribution ({name: (comps,
    any_hit)}); on_result(key, result) is called after each. Returns
    {(scene, name, kernel, size, mode): measure()}."""
    res = {}
    for name, (comps, any_hit) in dists.items():
        for kernel, size, mode in configs(scene, name):
            key = (scene, name, kernel, size, mode)
            res[key] = measure(dev, comps, any_hit, device, kernel, size,
                               mode, blocks, f"{scene} {name}")
            if on_result:
                on_result(key, res[key])
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="ab_tile_body")
    p.add_argument("--blocks", type=int, default=3)
    p.add_argument("--powerplant", action="store_true",
                   help="also powerplant-4.3M's primaries (K5, Tri24)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ab_tile_body: no CUDA card")
    device = torch.device("cuda")
    print(f"card: {common.card(device)}", flush=True)
    t0 = time.perf_counter()
    verts, idx, dev, _ = common.load("hall", common.TRI8, device)
    dists = common.distributions("hall", verts, idx, dev, 1024, device,
                                 ("primary", "ao", "bounces"))
    print(f"hall-260K and its rays in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def show(key, r):
        print(line(*key, r), flush=True)
    packet.reset_launches()
    run(device, dists, "hall", dev, args.blocks, show)
    if args.powerplant:
        del dists, dev
        verts, idx, dev, _ = common.load("powerplant", common.TRI24, device)
        prim = common.distributions("powerplant", verts, idx, dev, 1024,
                                    device, ("primary",))
        run(device, prim, "powerplant", dev, args.blocks, show)
    counts = {f"{s} {k}": launch_count(s, k) for s in SCHEDULES
              for k in KERNELS}
    print(f"card after: {common.card(device)}; launches {counts}",
          flush=True)


if __name__ == "__main__":
    main()
