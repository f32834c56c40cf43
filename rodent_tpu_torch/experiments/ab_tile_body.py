"""K5 and K6 on the card beside K1: what each instance holds, each held
bit for bit against the plain version, and each timed in turns with K1.

csrc/bvh_tile.cu holds K5 (the tile stack of pallas_packet._kernel) and
K6 (pallas_pair's stack of whole nodes) in the warp schedule (each
thread's rays in registers, a copy of the stack in every warp, one block
barrier per node pop and none per closest-hit leaf pop), built into the
"tile" library that the wrappers (traversal/packet.py tile_rows=,
traversal/pair.py) launch. launch() goes through the wrappers, or, with a
stack or guard of its own, through their launch functions; each launch
counts in traversal/packet.py's launches (launch_count()). On hall-260K's
1M sorted primaries, ao and bounce rays (configs(): K5 at tile_rows 1, 2,
4 and 16, frustum off and on, nopure at 16 on the primaries; K6 at tiles
of 256, 1,024 and 2,048 rays) and, with --powerplant, powerplant-4.3M's
sorted primaries (K5 at tile_rows 2 and 16, frustum off and on), this
tool:

- times K1 and the kernel in turns (K1, kernel, kernel, K1), beside the
  bound of the pops made (common.tile_bound_ms);
- holds the kernel bit for bit against the plain version, hits and
  per-tile pops, on the first whole tiles that pop at most PLAIN_POPS
  times (at most SUBSET rays; the plain version steps once per pop);
- prints each instance's registers, static and dynamic shared memory,
  local memory and resident blocks per SM (resources()).

check_stops() runs the kernel on a stack (K5) or an iteration guard (K6)
too small for some tiles, whose pops read -1, and holds the other tiles
against the plain version. chip_smoke.py phase 12 runs all of it. The
first schedule, the TPU's, which the warp schedule replaced, is gone; its
times stay in PERF.md.

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


def launch_count(kernel):
    """Launches of `kernel` since packet.reset_launches()."""
    return packet.launches[NAMES[kernel]]


def check_args(kernel, size, mode="plain", ablate=(), stack_cap=None,
               max_iters=None):
    """Validates launch()'s arguments (K6's ablations: pair.check_pair)."""
    if kernel not in KERNELS:
        raise ValueError(f"ab_tile_body: kernel {kernel!r}; takes {KERNELS}")
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


def launch(dev, comps, kernel="K5", any_hit=False, size=16, mode="plain",
           ablate=(), stack_cap=None, max_iters=None):
    """K5 (size: tile_rows, mode: an entry of packet.TILE_MODES) or K6
    (size: tile_rays, ablate: of pair.ABLATIONS). comps: the ray
    components in api.components' order. Returns the hits and the
    per-tile "pops" and "leaf_pops". stack_cap and K6's max_iters replace
    the stack the tree needs and the guard (a tile that reaches either
    stops with pops -1); without them the launch goes through the
    wrappers (traverse_packet_components tile_rows=,
    traverse_pair_packet_components). CPU tensors take the plain version,
    which has no such replacement."""
    check_args(kernel, size, mode, ablate, stack_cap, max_iters)
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
    if stack_cap is None and max_iters is None:
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
        return packet._launch_tile(dev, flat, any_hit, size, mode, stack_cap)
    return pair._launch(dev, flat, any_hit, size, ablate, stack_cap,
                        max_iters)


def resources(kernel, m, any_hit, size, mode, stack_cap):
    """What one instance holds on this card: {"regs" per thread,
    "smem_static" and "smem_dynamic" bytes per block, "local" bytes per
    thread, "blocks" resident per SM, "threads" per block}."""
    tile = 128 * size if kernel == "K5" else size
    out = (ctypes.c_int * 6)()
    lib = build.load_library(kind="tile")
    err = lib.rt_bvh_tile_resources(
        KERNELS.index(kernel), m, int(bool(any_hit)),
        packet.TILE_MODES.index(mode), tile, stack_cap, out)
    if err != 0:
        raise RuntimeError(f"rt_bvh_tile_resources ({kernel}) failed with "
                           f"CUDA error {err}")
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


def subset(comps, kernel, size, out):
    """The part of a launch that check_subset holds against the plain
    version: the first whole tiles that pop at most PLAIN_POPS times, at
    most SUBSET rays (the tile that pops least where none does); tiles are
    independent. Returns (their rays' components, the kernel's outputs on
    them: the rays' hits and the tiles' counters)."""
    tile = 128 * size if kernel == "K5" else size
    pops = out["pops"]
    keep = torch.nonzero((pops >= 0) & (pops <= PLAIN_POPS))[
        :max(SUBSET // tile, 1), 0]
    if keep.numel() == 0:
        keep = pops.argmin().reshape(1)
    idx = (keep[:, None] * tile + torch.arange(tile, device=keep.device)
           ).reshape(-1)
    idx = idx[idx < comps[4].shape[0]]
    sub = tuple(tuple(c[idx] for c in x) if isinstance(x, tuple) else x[idx]
                for x in comps)
    return sub, {k: v[keep] if k in ("pops", "leaf_pops") else v[idx]
                 for k, v in out.items()}


def check_plain(dev, sub, any_hit, kernel, size, mode, sub_out, what):
    """The plain version on subset()'s rays `sub` against the kernel's
    outputs there, bit for bit (raises otherwise). Returns (rays, tiles,
    (node rows, Tri rows) the plain version read)."""
    o, d, inv, _, tmin, tmax = sub
    if kernel == "K5":
        p = api.traverse_tile_components(
            dev, o, d, inv, tmin, tmax, any_hit, size, mode == "frustum",
            ("nopure",) if mode == "nopure" else (), count_rows=True)
    else:
        p = pair.traverse_pair_components(dev, o, d, inv, tmin, tmax,
                                          any_hit, size, count_pops=True,
                                          count_rows=True)
    rows = (int(p.pop("nodes_read").sum()), int(p.pop("tris_read").sum()))
    equal(sub_out, p, f"{what} ({tmin.numel()} rays)")
    return tmin.numel(), sub_out["pops"].numel(), rows


def check_subset(dev, comps, any_hit, kernel, size, mode, out, what):
    """The kernel's output (out: launch()) against the plain version on
    subset()'s tiles (check_plain). Returns (rays, tiles, (node rows, Tri
    rows) the plain version read there)."""
    sub, sub_out = subset(comps, kernel, size, out)
    return check_plain(dev, sub, any_hit, kernel, size, mode, sub_out, what)


def check_stops(dev, comps, any_hit, kernel, size, mode="plain",
                ablate=()):
    """The kernel on a stack of STOP_CAPS entries (K5) or at guards of
    1/4, 1/2 and 3/4 of the plain version's largest tile (K6): a tile
    either stopped (pops -1) or equal to the plain version in its pops and
    its rays' hits, and some tile stopped. Returns the tiles that stopped,
    summed over the stacks or guards."""
    plain = launch_plain(dev, comps, kernel, any_hit, size, mode, ablate)
    tile = 128 * size if kernel == "K5" else size
    n = comps[4].shape[0]
    if kernel == "K5":
        limits = [{"stack_cap": c} for c in STOP_CAPS]
    else:
        top = int(plain["pops"].max())
        limits = [{"max_iters": top * q // 4} for q in (1, 2, 3)]
    stopped = 0
    for lim in limits:
        out = launch(dev, comps, kernel, any_hit, size, mode, ablate, **lim)
        stop = out["pops"] < 0
        run = ~stop
        if not torch.equal(out["pops"][run], plain["pops"][run]):
            raise RuntimeError(f"{kernel} {lim}: a tile that did not stop "
                               "differs from the plain version's pops")
        rays = run.repeat_interleave(tile)[:n]
        for key in ("t", "u", "v", "prim_id", "geom_id"):
            if not torch.equal(out[key][rays], plain[key][rays]):
                raise RuntimeError(f"{kernel} {lim}: {key} of a tile that "
                                   "did not stop differs from the plain "
                                   "version's")
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


def timed(dev, comps, any_hit, device, kernel, size, mode="plain",
          blocks=3):
    """One configuration's timing: K1 and the kernel in turns (K1,
    kernel, kernel, K1), and the instance's resources. Returns {"k1_ms",
    "ms", "out": the kernel's output, with its counters, "k1": K1's
    output, "resources": resources(), "any_hit"}."""
    def k1():
        return packet.traverse_packet_components(dev, *comps,
                                                 any_hit=any_hit)

    def run_kernel():
        return launch(dev, comps, kernel, any_hit, size, mode)
    k1_ms, ms, k1_out, out = common.in_turns(k1, run_kernel, device, blocks)
    m = dev["tris"].shape[1] // 14
    return {"k1_ms": k1_ms, "ms": ms, "out": out, "k1": k1_out,
            "resources": resources(kernel, m, any_hit, size, mode,
                                   api.stack_entries(dev)),
            "any_hit": any_hit}


def bounded(r, dev, comps, kernel, size, mode, checked):
    """timed()'s result r with what its check against the plain version
    (checked: check_plain's (rays, tiles, rows read)) gives: "bound": (ms,
    by) of the pops made, "stats": common.tile_stats, "subset": (rays,
    tiles), "rows"."""
    n = comps[4].shape[0]
    tile = 128 * size if kernel == "K5" else size
    rays, tiles, rows = checked
    pure = api.tile_purity(comps[2], size) if kernel == "K5" else None
    bound = common.tile_bound_ms(dev, r["out"], tile, n, rows, r["any_hit"],
                                 pure, mode == "frustum", mode == "nopure",
                                 pair_kernel=kernel == "K6")
    return dict(r, bound=bound, stats=common.tile_stats(r["out"], tile, n),
                subset=(rays, tiles), rows=rows)


def measure(dev, comps, any_hit, device, kernel, size, mode="plain",
            blocks=3, what=""):
    """One configuration: timed(), then the kernel equal to the plain
    version on a subset (check_subset) and bounded(). Returns {"k1_ms",
    "ms", "out": the kernel's output, with its counters, "k1": K1's
    output, "bound": (ms, by), "stats": common.tile_stats, "subset":
    (rays, tiles), "rows", "resources": resources(), "any_hit"}."""
    r = timed(dev, comps, any_hit, device, kernel, size, mode, blocks)
    checked = check_subset(dev, comps, any_hit, kernel, size, mode,
                           r["out"], f"{what} {label(kernel, size, mode)}")
    return bounded(r, dev, comps, kernel, size, mode, checked)


def line(scene, name, kernel, size, mode, r):
    """One configuration's report line: the kernel's ms, share of the
    bound, ratio to K1 and resources."""
    b_ms, by = r["bound"]
    res = r["resources"]
    st = r["stats"]
    return (f"{scene} {name} {label(kernel, size, mode)}: K1 "
            f"{r['k1_ms']:.4f} ms; {r['ms']:.4f} ms ({b_ms / r['ms']:.1%} "
            f"of the bound, {r['ms'] / r['k1_ms']:.2f}x K1; {res['regs']} "
            f"regs, {res['smem_static']}+{res['smem_dynamic']} B shared, "
            f"{res['local']} B local, {res['blocks']} blocks of "
            f"{res['threads']}/SM); bound {b_ms:.4f} ms ({by}); pops per "
            f"tile {st['mean']:.1f} (max {st['max']}); {r['subset'][0]} rays "
            f"in {r['subset'][1]} tiles == plain")


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
    counts = {k: launch_count(k) for k in KERNELS}
    print(f"card after: {common.card(device)}; launches {counts}",
          flush=True)


if __name__ == "__main__":
    main()
