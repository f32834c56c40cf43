#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rodent_tpu_torch) on one NVIDIA GPU.

Drives the port's main path once at the size the repository's benchmark
calls real, and checks it:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. builds the kernels with nvcc, six libraries at once: K1, its
   prefetching variant K2 and its pop-counting variant K3 (112 kernels);
   K4, the options of the legacy Pallas body; K1-K3's two bodies (224; all
   csrc/bvh_traverse.cu); K7, the carry-top body, and K7-PF, K7 with the
   next-pop prefetch (144, csrc/bvh_ct.cu), whose registers and spills it
   reports apart; K5 and K6, the tile-shared-stack kernels
   (csrc/bvh_tile.cu); and the micro-probes (csrc/probes.cu);
3. K1 against its plain torch version on random triangle soups, arity
   2/4/8 and Tri4/8/16 packets, closest-hit and any-hit;
4. hall-260K: 1024x1024 sorted primary rays timed through K1 and through
   the plain version, hits compared, then 65,536 any-hit ao rays;
5. the path tracer (render_iteration) on hall-260K at 1920x1088, spp 4,
   max path length 20, three iterations (the first one warms up), with
   K1's launch count read around it;
6. the hall golden-image gate of tests/test_golden_scenes.py through the
   port;
7. powerplant-4.3M (the big-scene tier): scene build, table sizes, the
   card's L2 and the tier packet_mode picks, which must be hybrid-hbm;
8. the big-scene traversal: 1,048,576 sorted primaries through K1, K2
   and the plain version (K2 == K1 bit for bit, K1 == plain up to exact-t
   ties), the pop attribution through K3 held against the plain
   counters, and 65,536 any-hit ao rays through K2 (and the sorted ao and
   bounce rays of phase 20);
9. the persistent renderer on powerplant-4.3M at 1920x1088, spp 4, max
   path length 20 under the port's select_render_policy (K2, pool sort),
   three iterations, with every kernel's launch count read around them,
   then one iteration with a 16x larger pool for comparison;
10. the hall and crown golden gates through render_iteration_persistent
   (K1);
11. the attribution path (rodent_tpu_torch.experiments): K4 against the
   plain version on two soups with multi-row leaves, every option; then
   on hall-260K and powerplant-4.3M, every option against K3 in turns on
   1M sorted primaries and on the ao rays (nonodetest, which pops the
   whole tree, on fewer rays), with K4's launch count read around them,
   and each option's counters and hits held against the plain version;
12. the tile-shared-stack kernels (csrc/bvh_tile.cu), K5 (_kernel's tile
   stack: plain, frustum, nopure) and K6 (the pair layout, each ablation;
   rodent_tpu_torch.experiments.ab_tile_body): against their plain
   versions on the soups of phase 11, bit for bit in hits and per-tile
   pops, and against K1, and on a stack or a guard too small for some
   tiles, which stop with pops -1; then the measurement path on
   hall-260K (1M sorted primaries: K5 at tile_rows 1, 2, 4, 16, frustum
   off and on, and nopure at 16; K6 at tiles of 256, 1024, 2048 rays; ao
   rays: K5 at tile_rows 1 and 16, frustum off and on, K6 at 1024 and
   2048; timed_tile_config) and powerplant-4.3M's sorted primaries (K5,
   Tri24, at tile_rows 2 and 16, frustum off and on): K1 and the kernel
   timed in turns (K1, kernel, kernel, K1), counted, beside the
   bound of the pops made, with each instance's registers, shared memory
   and resident blocks; these and the others (hall's ao rays at tile_rows
   2 and 4 and K6 256, and every configuration on its bounce rays),
   launched once untimed, held against the plain version on up to 65,536
   of their rays (whole tiles of at most ab_tile_body.PLAIN_POPS pops);
13. the micro-probes (csrc/probes.cu, rodent_tpu_torch.experiments.probe_*
   and vpu_dtype_bench, the ports of the TPU probes of experiments/): every
   body of the eight probe files through its kernel as its main() drives
   it, with the launch counts read around them, the timed probes at one
   copy (the TPU's one program) and at the copies that fill the card; every
   copy's output held bit for bit against the plain version; a table of
   their times beside the card's SM clock, and the vpu kernels' op counts
   read from their SASS;
14. K1/K2/K3's two bodies, built together into the "group" library
   (-DRT_GROUP; rodent_tpu_torch.experiments.ab_body), which no renderer
   runs: the group stack and the first body held bit for bit against the
   plain version on the soups of phase 3, the tie scenes, hall-260K's 1M
   primaries and powerplant-4.3M's primaries and ao rays (K2 equal to K1,
   K3's counters equal to the plain counters), then timed in turns at the
   widths the port launches them: hall's primaries, ao and bounce rays,
   the launches of one render_iteration sample of phase 5 (each of the
   first three, and all of them back to back), powerplant's primaries (K1,
   K2, K3) and one step of phase 9's 32K pool (K2: its closest-hit and
   any-hit launch, and the two back to back), with their registers, local
   memory and resident warps;
15. the OBJ scene path: mathall-260K (every BSDF kind, two procedural
   textures) through compile_mesh, rendered by render_iteration at
   1920x1088, spp 4, max path length 20 (K1, launches counted around it)
   and by one render_iteration_persistent under select_render_policy; a
   torch.profiler split of one textured iteration (bank lookups, K1, the
   rest, device idle share); the mathall golden gate through both
   renderers; then the scene written as OBJ + MTL + PNG textures under
   build/phase15: converter -> load_data_dir equal to compile_obj tensor
   for tensor on the card, tools.render at 1920x1088 through its policy
   (K1, spp 4) and --traversal hybrid-hbm (K2, spp 1), and the traversal
   file pipeline ray_gen (1024x1024 primaries) -> bvh_extractor ->
   bench_traversal (K1) -> fbuf2png, whose intersection count and t equal
   K1's on the rays and BVH read back from the files;
16. the engines that are torch ops, not kernels (rodent_tpu_torch/
   traversal/tiled.py and dense.py): the dual-queue engine on hall-260K's
   1M sorted primaries, ao and bounce rays without and with staged
   compaction, timed in turns against K1 with its trips, hits equal to
   K1's; the dense engine on a box of 6 Tri8 packets (1M rays) against
   K1; crown's golden gate in the golden's configuration (packet=False,
   compact=5); one persistent hall-260K iteration under the JAX package's
   hybrid-tier policy at 480x272 spp 1; tools.render --traversal tiled and
   dense, quality_gate and a scripted view session on the box (written
   under build/phase16). The engines' routes must launch no kernel;
17. the sharded paths (rodent_tpu_torch.parallel) and the last tools on
   hall-260K at 1920x1088, spp 4, max path length 20: a one-rank NCCL
   group (the persistent renderer under select_render_policy and the
   progressive one, bit for bit against their single-device films); four
   gloo ranks spawned on the one card, K1 in each (the persistent
   renderer at (n_px, n_sp) = (2, 2) and (4, 1), the progressive at
   (2, 2), within 1e-5 of the single-device films, their Msamples/s beside
   the single device's; traverse_sharded on the 1M sorted primaries, equal
   to K1 bit for bit; whether gloo takes CUDA tensors);
   measure_shard_steps at (4, 1) and (2, 2), equal to the ranks' steps;
   tools.bench_ref (one host thread) on the 1M primaries against K1; and
   tools.bench_shading and bench_interface at 1M. The K1 launches of its
   renderers, in every rank, join the main path's.
18. the port's bench and measuring tools, each through its main() at the
   size its users run: rodent_tpu_torch.bench (hall-260K at 1024x1024 on
   the pk8 and pk16 builds through K7, the carry-top body of the JAX
   bench's rows, and K1, ao and bounces through K1 and tiled-c,
   powerplant-4.3M through K2; no cornell row without a reference
   directory), its JSON line's keys checked and its hit fraction held
   against K1's on the same rays and build; ab_render_policy on
   powerplant-4.3M at 1920x1088 spp 1 through K2 at pools of 32K and 512K,
   on hall-260K (K1) at pools of 64K and 512K, and all-packet beside
   all-tiled at 160x90, the films bit for bit equal across pools and
   engines; profile_renderer on hall-260K at 480x272 spp 1; race_hall_packet
   at Tri8/Tri12/Tri24 x leaf_cost 0/0.6 (K1 and K7); tools.benchmark on
   hall-260K's primaries, variants packet, hbm and hbm-nopf (K7, K7-PF,
   K7: the carry-top body in every packet variant, as the JAX tool), with
   its launches checked (K7-PF in the hbm row, no K2);
   sweep_bigscene_leaf on two powerplant-4.3M builds; bigscene_12m's
   primaries at 14.6M triangles (K1 and K2); shard_scaling_table at its
   defaults. Their K1, K2, K3, K7 and K7-PF launches join the kernels
   line's.

19. the last measuring programs of rodent_tpu_torch.experiments, each
   through its run() (phase_programs): sass_audit's SASS audit of K1
   (arity 8, Tri8 and Tri24, closest-hit and any-hit), K2, K3, K7 (Tri8
   fold with the fused slab and sort with the unfused one, any-hit, Tri24),
   K5 at tile_rows 1 and 16 and K6 at 2,048 rays, from the -lineinfo
   copies of the "main", "ct" and "tile" libraries that phase 2 builds,
   with each one's
   issue estimate beside its measured ns per pop on hall-260K;
   attribute_crown on hall-260K and crown-800K, ab_crown_build,
   probe_crown_sort and measure_sorts at one configuration each;
   waterfall_tiled, measure_tiled_iters, sweep_arity_tiled and
   probe_sb_depth on hall's ao rays at one configuration each;
   bigscene_demo --card (400K triangles) and --mesh (2 gloo ranks on the
   card, bit for bit); make_goldens on hall under the golden gate. Their
   K1-K3 and K7 launches join the kernels line's, with each kernel's audit.

20. K7, the carry-top body (phase_ct): every variant (closest-hit fold and
   sort, fused and unfused slab; any-hit fused and unfused) bit for bit
   against its plain version in hits, pops and rows read, on hall-260K's
   1M sorted primaries, bounce and ao rays and on powerplant-4.3M's
   sorted primaries (Tri24), sort with the unfused slab also against K1's
   hits and K3's counters; then each timed in turns with K1
   (experiments.measure_ct) with its pops per ray, its bound and the rays
   where it keeps another hit than K1. K7-PF (phase_pf) on powerplant-4.3M's
   1M sorted primaries, bounce and ao rays (Tri24): every variant bit for
   bit against its plain version and against K7 in hits, then timed in
   turns with K7 and in turns with K2 (measure_ct.measure_pf) beside its
   bound and its registers. Tri12 (phase_tri12) on a pk12 build of
   hall-260K, 1M sorted primaries and ao rays: K1 against the plain
   version (exact-t ties allowed), K2 equal to K1, K3's counters and K7's
   fold and sort (with and without counters) bit for bit against their
   plain versions, K1 and K7 timed in turns.

21. the cornell programs (phase_cornell), each through its run(), on the
   stand-in for the absent cornell box (experiments.common's open box,
   12 triangles, the dense tier) at 1080x720, spp 4, max path length 64,
   with the reference's camera: ab_cornell_engine's eight engine variants
   (dense, tiled, packet, retire_every=2, pools of 16K and 64K, the pool
   sort, 64K with retire 2), one untimed and one timed iteration each,
   their films bit for bit equal, K1 launched by the packet variants and
   no kernel by dense and tiled; measure_splat at 3 iterations. Their K1
   launches join the kernels line's.

Every kernel's time stands beside its bound, the least time the card
could take for the same pops and the table rows they read
(experiments.common.bound_ms). The scenes' builds, the ray distributions
and the CUDA-event timer are those of rodent_tpu_torch.experiments.common,
which the port's tools share.

Run from the repository root: python3 chip_smoke.py
Needs one CUDA card, nvcc and g++; writes only under build/. With
--cards N (N even, N cards visible) it runs only phase 17b's sharded calls
on an NCCL group of N ranks, one card each, against cuda:0's films. Any failed
check raises, so the exit code is not 0; the last line of a successful
run is a JSON object naming the device.
"""
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# exact-t ties allowed in phases 4, 8, 11; in phase 12, prim_id differences
# with K1, whose pops come in another order (against_k1)
TIE_LIMIT = 1e-4
# rays on which tools.bench_ref's engine and K1 differ by more than a tie
# (phase 17d), each held against a brute force
EDGE_RAYS = 8
SUBSET = 65_536             # ao rays held against the plain version
# powerplant rays through K4's nonodetest, which pops all of the tree's
# 250,000 entries per ray
NONODE_BIG = 16_384


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def sm_clock():
    """The card's SM clock and power draw as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def compare_hits(k, p, what):
    """K1 (k) against the plain version (p): prim_id identical except for
    exact-t ties, t/u/v within atol 1e-5 and rtol 1e-6 where the ids
    agree. Returns (ties, max_abs_err)."""
    pk, pp = k["prim_id"], p["prim_id"]
    diff = pk != pp
    ties = int((diff & (k["t"] == p["t"])).sum())
    other = int(diff.sum()) - ties
    check(other == 0, f"{what}: {other} prim_id mismatches that are not "
          f"exact-t ties")
    same = ~diff
    err = 0.0
    for key in ("t", "u", "v"):
        a, b = k[key][same].double(), p[key][same].double()
        check(bool(torch.all((a - b).abs() <= 1e-5 + 1e-6 * b.abs())),
              f"{what}: {key} outside atol 1e-5 / rtol 1e-6")
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    check(bool(torch.equal(k["geom_id"][same], p["geom_id"][same])),
          f"{what}: geom_id differs")
    return ties, err


def random_tri_soup(n, seed):
    """The random soup of tests/test_traversal.py:16-26."""
    r = np.random.RandomState(seed)
    base = r.randn(n, 3).astype(np.float32) * 2.0
    v1 = base + r.randn(n, 3).astype(np.float32) * 0.5
    v2 = base + r.randn(n, 3).astype(np.float32) * 0.5
    verts = np.concatenate([base, v1, v2]).astype(np.float32)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n,
                    r.randint(0, 5, n)], axis=1).astype(np.int32)
    return verts, idx.reshape(-1)


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, devices {torch.cuda.device_count()}")
    from rodent_tpu_torch.kernels.build import find_nvcc
    nvcc = find_nvcc()
    check(nvcc is not None, "nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"[1] nvcc: {ver[-1]}")


# the kernels each library must hold (phase 2): main K1 72, K2 20, K3 20;
# ct K7 96, K7-PF 48; group both bodies of main's
LIBRARY_KERNELS = {"main": 112, "ct": 144, "group": 224}


def ptxas_registers(nvcc_log):
    """{function: registers} of ptxas -v's output."""
    out, cur = {}, None
    for line in nvcc_log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
        elif cur and "Used" in line and "registers" in line:
            out[cur] = int(line.split("Used")[1].split()[0])
            cur = None
    return out


def phase_build():
    """Builds every library at once and reports each one's kernels,
    registers and spills from ptxas' lines of its build. Returns the ct
    library's {bvh_ct_kernel's template arguments: registers}."""
    from rodent_tpu_torch.kernels.build import (LIBRARIES, build_all,
                                                kept_log, load_library)
    from concurrent.futures import ThreadPoolExecutor
    from rodent_tpu_torch.experiments import sass_audit
    t0 = time.perf_counter()
    # phase 19's -lineinfo copies of "main", "ct" and "tile" build beside
    # them
    with ThreadPoolExecutor(len(sass_audit.AUDITED)) as pool:
        audit = [pool.submit(sass_audit.build_lineinfo, k)
                 for k in sass_audit.AUDITED]
        built = build_all()
        for f in audit:
            f.result()
    dt = time.perf_counter() - t0
    what = {"main": "K1, K2 and K3", "ct": "K7, the carry-top body",
            "options": "K4 (-DRT_OPTIONS)",
            "group": "K1-K3's two bodies (-DRT_GROUP, phase 14)",
            "tile": "K5 and K6",
            "probes": "the micro-probes"}
    ct_regs = None
    for kind, (path, nvcc_log) in built.items():
        load_library(kind=kind)
        done = "built" if nvcc_log is not None else "already built:"
        if nvcc_log is None:
            nvcc_log = kept_log(path)
        regs_of = ptxas_registers(nvcc_log)
        spill = sass_audit.spills(nvcc_log)
        regs = list(regs_of.values())
        log(f"[2] {done} {what[kind]} from rodent_tpu_torch/csrc/"
            f"{LIBRARIES[kind][0]}: {len(regs)} kernels, registers "
            f"{min(regs)}-{max(regs)}, "
            f"{sum(v != (0, 0) for v in spill.values())} with spills -> "
            f"{os.path.relpath(path, REPO)}")
        want = LIBRARY_KERNELS.get(kind)
        check(want is None or len(regs) == want,
              f"the {kind} library holds {len(regs)} kernels, not {want}")
        if kind == "ct":
            # K7-PF's instantiations (the last template argument, PF, 1)
            # beside K7's
            ct_regs = {sass_audit.demangle(n)[1]: r
                       for n, r in regs_of.items()}
            for pf in (0, 1):
                names = [n for n in regs_of
                         if sass_audit.demangle(n)[1][-1] == pf]
                r = [regs_of[n] for n in names]
                sp = sum(1 for n in names if spill.get(n, (0, 0)) != (0, 0))
                log(f"[2] {'K7-PF' if pf else 'K7'}: {len(names)} kernels, "
                    f"registers {min(r)}-{max(r)}, {sp} with spills")
    log(f"[2] all {len(built)} libraries and the -lineinfo copies of "
        f"{', '.join(sass_audit.AUDITED)} (phase 19) built at once in "
        f"{dt:.1f} s")
    return ct_regs


def soups(device):
    """Phase 3's soups: (name, device tables, closest-hit rays, any-hit
    rays) for BVH2/4/8 with Tri4/8/16 rows, 8,192 rays each (axis-parallel
    and dead ones among them; any-hit rays end at t 2)."""
    from rodent_tpu_torch.accel import build_bvh
    from rodent_tpu_torch.traversal import api
    for arity in (2, 4, 8):
        for m in (4, 8, 16):
            verts, idx = random_tri_soup(2000, seed=10 * arity + m)
            dev = api.bvh_to_device(
                build_bvh(verts, idx, arity=arity, packet=m), device)
            r = np.random.RandomState(arity * 100 + m)
            org = r.randn(8192, 3).astype(np.float32) * 3.0
            d = r.randn(8192, 3).astype(np.float32)
            d[:64, 0] = 0.0          # axis-parallel rays
            d[64:128, 1:] = 0.0
            tmax = np.full(8192, 1e30, np.float32)
            tmax[128:160] = -1.0     # dead rays
            yield (f"soup A{arity} M{m}", dev,
                   api.make_rays(org, d, 0.0, tmax, device=device),
                   api.make_rays(org, d, 0.0, np.minimum(tmax, 2.0),
                                 device=device))


def phase_soups(device):
    from rodent_tpu_torch.traversal import api
    from rodent_tpu_torch.traversal.packet import traverse_packet
    err = 0.0
    for name, dev, rays, short in soups(device):
        k = traverse_packet(dev, rays)
        p = api.traverse(dev, rays)
        ties, e = compare_hits(k, p, name)
        check(ties == 0, f"{name}: {ties} prim_id ties")
        err = max(err, e)
        ka = traverse_packet(dev, short, any_hit=True)["prim_id"] >= 0
        pa = api.traverse(dev, short, any_hit=True)["prim_id"] >= 0
        check(bool(torch.equal(ka, pa)), f"{name}: any-hit hit/miss differs")
    log(f"[3] K1 == plain on 9 soups (A 2/4/8 x M 4/8/16), closest-hit "
        f"and any-hit: prim_id identical, max |dt,du,dv| {err:.3g}")


def phase_primary(device, scene):
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.traversal import api
    from rodent_tpu_torch.traversal.packet import (
        traverse_packet_components)
    bvh = scene.device["bvh"]
    dists = common.distributions("hall", scene.mesh.vertices,
                                 scene.mesh.indices, bvh, 1024, device,
                                 ("primary", "ao-unsorted"))
    prim = dists["primary"][0]
    o, d, inv, _, tmin, tmax = prim
    n = tmin.shape[0]

    def k1():
        return traverse_packet_components(bvh, *prim)

    k_ms, hit = common.timed(k1, device, blocks=5, warmup_s=0.5)
    clock = sm_clock()
    mrays = n / k_ms / 1e3
    hit_frac = float((hit["prim_id"] >= 0).float().mean())
    log(f"[4] hall-260K primary, {n} sorted rays: K1 {k_ms:.4f} ms = "
        f"{mrays:.1f} Mrays/s (median of 5 blocks of about 20 ms after "
        f"0.5 s of warm-up; SM clock, power after: {clock}), hit fraction "
        f"{hit_frac:.4f}")

    def plain():
        return api.traverse_components(bvh, o, d, inv, tmin, tmax)

    p_ms, phit = common.timed(plain, device, blocks=3)
    log(f"[4] plain version on the same {n} rays: {p_ms:.1f} ms = "
        f"{n / p_ms / 1e3:.3f} Mrays/s (median of 3)")
    ties, err = compare_hits(hit, phit, "hall primary")
    check(ties < TIE_LIMIT * n, f"hall primary: {ties} ties")
    log(f"[4] K1 vs plain on all {n} primary rays: {ties} exact-t ties "
        f"({100.0 * ties / n:.4f}%), other prim_id mismatches 0, max "
        f"|dt,du,dv| {err:.3g}")
    # K1's bound: the least time for the pops these rays need (K3 counts
    # them) and the table rows they read (the plain version counts them)
    s = common.pop_stats(traverse_packet_components(bvh, *prim,
                                                    count_pops=True))
    rows = common.rows_read(bvh, prim)
    bound = common.bound_ms(bvh, n, s["node"], s["leaf"], rows)
    log(f"[4] pops per ray {s['pops_ray']:.3f} (leaf {s['leaf_ray']:.3f});"
        f" rows read {rows[0]} of {bvh['nodes'].shape[0]} node rows, "
        f"{rows[1]} of {bvh['tris'].shape[0]} Tri8 rows: K1's bound "
        f"{bound[0]:.4f} ms ({bound[1]}), K1 at {bound[0] / k_ms:.1%} of it")

    # ao rays from the primary hit points, in pixel order
    ao = common.head(dists["ao-unsorted"][0], SUBSET)
    ka = traverse_packet_components(bvh, *ao, any_hit=True)["prim_id"] >= 0
    pa = api.traverse_components(bvh, ao[0], ao[1], ao[2], ao[4], ao[5],
                                 any_hit=True)["prim_id"] >= 0
    check(bool(torch.equal(ka, pa)), "hall ao: any-hit hit/miss differs")
    log(f"[4] {SUBSET} ao any-hit rays: hit/miss identical, occluded "
        f"fraction {float(ka.float().mean()):.4f}")
    phase_sort_keys(device, scene)
    return k_ms, p_ms, err, bound, prim, ao


def phase_sort_keys(device, scene):
    """[4] ROADMAP C4 on the card: the sort keys of hall's 1M primaries
    (pixel order) with CUDA's rsqrtf against the CPU's torch.rsqrt. Keys
    may differ only in their 20 direction bits and only where 1/|d|
    differs; given the CPU's 1/|d|, the card's keys equal the CPU's bit
    for bit; K1's hits on the two orders, put back in pixel order, equal
    each other bit for bit."""
    from rodent_tpu_torch.core.math import FLT_MAX
    from rodent_tpu_torch.traversal import api, sorting
    from rodent_tpu_torch.traversal.packet import traverse_packet
    from rodent_tpu_torch.utils import testscenes
    org, dirs = testscenes.hall_primary_rays(1024, 1024)
    lo = scene.mesh.vertices.min(0)
    hi = scene.mesh.vertices.max(0)
    rays = api.make_rays(org, dirs, 0.0, FLT_MAX, device=device)
    o, d = torch.from_numpy(org), torch.from_numpy(dirs)
    cpu = sorting.ray_sort_keys(o, d, lo, hi)
    card = sorting.ray_sort_keys(rays["org"], rays["dir"], lo, hi).cpu()
    s = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] + 1e-30
    inv_cpu = torch.rsqrt(s)
    inv_card = torch.rsqrt(s.to(device)).cpu()
    moved = card != cpu
    check(not bool((moved & (inv_card == inv_cpu)).any()),
          "sort keys: a key moved where 1/|d| is the same")
    check(not bool(((card ^ cpu) & ~sorting.DIR_BITS).any()),
          "sort keys: a key moved outside its direction bits")
    held = sorting.ray_sort_keys(rays["org"], rays["dir"], lo, hi,
                                 inv_len=inv_cpu.to(device)).cpu()
    check(bool(torch.equal(held, cpu)), "sort keys: the card's keys with the "
          "CPU's 1/|d| differ from the CPU's")
    hits = []
    for keys in (card, cpu):
        perm = torch.sort(keys, stable=True).indices.to(device)
        hit = traverse_packet(scene.device["bvh"],
                              {k: v[perm] for k, v in rays.items()})
        back = {k: torch.empty_like(v).index_copy_(0, perm, v)
                for k, v in hit.items()}
        hits.append(back)
    for k in hits[0]:
        check(bool(torch.equal(hits[0][k], hits[1][k])),
              f"sort keys: K1's {k} differs between the two orders")
    n = int(moved.sum())
    log(f"[4] C4: {n} of {moved.numel()} sort keys moved by CUDA's rsqrtf "
        f"against the CPU's ({int((inv_card != inv_cpu).sum())} of 1/|d| "
        f"differ), all in the direction bits; with the CPU's 1/|d| the "
        f"card's keys are the CPU's bit for bit; K1's hits on both orders "
        f"equal bit for bit")


def phase_render(device, scene):
    from rodent_tpu_torch.render import film as film_mod
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.integrator import render_iteration
    from rodent_tpu_torch.traversal import packet
    w, h, spp, iters = 1920, 1088, 4, 3
    cam = Camera.make((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0,
                      w, h)
    film = film_mod.new_film(w, h, device)
    stats = {}
    secs = []
    packet.reset_launches()
    for it in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = render_iteration(scene.device, cam, film, w, h, spp, it,
                                stats=stats)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = packet.launches["bvh_traverse"]
    bounces = stats["bounces"]
    check(launches >= 2 * bounces > 0,
          f"render: {launches} K1 launches for {bounces} bounces")
    check(bool(torch.isfinite(film).all()), "render: film not finite")
    check(float(film.min()) >= 0.0, "render: negative radiance")
    img = film_mod.tonemap(film, w, h, iters)
    check(img.mean() > 1.0, "render: black image")
    best = float(np.mean(secs[1:]))
    msps = w * h * spp / best / 1e6
    log(f"[5] render hall-260K {w}x{h} spp {spp} mpl 20: iterations "
        f"{', '.join(f'{s:.3f}' for s in secs)} s (first warms up) -> "
        f"{msps:.3f} Msamples/s; {bounces} bounces, {launches} K1 launches;"
        f" image mean {img.mean():.1f}/255")
    return launches


def phase_golden(device):
    from rodent_tpu_torch.io import png
    from rodent_tpu_torch.utils import testscenes
    from rodent_tpu_torch.render import film as film_mod
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.compiler import compile_mesh
    from rodent_tpu_torch.render.integrator import render_iteration
    gdir = os.path.join(REPO, "tests", "golden")
    with open(os.path.join(gdir, "golden_meta.json")) as f:
        m = json.load(f)["hall"]
    verts, idx = testscenes.make_hall(m["tris"])
    scene = compile_mesh(verts, idx, device, max_path_len=8,
                         emitter="inside")
    w, h = m["w"], m["h"]
    cam = Camera.make((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0,
                      w, h)
    film = film_mod.new_film(w, h, device)
    for it in range(m["test_iters"]):
        film = render_iteration(scene.device, cam, film, w, h, m["spp"], it)
    img = film_mod.tonemap(film, w, h, m["test_iters"])
    golden = png.read_png(os.path.join(gdir, "hall.png"))[..., :3]
    mse = film_mod.mse_u8(golden, img)
    gate = 3.0 * m["calib_mse_u8"] + 1.0
    check(mse <= gate, f"golden: MSE {mse:.1f} over the gate {gate:.1f}")
    check(abs(float(img.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"],
          f"golden: image mean {img.mean():.1f} vs {m['mean_u8']}")
    log(f"[6] hall golden gate ({m['tris']} tris, {w}x{h}, spp {m['spp']},"
        f" {m['test_iters']} iterations): MSE {mse:.2f} <= {gate:.2f}")


def phase_bigscene(device):
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.utils import testscenes
    from rodent_tpu_torch.render.compiler import (compile_mesh,
                                                  fast_memory_bytes,
                                                  packet_mode)
    from rodent_tpu_torch.traversal.packet import stack_cap
    t0 = time.perf_counter()
    verts, idx = testscenes.make_powerplant(common.SIZES["powerplant"])
    t_gen = time.perf_counter() - t0
    timings = {}
    scene = compile_mesh(verts, idx, device, max_path_len=20,
                         emitter="above", bvh_kwargs=common.TRI24,
                         timings=timings)
    bvh = scene.device["bvh"]
    nodes_mb = bvh["nodes"].numel() * 4 / 1e6
    tris_mb = bvh["tris"].numel() * 4 / 1e6
    l2 = fast_memory_bytes(scene.device)
    tier = packet_mode(scene.device)
    log(f"[7] powerplant: {scene.mesh.num_tris} tris generated in "
        f"{t_gen:.1f} s, BVH8/Tri24 built in {timings['bvh_s']:.1f} s, "
        f"compiled in {timings['total_s']:.1f} s; {bvh['nodes'].shape[0]} "
        f"nodes = {nodes_mb:.1f} MB, {bvh['tris'].shape[0]} Tri24 packets "
        f"= {tris_mb:.1f} MB; stack {bvh['meta'].shared_stack}+2 of "
        f"{stack_cap(bvh)}; L2 {l2 / 1e6:.1f} MB -> tier {tier}")
    check(tier == "hybrid-hbm", f"powerplant tier {tier}, not hybrid-hbm")
    return scene


def phase_bigscene_traversal(device, scene, side=1024):
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.traversal import api, packet
    bvh = scene.device["bvh"]
    dists = common.distributions("powerplant", scene.mesh.vertices,
                                 scene.mesh.indices, bvh, side, device,
                                 ("primary", "ao-unsorted", "ao", "bounces"))
    comps = dists["primary"][0]
    o, d, inv, _, tmin, tmax = comps
    n = tmin.shape[0]

    def kernel(**kw):
        return lambda: packet.traverse_packet_components(bvh, *comps, **kw)

    torch.cuda.reset_peak_memory_stats()
    ms, hits = {}, {}
    # in turns, K1, K2, K2, K1, then K3; a kernel's time is the mean of
    # its turns, each the median of 5 blocks of about 20 ms
    for name, kw in (("K1", {}), ("K2", {"prefetch": True}),
                     ("K2", {"prefetch": True}), ("K1", {}),
                     ("K3", {"count_pops": True})):
        t, hits[name] = common.timed(kernel(**kw), device, blocks=5,
                                     warmup_s=0.5)
        ms.setdefault(name, []).append(t)
    clock = sm_clock()
    k1, k2, k3 = hits["K1"], hits["K2"], hits["K3"]
    for key in ("t", "u", "v", "prim_id", "geom_id"):
        check(bool(torch.equal(k1[key], k2[key])),
              f"powerplant primary: K2 {key} differs from K1")
    p_ms, plain = common.timed(lambda: api.traverse_components(
        bvh, o, d, inv, tmin, tmax, count_pops=True), device, blocks=2)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ties, err = compare_hits(k1, plain, "powerplant primary")
    check(ties < TIE_LIMIT * n, f"powerplant primary: {ties} ties")
    k_ms = {k: float(np.mean(v)) for k, v in ms.items()}
    log(f"[8] powerplant primary, {n} sorted rays (SM clock, power after: "
        f"{clock}): K1 {k_ms['K1']:.4f} ms = {n / k_ms['K1'] / 1e3:.1f} "
        f"Mrays/s, K2 {k_ms['K2']:.4f} ms = {n / k_ms['K2'] / 1e3:.1f} "
        f"Mrays/s (turns K1, K2, K2, K1: {ms['K1'][0]:.4f}, "
        f"{ms['K2'][0]:.4f}, {ms['K2'][1]:.4f}, {ms['K1'][1]:.4f} ms), K3 "
        f"{k_ms['K3']:.4f} ms, "
        f"plain {p_ms:.1f} ms = {n / p_ms / 1e3:.3f} Mrays/s; peak "
        f"device memory {peak:.2f} GB")
    log(f"[8] K2 == K1 on all 5 outputs of {n} rays; K1 vs plain: {ties} "
        f"exact-t ties ({100.0 * ties / n:.4f}%), other prim_id mismatches "
        f"0, max |dt,du,dv| {err:.3g}; hit fraction "
        f"{float((k1['prim_id'] >= 0).float().mean()):.4f}")

    # the pop attribution of this row (the role of count_pops in
    # experiments/attribute_bigscene.py): K3's launches are counted
    packet.reset_launches()
    att = packet.traverse_packet_components(bvh, *comps, count_pops=True)
    torch.cuda.synchronize()
    k3_launches = packet.launches["bvh_traverse_count"]
    check(k3_launches == 1, f"attribution: {k3_launches} K3 launches")
    for key in ("pops", "leaf_pops"):
        check(bool(torch.equal(att[key], plain[key])),
              f"powerplant primary: K3 {key} differ from the plain counts")
        check(bool(torch.equal(k3[key], plain[key])),
              f"powerplant primary: timed K3 {key} differ")
    for key in ("t", "u", "v", "prim_id", "geom_id"):
        check(bool(torch.equal(att[key], k1[key])),
              f"powerplant primary: K3 {key} differs from K1")
    s = common.pop_stats(att)
    rows = common.rows_read(bvh, comps)
    read_mb = (rows[0] * bvh["nodes"].shape[1]
               + rows[1] * bvh["tris"].shape[1]) * 4 / 1e6
    table_mb = (bvh["nodes"].numel() + bvh["tris"].numel()) * 4 / 1e6
    bounds = {"K2": common.bound_ms(bvh, n, s["node"], s["leaf"], rows),
              "K3": common.bound_ms(bvh, n, s["node"], s["leaf"], rows,
                                    counters=True)}
    log(f"[8] K3 counters == plain counters on all {n} rays: mean pops "
        f"per ray {s['pops_ray']:.3f}, leaf pops {s['leaf_ray']:.3f}, leaf "
        f"share {s['leaf'] / s['pops']:.4f}; rows read {rows[0]} of "
        f"{bvh['nodes'].shape[0]} node rows, {rows[1]} of "
        f"{bvh['tris'].shape[0]} Tri24 rows "
        f"({read_mb:.1f} of {table_mb:.1f} MB); "
        f"bound {bounds['K2'][0]:.4f} ms "
        f"({bounds['K2'][1]}; with counters {bounds['K3'][0]:.4f}): K1 at "
        f"{bounds['K2'][0] / k_ms['K1']:.1%} of it, K2 "
        f"{bounds['K2'][0] / k_ms['K2']:.1%}, K3 "
        f"{bounds['K3'][0] / k_ms['K3']:.1%}")

    # ao rays from the primary hit points, in pixel order
    aoc = common.head(dists["ao-unsorted"][0], SUBSET)
    ka = packet.traverse_packet_components(bvh, *aoc, any_hit=True,
                                           prefetch=True)["prim_id"] >= 0
    k1a = packet.traverse_packet_components(bvh, *aoc,
                                            any_hit=True)["prim_id"] >= 0
    pa = api.traverse_components(bvh, aoc[0], aoc[1], aoc[2], aoc[4],
                                 aoc[5], any_hit=True)["prim_id"] >= 0
    check(bool(torch.equal(ka, pa)), "powerplant ao: K2 hit/miss differs")
    check(bool(torch.equal(k1a, pa)), "powerplant ao: K1 hit/miss differs")
    log(f"[8] {SUBSET} ao any-hit rays: K2 and K1 hit/miss identical to "
        f"plain, occluded fraction {float(ka.float().mean()):.4f}")
    # phase 20's K7-PF rays: the sorted primaries, bounce and ao rays
    pf_dists = {k: dists[k] for k in ("primary", "bounces", "ao")}
    return k_ms, p_ms, err, k3_launches, bounds, comps, aoc, pf_dists


def phase_bigscene_render(device, scene, w=1920, h=1088):
    """[9] The persistent render of powerplant-4.3M under the policy (K2
    alone). Returns K2's launches and the two launches of iteration 0's
    step ab_body.POOL_STEP (ab_body.pool_launches), which phase 14
    times."""
    import contextlib
    from rodent_tpu_torch.experiments import ab_body, common
    from rodent_tpu_torch.render import film as film_mod
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.compiler import select_render_policy
    from rodent_tpu_torch.render.integrator import (
        render_iteration_persistent)
    from rodent_tpu_torch.traversal import packet
    spp, iters = 4, 3
    policy = select_render_policy(scene.device)
    check(policy == {"packet": "hbm", "sort": "pool"},
          f"powerplant policy {policy}")
    cam = Camera.make(*common.BIG_CAM, w, h)
    film = film_mod.new_film(w, h, device)
    secs, steps = [], []
    packet.reset_launches()
    capture = ab_body.pool_capture()
    for it in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture if it == 0 else contextlib.nullcontext():
            film, n_steps = render_iteration_persistent(
                scene.device, cam, film, w, h, spp, it, return_steps=True,
                **policy)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        steps.append(n_steps)
    launches = dict(packet.launches)
    check(launches["bvh_traverse_prefetch"] >= 2 * sum(steps) > 0,
          f"persistent render: {launches} launches for {sum(steps)} steps")
    check(launches["bvh_traverse"] == 0
          and launches["bvh_traverse_count"] == 0,
          f"persistent render: K1 or K3 launched ({launches})")
    check(bool(torch.isfinite(film).all()), "persistent: film not finite")
    check(float(film.min()) >= 0.0, "persistent: negative radiance")
    img = film_mod.tonemap(film, w, h, iters)
    check(img.mean() > 1.0, "persistent: black image")
    best = float(np.mean(secs[1:]))
    pool = min(w * h * spp, 1 << 15)
    log(f"[9] persistent render powerplant {w}x{h} spp {spp} mpl 20, "
        f"policy {policy}, pool {pool}: iterations "
        f"{', '.join(f'{s:.3f}' for s in secs)} s (first warms up) -> "
        f"{w * h * spp / best / 1e6:.3f} Msamples/s; steps per iteration "
        f"{steps}; launches {launches}; image mean {img.mean():.1f}/255")
    # for comparison, one more iteration with a 16x larger pool: the step
    # is host-bound, so fewer, wider steps finish sooner
    big_pool = 1 << 19
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film2, n_steps = render_iteration_persistent(
        scene.device, cam, film_mod.new_film(w, h, device), w, h, spp,
        iters, pool=big_pool, return_steps=True, **policy)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(film2).all()), "pool comparison: not finite")
    log(f"[9] the same at pool {big_pool}: {dt:.3f} s = "
        f"{w * h * spp / dt / 1e6:.3f} Msamples/s, {n_steps} steps")
    return (launches["bvh_traverse_prefetch"],
            ab_body.pool_launches(capture))


def phase_golden_persistent(device):
    """[10] The golden gates of hall and crown (experiments/make_goldens.py's
    configurations) through render_iteration_persistent with packet=True,
    on the routed K1."""
    from rodent_tpu_torch.io import png
    from rodent_tpu_torch.utils import testscenes
    from rodent_tpu_torch.render import film as film_mod
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.compiler import compile_mesh
    from rodent_tpu_torch.render.integrator import (
        render_iteration_persistent)
    from rodent_tpu_torch.traversal import packet
    gdir = os.path.join(REPO, "tests", "golden")
    with open(os.path.join(gdir, "golden_meta.json")) as f:
        meta = json.load(f)
    scenes = {"hall": (testscenes.make_hall, "inside",
                       ((2.5, 5.0, 5.0), (1.0, -0.12, 0.02))),
              "crown": (testscenes.make_crown, "above",
                        ((4.2, 1.8, 1.2), (-4.2, -1.4, -1.2)))}
    fovs = {"hall": 60.0, "crown": 42.0}
    for name, (make, emitter, (eye, look)) in scenes.items():
        m = meta[name]
        verts, idx = make(m["tris"])
        scene = compile_mesh(verts, idx, device, max_path_len=8,
                             emitter=emitter)
        w, h = m["w"], m["h"]
        cam = Camera.make(eye, look, (0, 1, 0), fovs[name], w, h)
        film = film_mod.new_film(w, h, device)
        packet.reset_launches()
        for it in range(m["test_iters"]):
            film = render_iteration_persistent(scene.device, cam, film, w, h,
                                               m["spp"], it, packet=True)
        check(packet.launches["bvh_traverse"] > 0
              and packet.launches["bvh_traverse_prefetch"] == 0,
              f"persistent golden {name}: launches {packet.launches}")
        img = film_mod.tonemap(film, w, h, m["test_iters"])
        golden = png.read_png(os.path.join(gdir, f"{name}.png"))[..., :3]
        mse = film_mod.mse_u8(golden, img)
        gate = 3.0 * m["calib_mse_u8"] + 1.0
        check(mse <= gate, f"persistent golden {name}: MSE {mse:.1f} over "
              f"the gate {gate:.1f}")
        check(abs(float(img.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"],
              f"persistent golden {name}: image mean {img.mean():.1f} vs "
              f"{m['mean_u8']}")
        log(f"[10] {name} golden gate through render_iteration_persistent "
            f"(K1, {packet.launches['bvh_traverse']} launches): MSE {mse:.2f} <= "
            f"{gate:.2f}, image mean {img.mean():.2f} (golden "
            f"{m['mean_u8']})")


def options_for(any_hit, nonodetest=True):
    """K4's options for closest-hit or any-hit (nosort is closest-hit
    only)."""
    from rodent_tpu_torch.traversal.packet import OPTIONS
    return [o for o in OPTIONS if not (any_hit and o == "nosort")
            and (nonodetest or o != "nonodetest")]


def phase_option_soups(device):
    """K4 against the plain version on two soups whose leaves span several
    Tri rows (so leaf chains run): every option, closest-hit and any-hit,
    counters and hits."""
    from rodent_tpu_torch.accel import build_bvh
    from rodent_tpu_torch.experiments.common import plain_args
    from rodent_tpu_torch.traversal import api
    from rodent_tpu_torch.traversal.packet import OPTION_ARGS, traverse_packet
    err, runs = 0.0, 0
    for m in (8, 24):
        verts, idx = random_tri_soup(3000, seed=70 + m)
        dev = api.bvh_to_device(build_bvh(
            verts, idx, arity=8, packet=m, leaf_threshold=32,
            leaf_cost=0.2), device)
        r = np.random.RandomState(80 + m)
        org = r.randn(8192, 3).astype(np.float32) * 3.0
        d = r.randn(8192, 3).astype(np.float32)
        d[:64, 0] = 0.0
        tmax = np.full(8192, 1e30, np.float32)
        tmax[128:160] = -1.0
        for any_hit in (False, True):
            rays = api.make_rays(org, d, 0.0, np.minimum(tmax, 2.0)
                                 if any_hit else tmax, device=device)
            for opt in options_for(any_hit):
                k = traverse_packet(dev, rays, any_hit=any_hit,
                                    count_pops=True, **OPTION_ARGS[opt])
                p = api.traverse(dev, rays, any_hit=any_hit, count_pops=True,
                                 **plain_args(opt))
                what = f"soup Tri{m} {opt} any_hit={any_hit}"
                for key in ("pops", "leaf_pops"):
                    check(bool(torch.equal(k[key], p[key])),
                          f"{what}: {key} differ from the plain version")
                ties, e = compare_hits(k, p, what)
                check(ties == 0, f"{what}: {ties} ties")
                err = max(err, e)
                runs += 1
    log(f"[11] K4 == plain on 2 soups (BVH8/Tri8, Tri24, leaves of up to "
        f"32 tris), {runs} option runs, closest-hit and any-hit: counters "
        f"equal, prim_id identical, max |dt,du,dv| {err:.3g}")
    return err


def phase_options(device, name, bvh, prim, ao, nonode_rays):
    """[11] The attribution path on one scene: every K4 option against K3
    in turns on 1M sorted primaries and on the ao rays, the way
    rodent_tpu_torch.experiments drives it (nonodetest, which pops the
    whole tree per ray, on the first `nonode_rays` rays of each); then
    each option's counters and hits against the plain version on 65,536
    of those rays, which also count the table rows read for each option's
    bound (fewer than all the rays read, so the bound stays a lower one).
    Returns (K4's launches in the path, results, max |dt,du,dv|)."""
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.traversal import api, packet
    head = common.head

    sub_prim, sub_ao = head(prim, nonode_rays), head(ao, nonode_rays)
    packet.reset_launches()
    t0 = time.perf_counter()
    runs = {
        "primary": common.option_turns(
            bvh, prim, device, options_for(False, False), blocks=3),
        "ao": common.option_turns(
            bvh, ao, device, options_for(True, False), any_hit=True,
            blocks=3),
        "primary nonodetest": common.option_turns(
            bvh, sub_prim, device, ["nonodetest"], blocks=1),
        "ao nonodetest": common.option_turns(
            bvh, sub_ao, device, ["nonodetest"], any_hit=True, blocks=1),
    }
    torch.cuda.synchronize()
    launched = packet.launches["bvh_traverse_option"]
    dt = time.perf_counter() - t0
    check(launched >= 2 * (len(options_for(False)) + len(options_for(True))),
          f"{name}: {launched} K4 launches")
    log(f"[11] {name}: K4 launched {launched} times in {dt:.1f} s "
        f"(clock, power after: {sm_clock()})")

    err = 0.0
    n_nodes, n_rows = bvh["nodes"].shape[0], bvh["tris"].shape[0]
    for run, res in runs.items():
        any_hit = run.startswith("ao")
        comps = (sub_ao if any_hit else sub_prim) if "nonodetest" in run \
            else (ao if any_hit else prim)
        k3 = res["K3"]["out"]
        sub = min(SUBSET, comps[-1].shape[0])
        pc = head(comps, sub)
        for opt, r in res.items():
            if opt == "K3":
                continue
            out = r["out"]
            what = f"{name} {run.split()[0]} {opt}"
            s = common.pop_stats(out)
            if opt == "nonodetest":
                # no node is culled: a ray that finds no hit pops every
                # node and every Tri row; the hits are K3's
                miss = out["prim_id"] < 0
                full = out["pops"] == n_nodes + n_rows
                check(bool(full[miss].all() if any_hit else full.all()),
                      f"{what}: a ray did not pop the whole tree")
                if any_hit:
                    check(bool(torch.equal(miss, k3["prim_id"] < 0)),
                          f"{what}: hit/miss differs from K3")
                else:
                    ties, e = compare_hits(out, k3, what)
                    check(ties < TIE_LIMIT * sub, f"{what}: {ties} ties")
                    err = max(err, e)
                note = "every missing ray popped the whole tree"
                rows = common.rows_read(bvh, comps, any_hit, opt)
            else:
                p = api.traverse_components(
                    bvh, pc[0], pc[1], pc[2], pc[4], pc[5], any_hit=any_hit,
                    count_pops=True, count_rows=True,
                    **common.plain_args(opt))
                rows = (int(p.pop("nodes_read").sum()),
                        int(p.pop("tris_read").sum()))
                ko = {k: v[:sub] for k, v in out.items()}
                for key in ("pops", "leaf_pops"):
                    check(bool(torch.equal(ko[key], p[key])),
                          f"{what}: {key} differ from the plain version")
                ties, e = compare_hits(ko, p, what)
                check(ties < TIE_LIMIT * sub, f"{what}: {ties} ties")
                err = max(err, e)
                note = f"counters == plain on {sub} rays, {ties} ties"
            if opt == "noleaftest":
                check(bool((out["prim_id"] < 0).all()),
                      f"{what}: a ray hit with the leaf tests off")
            if opt == "row_loads":
                for key in out:
                    check(bool(torch.equal(out[key], k3[key])),
                          f"{what}: {key} differs from K3")
                note += ", every output bit equal to K3's"
            # a leaf chain tests the Tri rows K3 pops one by one
            tested = (common.pop_stats(k3)["leaf"] if opt.startswith("chain")
                      else s["leaf"])
            bound = common.bound_ms(bvh, s["n"], s["node"], tested, rows,
                                    any_hit, opt, counters=True)
            log(f"[11] {what}: {r['ms']:.4f} ms vs K3 {r['k3_ms']:.4f} ms "
                f"in turns ({r['ms'] / r['k3_ms']:.3f}x) on "
                f"{out['t'].shape[0]} rays; pops/ray {s['pops_ray']:.3f} "
                f"(leaf {s['leaf_ray']:.3f}); bound {bound[0]:.4f} ms "
                f"({bound[1]}; rows read by {sub} rays {rows[0]} + "
                f"{rows[1]}); {note}")
    return launched, runs, err


def tile_args(mode):
    """traverse_packet's arguments for K5's mode (packet.TILE_MODES)."""
    return {"frustum": mode == "frustum",
            "ablate": ("nopure",) if mode == "nopure" else ()}


def coherent_rays(n, seed):
    """Rays from near one point with directions in one octant: their tiles
    are octant pure, where K5 takes the pure slab test or the frustum."""
    r = np.random.RandomState(seed)
    org = (np.array([[-1.0, -1.0, -9.0]], np.float32)
           + r.randn(n, 3).astype(np.float32) * 0.05)
    d = np.stack([r.uniform(0.01, 0.2, n), r.uniform(0.01, 0.2, n),
                  np.ones(n)], 1).astype(np.float32)
    return org, d


def check_equal(k, p, what):
    """Every output of the plain version p equal to the kernel's, bit for
    bit."""
    for key in p:
        check(bool(torch.equal(k[key], p[key])),
              f"{what}: {key} differs from the plain version")


def brute_force(dev, comps, i):
    """The closest hit of ray i over every Tri lane of the table, without a
    BVH (the arithmetic of mt_lane, lanes accepted up to tmax): (t,
    prim_id)."""
    from rodent_tpu_torch.traversal import api
    tris = dev["tris"]
    m = tris.shape[1] // 14
    o, d, _, _, tmin, tmax = comps

    def fld(f):
        return tris[:, f * m:(f + 1) * m]
    ok, tv, _, _ = api.mt_lane(
        [fld(0), fld(1), fld(2)], [fld(3), fld(4), fld(5)],
        [fld(6), fld(7), fld(8)], [fld(9), fld(10), fld(11)],
        [c[i] for c in o], [c[i] for c in d], tmin[i], tmax[i])
    pid = tris.view(torch.int32)[:, 12 * m:13 * m]
    tv = torch.where(ok & (pid != -1), tv, torch.inf).reshape(-1)
    j = int(tv.argmin())
    return float(tv[j]), int(pid.reshape(-1)[j] & 0x7FFFFFFF)


def against_k1(k, k1, any_hit, what, dev, comps):
    """A tile kernel's hits against K1's: any-hit hit/miss equal; closest-hit
    prim_id equal on all but at most TIE_LIMIT of the rays, and t/u/v equal
    where the ids agree. Which of two hits a traversal keeps can depend on
    the order of its pops, which a tile stack changes: a tie, two triangles
    hit at the same t or within 1e-6 of it (a ray through the shared edge
    of two coplanar triangles gets t values a few ULPs apart), or a grazing
    ray, whose slab test is rounded coarsely enough that a box is culled
    at one running t and not at another. Returns (ties, others), the
    others' first three printed beside the closest hit of a brute force
    over the whole Tri table."""
    if any_hit:
        check(bool(torch.equal(k["prim_id"] >= 0, k1["prim_id"] >= 0)),
              f"{what}: any-hit hit/miss differs from K1")
        return 0, 0
    diff = k["prim_id"] != k1["prim_id"]
    near = (k["t"] - k1["t"]).abs() <= 1e-6 * k1["t"].abs()
    ties, others = int((diff & near).sum()), int((diff & ~near).sum())
    check(ties + others <= TIE_LIMIT * diff.shape[0],
          f"{what}: {ties} ties and {others} other mismatches with K1")
    for i in torch.nonzero(diff & ~near)[:3, 0].tolist():
        bt, bp = brute_force(dev, comps, i)
        log(f"[12] {what}: ray {i} keeps prim {int(k['prim_id'][i])} at t "
            f"{float(k['t'][i])!r}, K1 prim {int(k1['prim_id'][i])} at t "
            f"{float(k1['t'][i])!r}; brute force over all "
            f"{dev['tris'].shape[0]} Tri rows: prim {bp} at t {bt!r}")
    same = ~diff
    for key in ("t", "u", "v", "geom_id"):
        check(bool(torch.equal(k[key][same], k1[key][same])),
              f"{what}: {key} differs from K1 where prim_id agrees")
    return ties, others


def phase_tile_soups(device):
    """[12] K5 and K6 against their plain versions on the
    soups of phase 11 (leaves of up to 32 tris): K5 at tile_rows 1 and 2
    on random rays (mixed tiles, where every mode is the plain one) and in
    each mode on coherent rays (octant-pure tiles, where the pure slab test
    and the frustum act), K6 with each ablation at tiles of 128 and 256
    rays on the random rays; closest-hit and any-hit; hits and per-tile
    pops bit for bit, and the hits against K1's; then on a stack (K5) or a
    guard (K6) too small for some tiles, which stop with pops -1, the other
    tiles equal to the plain version (ab_tile_body.check_stops)."""
    from rodent_tpu_torch.accel import build_bvh
    from rodent_tpu_torch.experiments import ab_tile_body as ab
    from rodent_tpu_torch.traversal import api, pair
    from rodent_tpu_torch.traversal.packet import TILE_MODES, traverse_packet
    runs = ties = stops = 0
    for m in (8, 24):
        verts, idx = random_tri_soup(3000, seed=70 + m)
        dev = api.bvh_to_device(build_bvh(
            verts, idx, arity=8, packet=m, leaf_threshold=32,
            leaf_cost=0.2), device)
        r = np.random.RandomState(80 + m)
        org = r.randn(8192, 3).astype(np.float32) * 3.0
        d = r.randn(8192, 3).astype(np.float32)
        d[:64, 0] = 0.0
        batches = {"random": (org, d), "coherent": coherent_rays(8192, m)}
        tmax = np.full(8192, 1e30, np.float32)
        tmax[128:160] = -1.0
        for (batch, (o, dd)), any_hit in itertools.product(
                batches.items(), (False, True)):
            rays = api.make_rays(o, dd, 0.0, np.minimum(tmax, 2.0)
                                 if any_hit else tmax, device=device)
            k1 = traverse_packet(dev, rays, any_hit=any_hit)
            comps = api.components(rays)
            modes = TILE_MODES if batch == "coherent" else ("plain",)
            for rows, mode in itertools.product((1, 2), modes):
                what = (f"soup Tri{m} {batch} K5 rows {rows} {mode} "
                        f"any_hit={any_hit}")
                kw = {"any_hit": any_hit, "count_pops": True,
                      "tile_rows": rows, **tile_args(mode)}
                k = traverse_packet(dev, rays, **kw)
                p = api.traverse(dev, rays, **kw)
                check_equal(k, p, what)
                ties += sum(against_k1(k, k1, any_hit, what, dev, comps))
                runs += 1
            if m != 8 or batch != "random":
                continue
            for tile, abl in itertools.product(
                    (128, 256), [()] + [(a,) for a in pair.ABLATIONS]):
                what = f"soup K6 tile {tile} {abl} any_hit={any_hit}"
                k = pair.traverse_pair(dev, rays, any_hit=any_hit,
                                       tile_rays=tile, ablate=abl,
                                       count_pops=True)
                p = pair.traverse_pair_components(
                    dev, *comps[:3], *comps[4:], any_hit, tile, abl,
                    count_pops=True)
                check_equal(k, p, what)
                if not abl:
                    ties += sum(against_k1(k, k1, any_hit, what, dev,
                                           comps))
                runs += 1
            for kernel, size in (("K5", 1), ("K5", 2), ("K6", 128),
                                 ("K6", 256)):
                stops += ab.check_stops(dev, comps, any_hit, kernel, size)
    log(f"[12] K5 and K6 == plain on 2 soups (Tri8, Tri24; random and "
        f"coherent rays), {runs} runs, closest-hit and any-hit: hits and "
        f"per-tile pops bit for bit; {ties} prim_id differences with K1; "
        f"{stops} tiles stopped on a small stack or guard, the others == "
        "plain")


def timed_tile_config(name, size):
    """Whether phase 12 times one of ab_tile_body.configs on the
    distribution `name`: every one on the primaries; on hall's ao rays
    tile_rows 1 and 16 (plain and frustum) and K6 at 1024 and 2048 rays;
    none on the bounce rays. The others run once, untimed, and are held
    against the plain version all the same."""
    return name == "primary" or name == "ao" and size in (1, 16, 1024, 2048)


def phase_tiles(device, hall_bvh, verts, idx, big_bvh, big_prim, side=1024):
    """[12] The tile kernels' measurement path
    (rodent_tpu_torch.experiments.ab_tile_body, as measure_packet --rows
    1,2,4,16 with and without --frustum and measure_pair --tiles
    256,1024,2048 run them) on hall-260K's 1M sorted primaries, ao and
    bounce rays, then K5 on powerplant-4.3M's sorted primaries: each
    configuration equal to the plain version on a subset
    (ab_tile_body.check_subset); those of timed_tile_config timed in turns
    with K1 through the wrappers, counted, beside its bound, the others
    launched once; with each kernel's launch count read around them; then
    the headline configurations' plain versions on all of their rays.
    Returns (the
    launches per kernel, the results, the plain versions' times)."""
    from rodent_tpu_torch.experiments import ab_tile_body as ab
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.traversal import api, packet, pair
    dists = common.distributions("hall", verts, idx, hall_bvh, side, device,
                                 ("primary", "ao", "bounces"))
    runs = [("hall", name, comps, any_hit, hall_bvh)
            for name, (comps, any_hit) in dists.items()]
    runs.append(("powerplant", "primary", big_prim, False, big_bvh))
    res, want = {}, {k: 0 for k in ab.KERNELS}
    packet.reset_launches()
    t0 = time.perf_counter()
    for scene, name, comps, any_hit, dev in runs:
        for kernel, size, mode in ab.configs(scene, name):
            key = (scene, name, kernel, size, mode)
            what = f"{scene} {name} {ab.label(kernel, size, mode)}"
            t1 = time.perf_counter()
            if not timed_tile_config(name, size):
                out = ab.launch(dev, comps, kernel, any_hit, size, mode)
                rays, tiles, _ = ab.check_subset(dev, comps, any_hit, kernel,
                                                 size, mode, out, what)
                want[kernel] += 1
                log(f"[12] {what}, untimed: {rays} rays in {tiles} tiles "
                    f"== plain; {time.perf_counter() - t1:.1f} s")
                continue
            want[kernel] += 2
            r = ab.measure(dev, comps, any_hit, device, kernel, size, mode,
                           blocks=2, what=f"{scene} {name}")
            res[key] = r
            ties, others = against_k1(r["out"], r["k1"], any_hit, what, dev,
                                      comps)
            st, ms = r["stats"], r["ms"]
            log(f"[12] {ab.line(*key, r)}; {ms * 1e6 / st['pops']:.2f} "
                f"ns per pop, {comps[4].shape[0] / ms / 1e3:.1f} Mrays/s, "
                f"{st['ray_equiv']:.1f} pops per ray-equivalent; against "
                f"K1 {ties} ties, {others} others; "
                f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.synchronize()
    launched = {k: ab.launch_count(k) for k in ab.KERNELS}
    log(f"[12] measurement path: {len(res)} configurations timed, "
        f"{sum(want.values()) - 2 * len(res)} untimed, in "
        f"{time.perf_counter() - t0:.1f} s, launches {launched} (clock, "
        f"power after: {sm_clock()})")
    for kernel in ab.KERNELS:
        check(launched[kernel] >= want[kernel],
              f"tile phase: {kernel} launched {launched[kernel]} times, "
              f"fewer than its configurations need ({want[kernel]})")
    # the headline configurations' plain versions on all of their rays
    plain = {}
    o, d, inv, _, tmin, tmax = dists["primary"][0]
    for key, kernel, size, fn in (
            ("K5", "K5", 16, lambda: api.traverse_tile_components(
                hall_bvh, o, d, inv, tmin, tmax, tile_rows=16)),
            ("K6", "K6", 2048, lambda: pair.traverse_pair_components(
                hall_bvh, o, d, inv, tmin, tmax, tile_rays=2048,
                count_pops=True))):
        ms, out = common.timed(fn, device, blocks=1)
        check_equal(res[("hall", "primary", kernel, size, "plain")]["out"],
                    out, f"hall primary {ab.label(kernel, size)} (all rays)")
        plain[key] = ms
        log(f"[12] plain version of hall primary {ab.label(kernel, size)} "
            f"on all {tmin.shape[0]} rays: {ms:.1f} ms; hits and pops == "
            f"the kernel's")
    return launched, res, plain


def tile_entry(name, replaces, kernel, launched, plain_ms, res):
    """The kernels-line entry of K5 or K6 (its hits equalled the plain
    version's bit for bit: max_abs_err 0) at its headline configuration
    on hall's primaries (K5 tile_rows 16, K6 tiles of 2,048 rays);
    "variants": every configuration's time, K1's, its share of the bound,
    its ratio to K1 and the instance's resources."""
    from rodent_tpu_torch.experiments import ab_tile_body as ab
    head = res[("hall", "primary", kernel, 16 if kernel == "K5" else 2048,
                "plain")]
    variants = {}
    for key, r in res.items():
        if key[2] != kernel:
            continue
        b_ms = r["bound"][0]
        variants[f"{key[0]} {key[1]} {ab.label(*key[2:])}"] = {
            "k1_ms": r["k1_ms"], "bound_ms": b_ms, "ms": r["ms"],
            "share": b_ms / r["ms"], "k1_ratio": r["ms"] / r["k1_ms"],
            **r["resources"]}
    return {"name": name, "route": "cuda",
            "source": "rodent_tpu_torch/csrc/bvh_tile.cu",
            "replaces": replaces, "launches": launched[kernel],
            "max_abs_err": 0.0, "ms": head["ms"], "plain_ms": plain_ms,
            "bound_ms": head["bound"][0], "bound_by": head["bound"][1],
            "library_ms": None, "variants": variants}


# probe module -> its JAX file's pallas_call site (probe_mosaic3.py has a
# second, :108, for its dep- modes)
PROBE_SITES = {"probe_mosaic": "experiments/probe_mosaic.py:16",
               "probe_mosaic2": "experiments/probe_mosaic2.py:13",
               "probe_gather": "experiments/probe_gather.py:29",
               "probe_mosaic3": "experiments/probe_mosaic3.py:56",
               "probe_chain": "experiments/probe_chain.py:80",
               "probe_body": "experiments/probe_body.py:107",
               "probe_dyn_cost": "experiments/probe_dyn_cost.py:37",
               "vpu_dtype_bench": "experiments/vpu_dtype_bench.py:31"}


def probe_key(key):
    """A probe result's key as a label: 'chase S=1', 'cond+carry5', ..."""
    if isinstance(key, tuple) and key and isinstance(key[-1], int):
        return f"{key[0]} {'S' if 'chase' in key[0] else 'rows'}={key[1]}"
    if isinstance(key, tuple):
        return "+".join(key) or "base"
    return key


def probe_plain(name, m, device):
    """The plain version of a probe's headline body on the card's tensors,
    as a call."""
    from rodent_tpu_torch.experiments import probe_gather
    if name in ("probe_mosaic", "probe_mosaic2"):
        x = m.inputs(device)
        return lambda: m.PLAIN[m.HEAD](x)
    if name == "probe_gather":
        tbl, idx = (torch.from_numpy(a).to(device)
                    for a in probe_gather.timed_inputs("fields"))
        return lambda: probe_gather.plain_fields(tbl, idx)
    if name == "probe_mosaic3":
        tab = m.inputs(m.HEAD, device)
        return lambda: m.plain(m.HEAD, tab)
    if name == "vpu_dtype_bench":
        x = m.inputs(*m.HEAD, device)
        return lambda: m.plain(m.HEAD[0], x)
    tab = m.inputs(device)
    if name == "probe_chain":
        return lambda: m.plain(*m.HEAD, tab)
    return lambda: m.plain(m.HEAD, tab)


def gather_library(m, device, launched):
    """[13] probe_gather's take_along_axis kernel (a grid over the
    card), the only probe body that one PyTorch call computes
    (torch.gather; the other bodies are loops of dependent steps or a
    control-flow machine): ab_gather_take.measure times the
    kernel and torch.gather in turns as CUDA-graph replays on every case
    of m.take_cases() and raises where an output differs from the plain
    version; the kernel's ratio to torch.gather is printed, not asserted.
    Returns its kernels-line entry: the headline (512, 128) axis 0 case,
    launches = `launched` (the kernel's count in the probes' main
    path)."""
    from rodent_tpu_torch.experiments import ab_gather_take, common
    res = ab_gather_take.measure(device, blocks=3)
    for line in ab_gather_take.report(res):
        log(f"[13] probe_gather take_along_axis {line}; equal")
    tbl, idx = (torch.from_numpy(a).to(device)
                for a in m.correct_inputs((512, 128), 0))
    plain_ms, _ = common.launch_ms(lambda: m.plain_take(tbl, idx, 0),
                                   device)
    h = res["axis0 (512, 128)"]
    return {"name": "probe_gather_take", "route": "cuda",
            "source": "rodent_tpu_torch/csrc/probes.cu",
            "replaces": PROBE_SITES["probe_gather"], "launches": launched,
            "max_abs_err": 0.0, "ms": h["ms"], "plain_ms": plain_ms,
            "bound_ms": h["bound"][0], "bound_by": h["bound"][1],
            "library_ms": h["library_ms"],
            "variants": {name: {"ms": r["ms"], "library_ms": r["library_ms"],
                                "bound_ms": r["bound"][0],
                                "ratio": r["ms"] / r["library_ms"]}
                         for name, r in res.items()}}


def phase_probes(device):
    """[13] The micro-probes: each probe file's main path (measure(): the
    correctness probes once, the timed ones at one copy and at the copies
    that fill the card), launch counts read around it; then every copy's
    output against the plain version, bit for bit; the headline bodies'
    plain versions timed on the card; the vpu kernels' SASS op counts.
    Returns the kernels-line entries."""
    import importlib
    from rodent_tpu_torch.experiments import common, vpu_dtype_bench
    mods = {n: importlib.import_module(f"rodent_tpu_torch.experiments.{n}")
            for n in PROBE_SITES}
    clock0 = sm_clock()
    for m in mods.values():
        m.launches = 0
    mods["probe_gather"].take_launches = 0
    t0 = time.perf_counter()
    res = {n: m.measure(device, blocks=3) for n, m in mods.items()}
    torch.cuda.synchronize()
    launched = {n: m.launches for n, m in mods.items()}
    take_launched = mods["probe_gather"].take_launches
    check(take_launched > 0, "probe_gather: the take_along_axis kernel was "
          "never launched")
    t_main = time.perf_counter() - t0
    clock1 = sm_clock()
    for n in mods:
        check(launched[n] >= len(res[n]), f"{n}: {launched[n]} launches for "
              f"{len(res[n])} bodies")
    log(f"[13] the probes' main path: {sum(len(r) for r in res.values())} "
        f"bodies in {t_main:.1f} s, launches {launched} (SM clock, power "
        f"before: {clock0}; after: {clock1})")
    sass = vpu_dtype_bench.sass_counts()
    for dtype, (per_word, ops) in sass.items():
        log(f"[13] vpu {dtype}: {per_word:g} SASS instructions per 32-bit "
            f"word and iteration {dict(ops)}")
    check(sass["float32"][0] == 4, f"vpu float32: {sass['float32']} "
          "instructions per iteration, not the probe's 4")
    entries = []
    for n, m in mods.items():
        ok = m.check(res[n])
        bad = [probe_key(k) for k, v in ok.items() if not v]
        check(not bad, f"{n}: {bad} differ from the plain version")
        for k, r in res[n].items():
            if "ms" not in r:
                continue
            extra = f" ({r['memory']} memory)" if "memory" in r else ""
            rate = (f"; {r['tops1']:.3f} Top/s one copy, {r['tops']:.3f} "
                    f"with the card full" if "tops" in r else "")
            log(f"[13] {n} {probe_key(k)}{extra}: one copy {r['ms1']:.4f} "
                f"ms = {r['ns1']:.1f} ns/iter; {r['copies']} copies "
                f"{r['ms']:.4f} ms = {r['ns_sm']:.3f} ns/iter per SM; bound "
                f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), "
                f"{r['bound'][0] / r['ms']:.1%} of it{rate}")
        plain_ms, _ = common.timed(probe_plain(n, m, device), device,
                                   blocks=1)
        head = m.HEAD
        if n in ("probe_mosaic", "probe_mosaic2"):
            x = m.inputs(device)
            ms, _ = common.launch_ms(lambda: m.run(head, x), device)
            bound = m.bound(head)
            variants = {b: {"equal": ok[b]} for b in res[n]}
        else:
            ms, bound = res[n][head]["ms"], res[n][head]["bound"]
            variants = {probe_key(k): {kk: r[kk] for kk in (
                "ms1", "ns1", "ms", "copies", "ns_sm")}
                | {"bound_ms": r["bound"][0]}
                for k, r in res[n].items() if "ms" in r}
        log(f"[13] {n}: every body == plain bit for bit ({len(ok)} "
            f"checked); headline {probe_key(head)} {ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms on the card")
        entries.append({
            "name": n, "route": "cuda",
            "source": "rodent_tpu_torch/csrc/probes.cu",
            "replaces": PROBE_SITES[n], "launches": launched[n]
            - (take_launched if n == "probe_gather" else 0),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "variants": variants})
        if n == "probe_gather":
            entries.append(gather_library(m, device, take_launched))
    return entries


def phase_bodies(device, hall, verts, idx, big_bvh, big_prim, big_ao, pool):
    """[14] K1/K2/K3's two bodies, from the group library: every check of
    ab_body (both bodies bit for bit against the plain version) on the
    soups of phase 3, the tie scenes, hall's primaries and powerplant's
    primaries and ao; then the A/B in turns at the render and benchmark
    widths: hall's distributions, the launches of one render_iteration
    sample of phase 5 (captured here) and the pool step of phase 9
    (`pool`). Returns {kernel name: {width: both bodies' ms, the bound,
    their resources}}, the kernels line's "variants"."""
    from rodent_tpu_torch.experiments import ab_body, common
    from rodent_tpu_torch.traversal import api
    t0 = time.perf_counter()
    ab_body.reset_launches()
    hall_bvh = hall.device["bvh"]
    hall_dists = common.distributions("hall", verts, idx, hall_bvh, 1024,
                                      device, ("primary", "ao", "bounces"))
    runs = 0
    for name, dev, rays, short in soups(device):
        for any_hit, r in ((False, rays), (True, short)):
            ab_body.check_bodies(dev, api.components(r), any_hit, name)
            runs += 1
    ties = ab_body.check_ties(device)
    ab_body.check_bodies(hall_bvh, hall_dists["primary"][0], False,
                         "hall primary")
    ab_body.check_bodies(big_bvh, big_prim, False, "powerplant primary")
    ab_body.check_bodies(big_bvh, big_ao, True, "powerplant ao")
    log(f"[14] both bodies == plain bit for bit (K2 == K1, K3's counters == "
        f"plain) on {runs} soup runs, the tie scenes (rays that hit: "
        f"{ties}; the first of two equal hits kept), hall's "
        f"{hall_dists['primary'][0][4].shape[0]} primaries, powerplant's "
        f"{big_prim[4].shape[0]} primaries and {big_ao[4].shape[0]} ao rays "
        f"({time.perf_counter() - t0:.1f} s)")
    widths = ab_body.widths_of(hall_bvh, hall_dists,
                               ab_body.hall_render_rays(hall), big_bvh,
                               big_prim, pool)
    caps = ab_body.caps_of(hall_bvh)
    check(caps == ab_body.caps_of(big_bvh),
          f"powerplant takes other stacks than hall: "
          f"{ab_body.caps_of(big_bvh)}")
    table = ab_body.resource_table(caps)
    clock0 = sm_clock()
    t0 = time.perf_counter()
    res = ab_body.measure(device, widths, blocks=3)
    log(f"[14] A/B of {len(res)} widths in {time.perf_counter() - t0:.1f} s "
        f"(SM clock, power before: {clock0}; after: {sm_clock()}); group "
        f"library launches in this phase: {ab_body.launches}")
    check(all(ab_body.launches.values()),
          f"a body or kernel was never launched: {ab_body.launches}")
    for line in ab_body.report(res, table, {"hall": 8, "powerplant": 24}):
        log(f"[14] {line}")
    variants = {}
    for (scene, label, var), r in res.items():
        name = {"K1": "bvh_traverse", "K2": "bvh_traverse_prefetch",
                "K3": "bvh_traverse_count"}[var]
        entry = {body: r[body] for body in ab_body.BODIES}
        entry.update(bound_ms=r["bound"][0], rays=r["n"],
                     pops_ray=r["pops_ray"])
        entry["resources"] = {
            body: table[(body, var, 8, 8 if scene == "hall" else 24,
                         r["any_hit"])] for body in ab_body.BODIES}
        variants.setdefault(name, {})[f"{scene} {label}"] = entry
    return variants


HALL_VIEW = ((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0)


def profile_split(fn):
    """Runs fn() once under torch.profiler and splits the device time of
    its kernels: the texture-bank lookups (the kernels launched inside
    integrator._sample_bank, marked with a record_function range here),
    the traversal kernels (bvh_traverse_kernel: K1, K2) and the rest; the
    device idle share is 1 - (union of the kernel intervals) / wall;
    "top": the six kernel names with the most device time (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from rodent_tpu_torch.render import integrator
    bank = integrator._sample_bank

    def marked(*args):
        with record_function("rt_sample_bank"):
            return bank(*args)

    integrator._sample_bank = marked
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        integrator._sample_bank = bank
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name != "rt_sample_bank"]
    total = sum(e.time_range.elapsed_us() for e in dev) * 1e-3
    trav = sum(e.time_range.elapsed_us() for e in dev
               if "bvh_traverse_kernel" in e.name) * 1e-3
    ranges = [e for e in events if e.name == "rt_sample_bank"
              and e.device_type == DeviceType.CPU]
    bank_ms = sum(getattr(e, "device_time_total", None)
                  or getattr(e, "cuda_time_total", 0) for e in ranges) * 1e-3
    by_name = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() * 1e-3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_ms": wall * 1e3, "kernel_ms": total, "busy_ms": busy * 1e-3,
            "idle": 1.0 - busy * 1e-3 / (wall * 1e3), "kernels": len(dev),
            "bank_ms": bank_ms, "bank_calls": len(ranges),
            "traversal_ms": trav, "rest_ms": total - trav - bank_ms,
            "top": top}


def phase_mathall(device):
    """[15a] mathall-260K (every BSDF kind, two textures) through
    compile_mesh: render_iteration at 1920x1088 spp 4 mpl 20 (K1), one
    persistent iteration under select_render_policy, the profile split of
    a textured iteration, and the mathall golden gate through both
    renderers. Returns (K1 launches of render_iteration, the scene, its
    materials, its textures)."""
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.io import png
    from rodent_tpu_torch.render import film as film_mod
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.compiler import (
        compile_mesh, packet_mode, select_render_policy)
    from rodent_tpu_torch.render.integrator import (
        render_iteration, render_iteration_persistent)
    from rodent_tpu_torch.traversal import packet
    from rodent_tpu_torch.utils import testscenes
    t0 = time.perf_counter()
    verts, idx = testscenes.make_hall(common.SIZES["hall"], rich_mats=True)
    mats, texs = testscenes.mat_hall_materials()
    scene = compile_mesh(verts, idx, device, max_path_len=20,
                         emitter="inside", materials=mats, tex_images=texs,
                         bvh_kwargs=common.TRI8)
    mode = packet_mode(scene.device)
    check(mode == "hybrid", f"mathall tier {mode}")
    log(f"[15a] mathall-260K: {scene.mesh.num_tris} tris, bank "
        f"{tuple(scene.device['textures'].shape)}, kinds "
        f"{scene.device['mat_kinds']}, tier {mode}; compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    w, h, spp, iters = 1920, 1088, 4, 3
    cam = Camera.make(*HALL_VIEW, w, h)
    film = film_mod.new_film(w, h, device)
    stats, secs = {}, []
    packet.reset_launches()
    for it in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = render_iteration(scene.device, cam, film, w, h, spp, it,
                                stats=stats)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = dict(packet.launches)
    k1, bounces = launches["bvh_traverse"], stats["bounces"]
    check(k1 >= 2 * bounces > 0 and launches["bvh_traverse_prefetch"] == 0,
          f"mathall render: launches {launches} for {bounces} bounces")
    check(bool(torch.isfinite(film).all()) and float(film.min()) >= 0.0,
          "mathall render: film not finite or negative")
    img = film_mod.tonemap(film, w, h, iters)
    check(img.mean() > 1.0, "mathall render: black image")
    msps = w * h * spp / float(np.mean(secs[1:])) / 1e6
    log(f"[15a] render_iteration mathall-260K {w}x{h} spp {spp} mpl 20: "
        f"iterations {', '.join(f'{x:.3f}' for x in secs)} s (first warms "
        f"up) -> {msps:.3f} Msamples/s; {bounces} bounces, {k1} K1 "
        f"launches; image mean {img.mean():.1f}/255")

    pol = select_render_policy(scene.device)
    packet.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film2, steps = render_iteration_persistent(
        scene.device, cam, film_mod.new_film(w, h, device), w, h, spp, 0,
        return_steps=True, **pol)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(packet.launches["bvh_traverse"] > 0
          and bool(torch.isfinite(film2).all()),
          f"mathall persistent: launches {packet.launches}")
    log(f"[15a] render_iteration_persistent under {pol}: one iteration "
        f"{dt:.3f} s = {w * h * spp / dt / 1e6:.3f} Msamples/s, {steps} "
        f"steps, {packet.launches['bvh_traverse']} K1 launches")

    split = profile_split(lambda: render_iteration(
        scene.device, cam, film_mod.new_film(w, h, device), w, h, 1, 0))
    check(split["bank_calls"] > 0 and split["kernel_ms"] > 0.0,
          f"profile: {split}")
    log(f"[15a] profile of one textured render_iteration ({w}x{h}, spp 1): "
        f"wall {split['wall_ms']:.1f} ms, {split['kernels']} kernels, "
        f"kernel time {split['kernel_ms']:.1f} ms = bank lookups "
        f"{split['bank_ms']:.1f} ({split['bank_calls']} calls) + "
        f"traversal (K1) {split['traversal_ms']:.1f} + the rest "
        f"{split['rest_ms']:.1f}; device busy {split['busy_ms']:.1f} ms, "
        f"idle share {split['idle']:.3f}")

    with open(os.path.join(REPO, "tests", "golden", "golden_meta.json")) as f:
        m = json.load(f)["mathall"]
    gv, gi = testscenes.make_hall(m["tris"], rich_mats=True)
    gscene = compile_mesh(gv, gi, device, max_path_len=8, emitter="inside",
                          materials=mats, tex_images=texs)
    gw, gh = m["w"], m["h"]
    gcam = Camera.make(*HALL_VIEW, gw, gh)
    golden = png.read_png(os.path.join(REPO, "tests", "golden",
                                       "mathall.png"))[..., :3]
    gate = 3.0 * m["calib_mse_u8"] + 1.0
    for render in (render_iteration, render_iteration_persistent):
        film = film_mod.new_film(gw, gh, device)
        packet.reset_launches()
        for it in range(m["test_iters"]):
            film = render(gscene.device, gcam, film, gw, gh, m["spp"], it,
                          packet=True)
        gimg = film_mod.tonemap(film, gw, gh, m["test_iters"])
        mse = film_mod.mse_u8(golden, gimg)
        check(packet.launches["bvh_traverse"] > 0,
              f"mathall golden: launches {packet.launches}")
        check(mse <= gate, f"mathall golden ({render.__name__}): MSE "
              f"{mse:.1f} over the gate {gate:.1f}")
        check(abs(float(gimg.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"],
              f"mathall golden ({render.__name__}): image mean "
              f"{gimg.mean():.1f} vs {m['mean_u8']}")
        log(f"[15a] mathall golden gate through {render.__name__} (K1, "
            f"{packet.launches['bvh_traverse']} launches): MSE {mse:.2f} <= "
            f"{gate:.2f}, image mean {gimg.mean():.2f} (golden "
            f"{m['mean_u8']})")
    return k1, scene, mats, texs


def run_tool(main, argv):
    """Runs a tool's main (or run) with its standard output captured,
    logs that output and returns (its return value, the output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main([str(a) for a in argv])
    text = buf.getvalue()
    for line in text.strip().splitlines():
        log(f"    | {line}")
    return out, text


def phase_obj_files(device, scene, mats, texs):
    """[15b, 15c] mathall-260K written as OBJ + MTL + PNG textures under
    build/: converter -> load_data_dir against compile_obj, tensor for
    tensor on the card; tools.render at 1920x1088 through K1 (its policy,
    spp 4) and K2 (--traversal hybrid-hbm, spp 1); the traversal file
    pipeline ray_gen -> bvh_extractor -> bench_traversal (K1) -> fbuf2png,
    held against K1 on the rays and BVH read back from the files. Returns
    tools.render's K2 launches."""
    import re
    import shutil
    from rodent_tpu_torch.accel import WideBvh
    from rodent_tpu_torch.io import formats, png
    from rodent_tpu_torch.io.obj import Material
    from rodent_tpu_torch.render.compiler import compile_obj, load_data_dir
    from rodent_tpu_torch.tools import (bench_traversal, bvh_extractor,
                                        converter, fbuf2png, ray_gen)
    from rodent_tpu_torch.tools import render as render_tool
    from rodent_tpu_torch.traversal import api, packet
    out = os.path.join(REPO, "build", "phase15")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    emitter = Material(name="emitter", ke=scene.mat_params[-1]["ke"])
    obj = write_obj_scene(scene.mesh, list(mats) + [emitter], texs, out,
                          "mathall")
    log(f"[15b] wrote {obj} ({os.path.getsize(obj) / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    direct = compile_obj(obj, device, max_path_len=20)
    check(direct.tex_files == ["checker.png", "plaster.png"]
          and direct.mesh.num_tris == scene.mesh.num_tris,
          f"compile_obj: {direct.tex_files}, {direct.mesh.num_tris} tris")
    t1 = time.perf_counter()
    data = os.path.join(out, "data")
    run_tool(converter.main, [obj, "-d", data, "--max-path-len", 20])
    t2 = time.perf_counter()
    loaded = load_data_dir(data, device)

    def same(a, b, path):
        if isinstance(a, dict):
            check(set(a) == set(b), f"load_data_dir {path}: keys differ")
            return sum(same(a[k], b[k], f"{path}/{k}") for k in a)
        if isinstance(a, torch.Tensor):
            # bytes, not values: the node table's NaN slots are unequal
            check(b.device == a.device and a.dtype == b.dtype
                  and a.shape == b.shape
                  and bool(torch.equal(a.flatten().view(torch.uint8),
                                       b.flatten().view(torch.uint8))),
                  f"load_data_dir {path} differs from compile_obj")
            return 1
        check(a == b, f"load_data_dir {path}: {a} != {b}")
        return 0

    n = same(direct.device, loaded.device, "device")
    log(f"[15b] compile_obj {t1 - t0:.1f} s, converter {t2 - t1:.1f} s, "
        f"load_data_dir {time.perf_counter() - t2:.1f} s: {n} tensors on "
        f"the card equal bit for bit")
    del direct, loaded

    view = ["--eye", *HALL_VIEW[0], "--dir", *HALL_VIEW[1], "--fov",
            HALL_VIEW[3]]
    k2 = 0
    for traversal, key in ((None, "bvh_traverse"),
                           ("hybrid-hbm", "bvh_traverse_prefetch")):
        png_path = os.path.join(out, f"render-{traversal or 'auto'}.png")
        # two iterations: the first warms up, the second is timed; K2's
        # route at spp 1 (its 32K pool renders spp 4 in about 29 s an
        # iteration, host-bound: ROADMAP B7)
        argv = [obj, "--width", 1920, "--height", 1088, "--spp",
                1 if traversal else 4, "--bench", 2, "--max-path-len", 20,
                *view, "-o", png_path]
        if traversal:
            argv += ["--traversal", traversal]
        packet.reset_launches()
        t0 = time.perf_counter()
        film, text = run_tool(render_tool.run, argv)
        dt = time.perf_counter() - t0
        n = packet.launches[key]
        check(re.search(r"^# [\d.]+/[\d.]+/[\d.]+ \(min/med/max "
                        r"Msamples/s\)$", text, re.M) is not None,
              f"tools.render printed no Msamples line: {text!r}")
        check(n > 0, f"tools.render {traversal}: launches {packet.launches}")
        check(bool(torch.isfinite(film).all()), "tools.render: film not finite")
        img = png.read_png(png_path)
        check(img.mean() > 0.0, "tools.render: black PNG")
        if key == "bvh_traverse_prefetch":
            k2 = n
        log(f"[15b] tools.render --traversal {traversal or 'auto'}: {n} "
            f"{'K2' if traversal else 'K1'} launches, PNG mean "
            f"{img.mean():.1f}, "
            f"{dt:.1f} s with compile_obj")

    t0 = time.perf_counter()
    rays_f = os.path.join(out, "cam.rays")
    bvh_f = os.path.join(out, "mathall.bvh")
    fbuf_f = os.path.join(out, "cam.fbuf")
    run_tool(ray_gen.main, ["primary", *HALL_VIEW[0], *HALL_VIEW[1],
                            *HALL_VIEW[2], HALL_VIEW[3], 1024, 1024, rays_f])
    run_tool(bvh_extractor.main, [obj, bvh_f, "--width", 8])
    packet.reset_launches()
    _, text = run_tool(bench_traversal.main, ["-bvh", bvh_f, "-ray", rays_f,
                                              "--bench", 3, "-o", fbuf_f])
    check(packet.launches["bvh_traverse"] > 0,
          f"bench_traversal: launches {packet.launches}")
    count = int(re.search(r"^(\d+) intersection\(s\)$", text, re.M)[1])
    bvh = WideBvh.from_block(formats.read_bvh(bvh_f, formats.BVH8_TRI4))
    r = formats.read_rays(rays_f)
    hit = packet.traverse_packet(
        api.bvh_to_device(bvh, device),
        api.make_rays(r["org"], r["dir"], r["tmin"], r["tmax"],
                      device=device))
    k1_count = int((hit["prim_id"] >= 0).sum())
    t = formats.read_fbuf(fbuf_f)
    check(count == k1_count, f"pipeline: {count} intersections, K1 "
          f"{k1_count}")
    check(np.array_equal(t, hit["t"].cpu().numpy()),
          "pipeline: the .fbuf's t differ from K1's")
    png_f = os.path.join(out, "cam.png")
    run_tool(fbuf2png.main, ["-n", "-sx", 1024, "-sy", 1024, fbuf_f, png_f])
    img = png.read_png(png_f)
    check(img.shape == (1024, 1024, 4) and img[..., 0].std() > 1.0,
          "fbuf2png: flat image")
    log(f"[15c] file pipeline on {len(t)} primaries: {count} "
        f"intersections, equal to K1's on the rays and BVH read back, t "
        f"bit for bit; {time.perf_counter() - t0:.1f} s")
    return k2


def write_obj_scene(mesh, materials, tex_images, out_dir, name="scene"):
    """Writes a compiled mesh as OBJ + MTL + PNG textures into out_dir: its
    vertices and texture coordinates as `v`/`vt`, its triangles grouped by
    material (`usemtl`), `materials` (obj Materials indexed by the mesh's
    material ids) as the MTL, and each linear texture of `tex_images`
    (name -> (H, W, 3)) gamma-encoded to 8 bits as <name>.png, which the
    materials' map_Kd/map_Ks/map_Ke then name. Returns the OBJ's path."""
    from rodent_tpu_torch.io import png
    os.makedirs(out_dir, exist_ok=True)
    for tex, img in tex_images.items():
        u8 = np.round(np.power(np.clip(img, 0.0, 1.0), 1.0 / 2.2) * 255.0)
        png.write_png(os.path.join(out_dir, f"{tex}.png"),
                      u8.astype(np.uint8))
    lines = []
    for m in materials:
        lines += [f"newmtl {m.name}", "Kd %r %r %r" % tuple(m.kd),
                  "Ks %r %r %r" % tuple(m.ks), "Ke %r %r %r" % tuple(m.ke),
                  f"Ns {m.ns!r}", f"Ni {m.ni!r}", "Tf %r %r %r" % tuple(m.tf),
                  f"illum {m.illum}"]
        for tag, tex in (("map_Kd", m.map_kd), ("map_Ks", m.map_ks),
                         ("map_Ke", m.map_ke)):
            if tex:
                lines.append(f"{tag} {tex}.png")
    with open(os.path.join(out_dir, f"{name}.mtl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    tri = mesh.tri_indices + 1
    mat = mesh.tri_materials
    order = np.argsort(mat, kind="stable")
    with open(os.path.join(out_dir, f"{name}.obj"), "w") as f:
        f.write(f"mtllib {name}.mtl\n")
        f.write("".join("v %.9g %.9g %.9g\n" % tuple(v)
                        for v in mesh.vertices.tolist()))
        f.write("".join("vt %.9g %.9g\n" % tuple(t)
                        for t in mesh.texcoords.tolist()))
        cur = None
        for t in order.tolist():
            if mat[t] != cur:
                cur = mat[t]
                f.write(f"usemtl {materials[cur].name}\n")
            a, b, c = tri[t].tolist()
            f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
    return os.path.join(out_dir, f"{name}.obj")


# phase 16: the closed box's view (the boxes are experiments.common's)
BOX_VIEW = ((0.0, 1.0, 0.9), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), 60.0)


def no_k1(before, what):
    """The dual-queue and dense routes launch no traversal kernel."""
    from rodent_tpu_torch.traversal import packet
    check(packet.launches == before,
          f"{what}: kernel launches {before} -> {packet.launches}")


def phase_dual_queue(device, bvh, verts, idx, side=1024):
    """[16a] The dual-queue engine on hall-260K's sorted primaries, ao and
    bounce rays, without and with staged compaction (compact_stages=5),
    each timed in turns against K1 on the same rays; hits equal K1's up to
    exact-t ties (any-hit: hit/miss exact), compaction's equal the single
    stage's bit for bit; trips from debug_counters. Returns the rows."""
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.traversal import packet, tiled
    from rodent_tpu_torch.traversal.packet import traverse_packet_components
    dists = common.distributions("hall", verts, idx, bvh, side, device,
                                 ("primary", "ao", "bounces"))
    rows = {}
    for name, (comps, ah) in dists.items():
        n = comps[4].shape[0]

        def k1(comps=comps, ah=ah):
            return traverse_packet_components(bvh, *comps, any_hit=ah)

        def dq(compact, comps=comps, ah=ah):
            return lambda: tiled.traverse_components(
                bvh, *comps, any_hit=ah, compact_stages=compact)

        before = dict(packet.launches)
        cnt = tiled.traverse_components(bvh, *comps, any_hit=ah,
                                        debug_counters=True)
        tiled.reset_trips()
        plain = dq(0)()
        trips0 = dict(tiled.trips)
        tiled.reset_trips()
        staged = dq(5)()
        trips5 = dict(tiled.trips)
        no_k1(before, f"dual-queue {name}")
        check(all(bool(torch.equal(cnt[k], plain[k])) for k in plain)
              and all(bool(torch.equal(staged[k], plain[k]))
                      for k in plain),
              f"dual-queue {name}: compaction or counters change the hits")
        k_ms, d_ms, k_hit, _ = common.in_turns(k1, dq(0), device, blocks=3)
        k_ms2, c_ms, _, _ = common.in_turns(k1, dq(5), device, blocks=3)
        if ah:
            check(bool(torch.equal(plain["prim_id"] >= 0,
                                   k_hit["prim_id"] >= 0)),
                  f"dual-queue {name}: any-hit hit/miss differs from K1")
            ties, err = 0, 0.0
        else:
            ties, err = compare_hits(plain, k_hit, f"dual-queue {name}")
            check(ties < TIE_LIMIT * n, f"dual-queue {name}: {ties} ties")
        c = cnt["counters"]
        if name == "primary":
            rows["profile"] = profile_engine(dq(0), c["iters"],
                                             "dual-queue primary")
        rows[name] = {"rays": n, "any_hit": ah, "k1_ms": (k_ms + k_ms2) / 2,
                      "ms": d_ms, "compact_ms": c_ms, "iters": c["iters"],
                      "leaf_iters": c["leaf_iters"],
                      "live_share": float(c["live_sum"]) / c["iters"] / n,
                      "compact_trips": trips5["trips"], "ties": ties,
                      "max_abs_err": err}
        log(f"[16a] hall-260K {name} ({n} rays, "
            f"{'any' if ah else 'closest'}-hit): dual-queue "
            f"{d_ms:.2f} ms, with compaction {c_ms:.2f} ms, K1 "
            f"{rows[name]['k1_ms']:.4f} ms (in turns) -> "
            f"{d_ms / rows[name]['k1_ms']:.0f}x / "
            f"{c_ms / rows[name]['k1_ms']:.0f}x K1; trips {c['iters']} "
            f"(leaf unit {c['leaf_iters']}, {trips0['trips']} without "
            f"counters, {trips5['trips']} in the compacted stages), live "
            f"share {rows[name]['live_share']:.3f}; {ties} exact-t ties "
            f"with K1, max |dt,du,dv| {err:.3g}; compaction bit for bit")
    return rows


def profile_engine(fn, trips, what):
    """[16] One call of an engine under torch.profiler (profile_split):
    its wall and device time, kernels per trip, the device's idle share
    and the kernels that take the most device time."""
    split = profile_split(fn)
    top = ", ".join(f"{name[:48]} {ms:.1f}" for name, ms in split["top"])
    log(f"[16] profile of one {what} traversal: wall "
        f"{split['wall_ms']:.1f} ms, {split['kernels']} kernels "
        f"({split['kernels'] / max(trips, 1):.0f} per trip), kernel time "
        f"{split['kernel_ms']:.1f} ms, device idle share "
        f"{split['idle']:.3f}; most device time (ms): {top}")
    return {k: split[k] for k in ("wall_ms", "kernel_ms", "idle", "kernels",
                                  "top")}


def box_rays(device, side, tmax):
    """side x side pinhole rays from BOX_VIEW's eye, jittered in their
    pixels (seed 16) so that no ray runs exactly through a quad's
    diagonal, where its two triangles tie."""
    from rodent_tpu_torch.traversal import api
    eye, d, up, fov = (np.asarray(x, np.float32) for x in BOX_VIEW)
    right = np.cross(d, up)
    u2 = np.cross(right, d)
    scale = np.tan(np.radians(fov) / 2)
    jitter = np.random.RandomState(16).rand(2, side, side)
    kx, ky = np.meshgrid(np.arange(side), np.arange(side))
    kx = (kx + jitter[0]) / side * 2 - 1
    ky = 1 - (ky + jitter[1]) / side * 2
    dirs = (d + kx[..., None] * scale * right
            + ky[..., None] * scale * u2).reshape(-1, 3)
    org = np.tile(eye, (dirs.shape[0], 1))
    return api.components(api.make_rays(org, dirs, 0.0, tmax,
                                        device=device))


def phase_dense(device, box_obj, side=1024):
    """[16b] The dense engine on the closed box (the dense tier): 1M
    pinhole rays closest-hit, timed in turns against K1, hits equal up to
    exact-t ties; any-hit rays ending at t 1.8 hit/miss equal. Returns the
    row."""
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.render.compiler import compile_obj, packet_mode
    from rodent_tpu_torch.traversal import dense, packet
    from rodent_tpu_torch.traversal.packet import traverse_packet_components
    scene = compile_obj(box_obj, device, max_path_len=8)
    bvh = scene.device["bvh"]
    packets = bvh["tris"].shape[0]
    check(packets <= dense.DENSE_MAX_PACKETS
          and packet_mode(scene.device) == "dense",
          f"box: {packets} packets, tier {packet_mode(scene.device)}")
    comps = box_rays(device, side, 1e30)
    short = box_rays(device, side, 1.8)
    n = comps[4].shape[0]
    before = dict(packet.launches)
    hit = dense.traverse_dense_components(bvh, *comps)
    blocked = dense.traverse_dense_components(bvh, *short, any_hit=True)
    no_k1(before, "dense")
    k_ms, d_ms, k_hit, _ = common.in_turns(
        lambda: traverse_packet_components(bvh, *comps),
        lambda: dense.traverse_dense_components(bvh, *comps), device)
    split = profile_engine(
        lambda: dense.traverse_dense_components(bvh, *comps), packets,
        "dense (a trip: a packet)")
    ties, err = compare_hits(hit, k_hit, "dense box")
    check(ties < TIE_LIMIT * n, f"dense box: {ties} ties")
    check(bool((hit["prim_id"] >= 0).all()),
          "dense box: a ray left the box")
    kb = traverse_packet_components(bvh, *short, any_hit=True)
    frac = float((blocked["prim_id"] >= 0).float().mean())
    check(bool(torch.equal(blocked["prim_id"] >= 0, kb["prim_id"] >= 0))
          and 0.0 < frac < 1.0,
          f"dense box: any-hit hit/miss differs from K1 ({frac})")
    log(f"[16b] dense engine, the box ({packets} Tri8 packets), {n} rays: "
        f"{d_ms:.4f} ms against K1 {k_ms:.4f} ms (in turns) -> "
        f"{d_ms / k_ms:.1f}x K1; {ties} exact-t ties, max |dt,du,dv| "
        f"{err:.3g}; any-hit to t 1.8: hit/miss equal, blocked fraction "
        f"{frac:.4f}")
    return {"rays": n, "packets": packets, "ms": d_ms, "k1_ms": k_ms,
            "ties": ties, "max_abs_err": err, "profile": split}


def phase_golden_tiled(device):
    """[16c] Crown's golden gate in the golden's own configuration
    (experiments/make_goldens.py): render_iteration_persistent with
    packet=False, compact=5, on the dual-queue engine alone."""
    from rodent_tpu_torch.io import png
    from rodent_tpu_torch.render import film as film_mod
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.compiler import compile_mesh
    from rodent_tpu_torch.render.integrator import (
        render_iteration_persistent)
    from rodent_tpu_torch.traversal import packet, tiled
    from rodent_tpu_torch.utils import testscenes
    gdir = os.path.join(REPO, "tests", "golden")
    with open(os.path.join(gdir, "golden_meta.json")) as f:
        m = json.load(f)["crown"]
    verts, idx = testscenes.make_crown(m["tris"])
    scene = compile_mesh(verts, idx, device, max_path_len=8,
                         emitter="above")
    w, h = m["w"], m["h"]
    cam = Camera.make((4.2, 1.8, 1.2), (-4.2, -1.4, -1.2), (0, 1, 0), 42.0,
                      w, h)
    film = film_mod.new_film(w, h, device)
    before = dict(packet.launches)
    tiled.reset_trips()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(m["test_iters"]):
        film = render_iteration_persistent(scene.device, cam, film, w, h,
                                           m["spp"], it, packet=False,
                                           compact=5)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    no_k1(before, "crown golden (dual-queue)")
    img = film_mod.tonemap(film, w, h, m["test_iters"])
    golden = png.read_png(os.path.join(gdir, "crown.png"))[..., :3]
    mse = film_mod.mse_u8(golden, img)
    gate = 3.0 * m["calib_mse_u8"] + 1.0
    check(mse <= gate, f"crown golden (dual-queue): MSE {mse:.1f} over the "
          f"gate {gate:.1f}")
    check(abs(float(img.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"],
          f"crown golden (dual-queue): image mean {img.mean():.1f}")
    log(f"[16c] crown golden gate through render_iteration_persistent("
        f"packet=False, compact=5): MSE {mse:.2f} <= {gate:.2f}, image "
        f"mean {img.mean():.2f} (golden {m['mean_u8']}); {dt:.1f} s, "
        f"{tiled.trips['trips']} trips, no kernel launch")
    return mse, dt


def phase_hybrid_policy(device, scene, w=480, h=272):
    """[16d] One persistent iteration on hall-260K under the JAX package's
    hybrid-tier policy (packet=False, compact=5, 64K pool), at a reduced
    image (480x272, spp 1; the bench's is 1920x1088 spp 4)."""
    from rodent_tpu_torch.render import film as film_mod
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.integrator import (
        render_iteration_persistent)
    from rodent_tpu_torch.traversal import packet, tiled
    cam = Camera.make(*HALL_VIEW, w, h)
    before = dict(packet.launches)
    tiled.reset_trips()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film, steps = render_iteration_persistent(
        scene.device, cam, film_mod.new_film(w, h, device), w, h, 1, 0,
        packet=False, compact=5, pool=1 << 16, return_steps=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    no_k1(before, "hybrid policy (dual-queue)")
    check(bool(torch.isfinite(film).all()) and float(film.mean()) > 0.0,
          "hybrid policy: film not finite or black")
    msps = w * h / dt / 1e6
    log(f"[16d] render_iteration_persistent(packet=False, compact=5, pool "
        f"65536) on hall-260K {w}x{h} spp 1: {dt:.2f} s = {msps:.4f} "
        f"Msamples/s, {steps} steps, {tiled.trips['trips']} trips "
        f"({tiled.trips['leaf_trips']} with the leaf unit), no kernel "
        f"launch")
    return {"s": dt, "msamples": msps, "steps": steps,
            "trips": tiled.trips["trips"]}


def phase_engine_tools(device):
    """[16e] The tools on the engines: tools.render --traversal tiled and
    --traversal dense on the box (no kernel launch), quality_gate on the
    open box against a reference PNG rendered here (K1, 8 iterations), and
    a scripted view session."""
    import re
    import shutil
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.io import png
    from rodent_tpu_torch.render import film as film_mod
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.compiler import compile_obj
    from rodent_tpu_torch.render.integrator import (
        render_iteration_persistent)
    from rodent_tpu_torch.tools import quality_gate, view
    from rodent_tpu_torch.tools import render as render_tool
    from rodent_tpu_torch.traversal import packet
    out = os.path.join(REPO, "build", "phase16")
    shutil.rmtree(out, ignore_errors=True)
    box, open_box = common.write_boxes(out)
    args = [box, "--width", 160, "--height", 120, "--spp", 2, "--bench", 2,
            "--max-path-len", 8, "--eye", *BOX_VIEW[0], "--dir",
            *BOX_VIEW[1]]
    for traversal in ("tiled", "dense"):
        png_path = os.path.join(out, f"render-{traversal}.png")
        before = dict(packet.launches)
        t0 = time.perf_counter()
        film, text = run_tool(render_tool.run, args + [
            "--traversal", traversal, "-o", png_path])
        no_k1(before, f"tools.render --traversal {traversal}")
        check(re.search(r"^# [\d.]+/[\d.]+/[\d.]+ \(min/med/max "
                        r"Msamples/s\)$", text, re.M) is not None
              and bool(torch.isfinite(film).all())
              and png.read_png(png_path).mean() > 1.0,
              f"tools.render --traversal {traversal}: {text!r}")
        log(f"[16e] tools.render --traversal {traversal} on the box: no "
            f"kernel launch, {time.perf_counter() - t0:.1f} s")

    w, h = 64, 48
    scene = compile_obj(open_box, device, max_path_len=64)
    cam = Camera.make(*quality_gate.CAMERA, w, h)
    film = film_mod.new_film(w, h, device)
    for it in range(8):
        film = render_iteration_persistent(scene.device, cam, film, w, h, 4,
                                           it)
    ref = os.path.join(out, "ref.png")
    png.write_png(ref, film_mod.tonemap(film, w, h, 8))
    code, text = run_tool(quality_gate.main, [
        "--scene", open_box, "--ref", ref, "--iters", 2,
        "-o", os.path.join(out, "gate.png")])
    check(code == 0 and text.strip().endswith("PASS"),
          f"quality_gate: exit {code}: {text!r}")
    view_png = os.path.join(out, "view.png")
    code, _ = run_tool(view.main, [
        box, "--eye", *BOX_VIEW[0], "--dir", *BOX_VIEW[1], "--width", 64,
        "--height", 48, "--keys", "Upq", "--quiet", "--iters", 4, "-o",
        view_png])
    img = png.read_png(view_png)
    check(code == 0 and img.shape == (48, 64, 3) and img.mean() > 1.0,
          f"view: exit {code}, PNG {img.shape} mean {img.mean():.1f}")
    log(f"[16e] quality_gate on the open box and a scripted view session "
        f"on the box passed; view PNG mean {img.mean():.1f}")


def film_close(got, want, what):
    """A sharded film against the single-device one: within rtol/atol 1e-5
    (tests/test_parallel.py's bound). Returns (share of bit-identical
    values, max |difference|)."""
    got = torch.as_tensor(got).to(want.device)
    check(got.shape == want.shape, f"{what}: film shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: film not finite")
    check(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5)),
          f"{what}: film outside rtol/atol 1e-5 of the single-device film")
    return (float((got == want).float().mean()),
            float((got - want).abs().max()))


def sharded_rank(calls, device=None):
    """[17b] The rank body of the spawned groups: mesh.run_calls on each
    call in turn (its args placed on the rank's card before its timed
    region), with the K1 and K2 launches the call made on this rank and
    the CUDA device current after it. It lives in this script, which the
    spawned ranks import, so that the library keeps no count of this run's."""
    from rodent_tpu_torch.parallel import mesh as pmesh
    from rodent_tpu_torch.traversal import packet
    res = []
    for call in calls:
        before = dict(packet.launches)
        (r,) = pmesh.run_calls([call], device)
        r["launches"] = {k: packet.launches[k] - v for k, v in before.items()}
        r["card"] = (torch.cuda.current_device()
                     if torch.cuda.is_initialized() else None)
        res.append(r)
    return res


def sharded_group(backend, world, device, scene, cam, prim, k1_hits, policy,
                  singles, size):
    """[17b] The sharded renderers and traversal on `world` spawned ranks
    of a `backend` group (device None: each rank's own card, cuda:rank):
    the persistent renderer at (n_px, n_sp) = (world/2, 2) and (world, 1)
    and the progressive at (world/2, 2), each after an untimed first call
    of its renderer, within 1e-5 of the single-device films `singles` =
    (progressive, persistent, their seconds), and traverse_sharded on the
    primaries `prim`, equal to single-device K1's `k1_hits` bit for bit.
    The scene goes to the ranks on the host and onto each rank's card
    before its timed calls. Returns the ranks' K1 launches and the steps
    per rank of each persistent shape."""
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.parallel import mesh as pmesh
    from rodent_tpu_torch.render import film as film_mod
    w, h, spp = size
    samples = w * h * spp
    single_p, single_q, s_p, s_q = singles
    card = common.card(torch.device(device or "cuda:0"))
    scene_h = pmesh.to_device(scene, "cpu")
    o, d, inv, inv_o, tmin, tmax = prim
    rays = {"org": torch.stack(o, -1).cpu(), "dir": torch.stack(d, -1).cpu(),
            "inv_dir": torch.stack(inv, -1).cpu(),
            "inv_org": torch.stack(inv_o, -1).cpu(), "tmin": tmin.cpu(),
            "tmax": tmax.cpu()}
    persistent = pmesh.render_iteration_persistent_sharded
    args = (scene_h, cam, film_mod.new_film(w, h, "cpu"), w, h, spp, 0)
    shapes = ((world // 2, 2), (world, 1))
    # each renderer's first call in a rank warms it up and is not timed
    progressive = (pmesh.render_iteration_sharded, shapes[0], args, {})
    calls = [(persistent, shapes[1], args, policy), progressive]
    calls += [(persistent, shape, args, dict(policy, return_steps=True))
              for shape in shapes]
    calls.append(progressive)
    calls.append((pmesh.traverse_sharded, shapes[1], (scene_h["bvh"], rays),
                  {"engine": "packet"}))
    t0 = time.perf_counter()
    ranks = pmesh.run_group(sharded_rank, world, backend, calls, device,
                            timeout=420)
    where = ("each on cuda:0" if device else
             "rank r on cuda:r, cards " + str([r[0]["card"] for r in ranks]))
    log(f"[17b] {world} {backend} ranks on {card}, {where}: the group ran "
        f"in {time.perf_counter() - t0:.1f} s with the spawn")
    want = [0] * world if device else list(range(world))
    cards = [r[-1]["card"] for r in ranks]
    check(cards == want, f"phase 17b: the ranks' current cards {cards}")
    launched = sum(r[i]["launches"]["bvh_traverse"] for r in ranks
                   for i in range(len(calls)))
    steps = {}
    for i, (fn, shape, _, _) in enumerate(calls[2:5], start=2):
        pers = fn is persistent
        what = (f"{backend} {'persistent' if pers else 'progressive'} "
                f"(n_px, n_sp) {shape}")
        films = [r[i]["out"][0] if pers else r[i]["out"] for r in ranks]
        for f in films[1:]:
            check(np.array_equal(f, films[0]),
                  f"phase 17b {what}: ranks return different films")
        k1 = [r[i]["launches"]["bvh_traverse"] for r in ranks]
        check(all(k > 0 for k in k1), f"phase 17b {what}: K1 launches {k1}")
        same, err = film_close(films[0], single_q if pers else single_p,
                               f"phase 17b {what}")
        secs = ranks[0][i]["seconds"]
        single_s = s_q if pers else s_p
        if pers:
            steps[shape] = ranks[0][i]["out"][1]
        log(f"[17b] {what}: film within 1e-5 of the single-device film "
            f"({same:.4%} of values bit for bit, max |diff| {err:.3g}); "
            f"{secs:.3f} s = {samples / secs / 1e6:.3f} Msamples/s against "
            f"the single device's {samples / single_s / 1e6:.3f}; K1 "
            f"launches per rank {k1}"
            + (f"; steps {steps[shape].tolist()}" if pers else ""))
    hits = ranks[0][-1]["out"]
    for key, v in k1_hits.items():
        check(np.array_equal(hits[key], v.cpu().numpy()),
              f"phase 17b traverse_sharded: {key} differs from K1's")
    log(f"[17b] {backend} traverse_sharded over {world} ranks, engine "
        f"packet (K1), {tmin.shape[0]} sorted hall primaries: every hit "
        f"equal to single-device K1 bit for bit; "
        f"{ranks[0][-1]['seconds']:.3f} s, the scene and rays already on "
        f"the card, with the gather")
    return launched, steps


def phase_sharded(device, scene, prim):
    """[17a-c] The sharded renderers and traversal (rodent_tpu_torch.
    parallel) on hall-260K at 1920x1088, spp 4, max path length 20: (a) a
    one-rank NCCL group in this process, the persistent renderer under
    select_render_policy and the progressive one, each against its
    single-device film; (b) a 4-rank gloo group spawned on this one card
    (every rank's tensors on cuda:0, K1 in each rank; sharded_group);
    (c) measure_shard_steps at (4, 1) and (2, 2) against the steps the
    sharded ranks report. Returns the K1 launches of the renderers in (a),
    (b) and (c), all ranks."""
    import torch.distributed as dist
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.parallel import mesh as pmesh
    from rodent_tpu_torch.parallel.accounting import (measure_shard_steps,
                                                      shard_plan)
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.compiler import select_render_policy
    from rodent_tpu_torch.traversal import packet
    from rodent_tpu_torch.traversal.packet import traverse_packet_components
    w, h, spp = 1920, 1088, 4
    cam = Camera.make(*HALL_VIEW, w, h)
    policy = select_render_policy(scene.device)
    card = common.card(device)
    samples = w * h * spp
    k1_hits = traverse_packet_components(scene.device["bvh"], *prim)
    packet.reset_launches()
    singles, timed_call = single_films(device, scene.device, cam, policy,
                                       (w, h, spp))
    single_p, single_q, s_p, s_q = singles

    # (a) the same calls on a one-rank mesh, after the single-device ones
    check(pmesh.init_group(), "phase 17: a process group was already up")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"phase 17a: group {dist.get_backend()} of "
              f"{dist.get_world_size()}")
        m = pmesh.make_mesh(device=device)
        (one_q, one_steps), s_oq = timed_call(
            lambda: pmesh.render_iteration_persistent_sharded(
                scene.device, cam, new_film(w, h, device), w, h, spp, 0, m,
                return_steps=True, **policy))
        one_p, s_op = timed_call(lambda: pmesh.render_iteration_sharded(
            scene.device, cam, new_film(w, h, device), w, h, spp, 0, m))
    finally:
        dist.destroy_process_group()
    check(torch.equal(one_q, single_q) and torch.equal(one_p, single_p),
          "phase 17a: a one-rank sharded film differs from the "
          "single-device film")
    log(f"[17a] one-rank NCCL group on {card}: hall-260K {w}x{h} spp {spp}"
        f" mpl 20, films bit for bit equal to the single-device films; "
        f"persistent under the policy {policy}: sharded {s_oq:.3f} s = "
        f"{samples / s_oq / 1e6:.3f} Msamples/s ({int(one_steps.sum())} "
        f"steps), single {s_q:.3f} s = {samples / s_q / 1e6:.3f}; "
        f"progressive: sharded {s_op:.3f} s = {samples / s_op / 1e6:.3f}, "
        f"single {s_p:.3f} s = {samples / s_p / 1e6:.3f} (host clock, "
        f"synchronised, after a first call of each)")

    # (b) four gloo ranks on the one card: the cost of the decomposition on
    # one card, not scaling across cards
    launched, steps = sharded_group("gloo", 4, str(device), scene.device,
                                    cam, prim, k1_hits, policy, singles,
                                    (w, h, spp))

    # (c) shard accounting, each shard's call in turn in this process
    for n_px, n_sp in ((4, 1), (2, 2)):
        st, secs = timed_call(lambda: measure_shard_steps(
            scene.device, cam, w, h, spp, n_px, n_sp,
            pool=policy.get("pool"), packet=policy.get("packet", True),
            sort=policy.get("sort", False),
            retire_every=policy.get("retire_every", 1)))
        check(np.array_equal(st, steps[(n_px, n_sp)]),
              f"phase 17c: measured steps {st.tolist()} against the "
              f"sharded run's {steps[(n_px, n_sp)].tolist()}")
        plan = shard_plan(w, h, spp, n_px, n_sp)
        log(f"[17c] measure_shard_steps (n_px, n_sp) ({n_px}, {n_sp}): "
            f"steps {st.tolist()} (equal to the sharded ranks'), max/mean "
            f"{st.max() / st.mean():.4f}; {plan['pixels_local']} pixels "
            f"and {plan['samples_local']} samples per rank, "
            f"{plan['padded_pixels']} padded, all-reduce "
            f"{plan['collective_bytes_per_device']} bytes per rank; "
            f"{secs:.1f} s")
    parent = packet.launches["bvh_traverse"]
    check(packet.launches["bvh_traverse_prefetch"] == 0,
          f"phase 17: K2 launched on hall ({packet.launches})")
    log(f"[17] K1 launches of the sharded phase: {parent} in this process "
        f"(a, c), {launched} in the 4 ranks (b)")
    return parent + launched


def new_film(w, h, device):
    from rodent_tpu_torch.render import film as film_mod
    return film_mod.new_film(w, h, device)


def single_films(device, scene, cam, policy, size):
    """[17] The single-device films of both renderers on `scene` and their
    seconds: each renderer runs once untimed (a process's first persistent
    iteration runs 2-3x slower than the next), then once timed; the films
    must agree. Returns ((progressive, persistent, seconds of each), the
    timer)."""
    from rodent_tpu_torch.render.integrator import (
        render_iteration, render_iteration_persistent)
    w, h, spp = size

    def timed_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def single(persistent):
        if persistent:
            return render_iteration_persistent(
                scene, cam, new_film(w, h, device), w, h, spp, 0, **policy)
        return render_iteration(scene, cam, new_film(w, h, device), w, h,
                                spp, 0)

    first_p, first_q = single(False), single(True)
    single_q, s_q = timed_call(lambda: single(True))
    single_p, s_p = timed_call(lambda: single(False))
    check(torch.equal(first_q, single_q) and torch.equal(first_p, single_p),
          "phase 17: a single-device film differs between two calls")
    return (single_p, single_q, s_p, s_q), timed_call


def phase_bench_tools(device, verts, idx):
    """[17d, 17e] tools.bench_ref, the independent engine, on hall-260K's
    1,048,576 primary rays (one host thread) against K1 on the same rays
    and a BVH8/Tri8 build of the same mesh; then tools.bench_shading in its
    three modes and tools.bench_interface in its two at their default 1M
    count on the card."""
    from rodent_tpu_torch.accel import build_bvh
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.tools import bench_interface, bench_ref
    from rodent_tpu_torch.tools import bench_shading
    from rodent_tpu_torch.traversal import api
    from rodent_tpu_torch.traversal.packet import traverse_packet
    card = common.card(device)
    res, text = run_tool(bench_ref.run, [
        "--scene", "hall", "--tris", 260_000, "--width", 1024, "--height",
        1024, "--bench", 1])
    check(res is not None, "bench_ref: the native library is unavailable")
    org, dirs, tmin, tmax = res["rays"]
    n = len(org)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, **common.TRI8),
                            device)
    rays = api.make_rays(org, dirs, tmin, tmax, device=device)
    k = traverse_packet(dev, rays)
    kt, kp = k["t"].cpu().numpy(), k["prim_id"].cpu().numpy()
    rt, rp = res["t"], res["prim_id"]
    # the independent engine has its own intersection arithmetic: where
    # the ids differ, a tie is a t within 2e-5 of K1's. Every other
    # difference (a ray through a crack between triangles that one
    # engine's test takes and the other's does not) is held against a
    # brute force over K1's whole Tri table, which K1 must match, so that
    # only the reference engine can be at fault; at most EDGE_RAYS of them
    close = np.abs(rt - kt) <= 2e-5 + 2e-5 * np.abs(kt)
    diff = rp != kp
    ties = int((diff & close).sum())
    edge = np.nonzero(diff & ~close)[0]
    check(ties < TIE_LIMIT * n, f"bench_ref: {ties} ties with K1")
    check(len(edge) <= EDGE_RAYS,
          f"bench_ref: {len(edge)} rays differ from K1 and are no ties")
    check(bool(close[~diff].all()), "bench_ref: t outside 2e-5 of K1's")
    comps = api.components(rays)
    listed = []
    for i in edge.tolist():
        bt, bp = brute_force(dev, comps, i)
        hit = bool(kp[i] >= 0)
        check(hit == bool(np.isfinite(bt)) and (
            not hit or abs(float(kt[i]) - bt) <= 1e-6 * abs(bt)),
              f"bench_ref: ray {i}: K1 prim {kp[i]} at t {kt[i]!r}, the "
              f"brute force prim {bp} at t {bt!r}")
        listed.append(f"{i}: ref {rp[i]}/{rt[i]:.6g}, K1 {kp[i]}/"
                      f"{kt[i]:.6g}, brute force "
                      + (f"{bp}/{bt:.6g}" if hit else "miss"))
    log(f"[17d] bench_ref (native/ref_bvh.cpp: its own BVH2, one host CPU "
        f"thread, not the card) on {n} hall-260K primaries: "
        f"{n / (res['ms'][0] * 1e3):.3f} Mrays/s on the host; against K1: "
        f"prim_id equal on all but {int(diff.sum())} rays: {ties} ties (t "
        f"within 2e-5) and {len(edge)} rays through a crack, where K1 "
        f"equals the brute force (ray: prim/t) " + "; ".join(listed)
        + f"; {int((kp >= 0).sum())} K1 hits, {int((rp >= 0).sum())} ref")
    rates = {}
    for name, tool, modes in (("shading", bench_shading,
                               ((), ("--sorted",), ("--mono",))),
                              ("interface", bench_interface,
                               ((), ("--opaque",)))):
        for mode in modes:
            code, text = run_tool(tool.main, list(mode))
            lines = text.strip().splitlines()
            check(code == 0 and "checksum" in lines[0],
                  f"bench_{name} {mode}: {text!r}")
            rates[f"{name} {' '.join(mode) or 'default'}"] = float(
                lines[-1].split()[0])
    log(f"[17e] on {card}: bench_shading / bench_interface at 1,048,576 "
        f"rays/lookups, CUDA events: {json.dumps(rates)} "
        f"(Mrays/s, Mlookups/s)")
    return rates


# the keys of the bench's JSON line and of its detail without a reference
# directory (bench.py:261-267, its primary rows renamed for K1)
BENCH_DETAIL = {
    "backend", "card", "baseline", "num_nodes", "num_packets",
    "primary_pk8_k1_mrays", "primary_pk16_k1_mrays", "primary_pk8_ct_mrays",
    "primary_pk16_ct_mrays", "primary_config",
    "primary_mrays", "primary_band", "primary_hit_fraction",
    "bigscene_transport", "bigscene_tris", "bigscene_mrays",
    "bigscene_band", "cornell"} | {
    f"{kind}_{key}" for kind in ("ao", "bounces")
    for key in ("packet_mrays", "packet_band", "tiled-c_mrays",
                "tiled-c_band", "mrays", "engine")}


def phase_tools(device, verts, idx):
    """[18] the bench and the measuring tools (ROADMAP A1-A6) through their
    main() on the card, each at the size its users run it (bigscene_12m
    on primaries only); their rows are logged. Returns the K1, K2 and K3
    launches they made."""
    from rodent_tpu_torch import bench
    from rodent_tpu_torch.accel import build_bvh
    from rodent_tpu_torch.experiments import (
        ab_render_policy, bigscene_12m, common, profile_renderer,
        race_hall_packet, shard_scaling_table, sweep_bigscene_leaf)
    from rodent_tpu_torch.tools import benchmark
    from rodent_tpu_torch.traversal import api, packet
    times = {}

    def run(name, main, argv):
        t0 = time.perf_counter()
        code, text = run_tool(main, argv)
        check(code == 0, f"phase 18: {name} returned {code}")
        times[name] = round(time.perf_counter() - t0, 1)
        return text

    packet.reset_launches()
    text = run("bench", bench.main, [
        "--reference", os.path.join(REPO, "build", "phase18", "absent")])
    out = text.strip().splitlines()
    check(len(out) == 1, f"bench printed {len(out)} lines")
    res = json.loads(out[0])
    detail = res["detail"]
    check(set(res) == {"metric", "value", "unit", "vs_baseline", "detail"}
          and res["metric"] == "hall260k_primary_traversal"
          and set(detail) == BENCH_DETAIL
          and detail["backend"] == "cuda"
          and detail["bigscene_tris"] == 4_347_968,
          f"bench: the JSON line's keys {sorted(detail)}")
    run("ab_render_policy powerplant", ab_render_policy.main, [
        "--scene", "powerplant", "--tris", 5_000_000, "--wh", "1920x1088",
        "--spp", 1, "--iters", 1, "--policies", "all-packet", "--packet",
        "hbm", "--pools", "32768,524288"])
    run("ab_render_policy hall", ab_render_policy.main, [
        "--wh", "1920x1088", "--spp", 1, "--iters", 1, "--policies",
        "all-packet", "--pools", "65536,524288"])
    run("ab_render_policy engines", ab_render_policy.main, [
        "--wh", "160x90", "--spp", 1, "--iters", 1, "--policies",
        "all-packet,all-tiled"])
    run("profile_renderer", profile_renderer.main, [
        "--spp", 1, "--iters", 1])
    run("race_hall_packet", race_hall_packet.main, [
        "--packets", "8,12,24", "--lcs", "0,0.6"])
    # hall's primaries through every packet variant of the tool: the
    # carry-top body in each (K7, K7-PF in hbm, K7), no K2
    before = dict(packet.launches)
    text = run("benchmark hall primary", benchmark.main, [
        "--scenes", "hall", "--dists", "primary", "--variants",
        "packet,hbm,hbm-nopf", "--iters", 3])
    made = {k: packet.launches[k] - before[k] for k in before}
    rows = [line for line in text.splitlines() if " Mrays (" in line]
    check(len(rows) == 3 and len({r.rsplit("; ", 1)[1] for r in rows}) == 1,
          f"benchmark: rows {rows}")
    check(made["bvh_traverse_ct_prefetch"] > 0 and made["bvh_traverse_ct"] > 0
          and made["bvh_traverse_prefetch"] == 0,
          f"benchmark on hall's primaries: launches {made}")
    log(f"[18] tools.benchmark on hall's primaries: {' | '.join(rows)}; "
        f"launches {json.dumps(made)}")
    run("sweep_bigscene_leaf", sweep_bigscene_leaf.main, [
        "--packets", 24, "--lts", 12, "--lcs", "0.45,0.6"])
    run("bigscene_12m", bigscene_12m.main, ["--dists", "primary"])
    run("shard_scaling_table", shard_scaling_table.main, [])
    launched = {k: packet.launches[k] for k in (
        "bvh_traverse", "bvh_traverse_prefetch", "bvh_traverse_count",
        "bvh_traverse_ct", "bvh_traverse_ct_prefetch")}
    check(all(launched.values()), f"phase 18: launches {launched}")
    # the hit fraction against K1's on the bench's rays and winning build
    name = detail["primary_config"].split("-")[0]
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8,
                                      **bench.BUILDS[name]), device)
    comps = common.distributions("hall", verts, idx, dev, 1024, device,
                                 ("primary",))["primary"][0]
    hit = packet.traverse_packet_components(dev, *comps)
    frac = round(float((hit["prim_id"] >= 0).double().mean()), 4)
    check(detail["primary_hit_fraction"] == frac,
          f"bench: primary_hit_fraction {detail['primary_hit_fraction']} "
          f"against K1's {frac}")
    log(f"[18] bench and tools on {common.card(device)}: seconds "
        f"{json.dumps(times)}; K1-K3, K7 and K7-PF launches "
        f"{json.dumps(launched)}; the bench's hit fraction {frac} "
        f"({detail['primary_config']}) equals K1's on its rays and {name} "
        "build")
    return launched


def phase_programs(device):
    """[19] The last measuring programs (rodent_tpu_torch.experiments),
    each through its run() as its main() drives it: sass_audit on every
    instantiation it names (its -lineinfo copies built in phase 2; the
    copy's SASS equal to the library's opcode for opcode, each
    instantiation's histogram, registers, local bytes, spills and issue
    estimate beside its measured ns per pop); attribute_crown,
    ab_crown_build (one build variant), probe_crown_sort (one order and
    tile_rows) and measure_sorts (one key and tile_rows on hall's bounce
    rays) at the JAX scene sizes; waterfall_tiled, measure_tiled_iters,
    sweep_arity_tiled and probe_sb_depth on hall-260K's ao rays at one
    configuration each (the waterfall's full and noleaf rows); bigscene_demo
    --card on a 400K-triangle powerplant
    and --mesh over 2 gloo ranks on the card, bit for bit; make_goldens on
    hall (3 iterations) under the golden gate. K1-K6's launches are read
    around it. Returns (the results for the log, the launches)."""
    from rodent_tpu_torch.experiments import (ab_crown_build,
                                              attribute_crown, bigscene_demo,
                                              make_goldens,
                                              measure_sorts,
                                              measure_tiled_iters,
                                              probe_crown_sort,
                                              probe_sb_depth, sass_audit,
                                              sweep_arity_tiled,
                                              waterfall_tiled)
    from rodent_tpu_torch.traversal import packet
    out, times = {}, {}
    packet.reset_launches()

    def step(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        log(f"[19] {name}: {times[name]:.1f} s")

    step("sass_audit", lambda: sass_audit.run(device, blocks=3))
    for label, *_ in sass_audit.INSTANCES:
        r = out["sass_audit"][label]
        st, est = r["static"], r["estimate"]
        check(st["regs"] is not None and st["spills"] is not None
              and st["audit"]["count"].get("node", 0) > 0
              and st["audit"]["count"].get("leaf", 0) > 0,
              f"sass_audit {label}: incomplete ({st['regs']} registers, "
              f"{st['spills']} spills, {st['audit']['count']})")
        check(0.0 < est["share"] < 10.0 and est["ns_pop"] > 0,
              f"sass_audit {label}: issue estimate {est}")
        if label.startswith("K7 "):
            # the while-while form: a node loop, and a leaf loop apart
            # from the lane loop it holds
            loops = st["audit"]["loops"]
            check(loops.get("node", 0) >= 1 and loops.get("leaf", 0) >= 2,
                  f"sass_audit {label}: the node and leaf loops are not "
                  f"two loops in the SASS ({loops})")
    step("attribute_crown", lambda: attribute_crown.run(
        device, ("hall", "crown"), rows=16, blocks=3))
    step("ab_crown_build", lambda: ab_crown_build.run(
        device, "crown", ["q0-lt12-lc0.6"], rows=16, blocks=3))
    step("probe_crown_sort", lambda: probe_crown_sort.run(
        device, rows=(16,), orders=("hit-prim",), blocks=3))
    step("measure_sorts", lambda: measure_sorts.run(
        device, "bounces", rows=(16,), keys=("org9+oct+dir",), blocks=3))
    step("waterfall_tiled", lambda: waterfall_tiled.run(
        device, ("ao",), rows=("full", "noleaf"), candidates=(), blocks=2))
    step("measure_tiled_iters", lambda: measure_tiled_iters.run(
        device, ("ao",), blocks=1))
    step("sweep_arity_tiled", lambda: sweep_arity_tiled.run(
        device, ((4, 4),), blocks=1, kinds=("ao",)))
    step("probe_sb_depth", lambda: probe_sb_depth.run(
        device, (16,), ("ao",), blocks=1))
    step("bigscene_demo --card", lambda: bigscene_demo.run_card(
        device, 400_000, 1024, blocks=3))
    step("bigscene_demo --mesh", lambda: bigscene_demo.run_mesh(
        device, 2, 100_000, 512))
    goldens = os.path.join(REPO, "build", "phase19", "goldens")
    step("make_goldens", lambda: make_goldens.run(device, ("hall",), 3,
                                                  goldens))
    torch.cuda.synchronize()
    launched = dict(packet.launches)
    for kernel in ("bvh_traverse", "bvh_traverse_prefetch",
                   "bvh_traverse_count", "bvh_traverse_tile",
                   "bvh_traverse_pair", "bvh_traverse_ct"):
        check(launched[kernel] > 0, f"phase 19: {kernel} never launched")
    crown = out["attribute_crown"]
    for scene, r in crown.items():
        check(r["k3"]["pops"] > 0 and r["k5"]["pops"] > 0
              and r["k1_ms"] > 0 and r["k5_ms"] > 0,
              f"attribute_crown {scene}: {r}")
    g = out["make_goldens"]["hall"]
    wf = out["waterfall_tiled"]["ao"]
    summary = {
        "seconds": times,
        "sass_audit": {label: {
            "regs": r["static"]["regs"], "stack": r["static"]["stack"],
            "spills": r["static"]["spills"],
            "count": r["static"]["audit"]["count"],
            "per_pop": r["estimate"]["per_pop"],
            "ms": r["measured"]["ms"], "pops": r["measured"]["pops"],
            "ns_pop": r["estimate"]["ns_pop"],
            "issue_ms": r["estimate"]["issue_ms"],
            "issue_ns_pop": r["estimate"]["issue_ns_pop"],
            "share": r["estimate"]["share"],
            "loops": r["static"]["audit"]["loops"],
            "rules": r["estimate"].get("rules")}
            for label, r in out["sass_audit"].items()},
        "attribute_crown": {s: {
            "pops_ray": r["k3"]["pops_ray"], "warp_pops": r["k3"]["warp_pops"],
            "tile_pops": r["k5"]["mean"], "k1_ms": r["k1_ms"],
            "k5_ms": r["k5_ms"], "k1_ns_pop": r["k1_ns_pop"],
            "k5_ns_pop": r["k5_ns_pop"], "depth": r["stats"]["max_depth"]}
            for s, r in crown.items()},
        "ab_crown_build": {k: {"tile_pops": r["k5"]["mean"],
                               "k1_mrays": r["k1_mrays"],
                               "k5_mrays": r["k5_mrays"]}
                           for k, r in out["ab_crown_build"].items()},
        "probe_crown_sort": {f"{k[0]} rows {k[1]}": {
            "tile_pops": r["k5"]["mean"], "k5_mrays": r["k5_mrays"],
            "k1_mrays": r["k1_mrays"]}
            for k, r in out["probe_crown_sort"].items()},
        "measure_sorts": {f"{k[0]} rows {k[1]}": {
            "tile_pops": r["k5"]["mean"], "mrays": r["mrays"]}
            for k, r in out["measure_sorts"].items()},
        "waterfall_tiled": {"prod_ms": wf["prod_ms"], "trips": wf["trips"],
                            "util": wf["util"], "idle": wf["idle"]["idle"],
                            "rows": wf["rows"]},
        "measure_tiled_iters": {k: {kk: (v["idle"]["idle"] if kk == "idle"
                                         else v[kk]) for kk in v}
                                for k, v in
                                out["measure_tiled_iters"].items()},
        "golden_hall": {"mse_short": g["gate_short"][0],
                        "mse_long": g["gate_long"][0],
                        "gate": g["gate_short"][1]},
        "launches": launched}
    log(f"[19] programs {json.dumps(summary, default=str)}")
    return summary, launched


def phase_ct(device, hall, big_bvh, big_prim, side=1024):
    """[20] K7, the carry-top body (csrc/bvh_ct.cu, the "ct" library):
    every variant held bit for bit against its plain version (hits,
    counters and the rows it reads) on hall-260K's 1M sorted primaries,
    bounce rays (closest-hit: fold and sort, fused and unfused slab), ao
    rays (any-hit: fused and unfused) and the primaries and bounces
    interleaved ray by ray (2M rays in one launch, so that nearly every
    warp's rays take K7's node and leaf loops in turns), and on
    powerplant-4.3M's 1M sorted primaries (Tri24); sort with the unfused
    slab also against K1's hits and K3's counters, bit for bit. On hall,
    K7-PF (the instantiations tools.benchmark's hbm row launches in phase
    18: Tri8, hall's stack cap) is held against each variant's plain
    version and K7 in hits, bit for bit. Each variant is then timed in
    turns with K1 (experiments.measure_ct.measure: K1, K7, K7, K1; not on
    the interleaved rays) beside its pops per ray from its counting
    instantiation, its bound and the rays where it keeps another hit than
    K1. Returns the kernels-line entry's numbers: {"res": {(scene, kind,
    variant): measure's result}, "plain_ms": the plain version's time on
    hall's primaries (ct-fold)}."""
    from rodent_tpu_torch.experiments import common, measure_ct
    from rodent_tpu_torch.traversal import api, packet
    hall_bvh = hall.device["bvh"]
    hall_d = common.distributions(
        "hall", hall.mesh.vertices, hall.mesh.indices, hall_bvh, side,
        device, ("primary", "ao", "bounces", "interleaved"))
    runs = [("hall-260K", hall_bvh, kind, hall_d[kind])
            for kind in ("primary", "bounces", "ao", "interleaved")]
    runs.append(("powerplant-4.3M", big_bvh, "primary", (big_prim, False)))
    res, plain_ms, first = {}, None, True
    for scene, bvh, kind, (comps, any_hit) in runs:
        what = f"{scene} {kind}"
        bodies = (measure_ct.ANY_HIT_VARIANTS if any_hit
                  else measure_ct.VARIANTS)
        rows = {}
        for name, body in bodies.items():
            p = common.ct_plain(bvh, comps, any_hit, **body)
            rows[name] = (int(p["nodes_read"].sum()),
                          int(p["tris_read"].sum()))
            del p["nodes_read"], p["tris_read"]
            k = measure_ct.call(bvh, comps, body, any_hit)
            kc = measure_ct.call(bvh, comps, body, any_hit, True)
            check_equal(kc, p, f"[20] {what} K7 {name} with counters")
            del p["pops"], p["leaf_pops"]
            check_equal(k, p, f"[20] {what} K7 {name}")
            if scene == "hall-260K":
                # K7-PF as tools.benchmark's hbm row runs it (phase 18):
                # hall's Tri8 build and stack cap
                kp = measure_ct.call(bvh, comps, dict(body, prefetch=True),
                                     any_hit)
                check_equal(kp, p, f"[20] {what} K7-PF {name}")
                check_equal(kp, k, f"[20] {what} K7-PF {name} against K7")
            if name == "ct-sort-nofma":
                k1 = packet.traverse_packet_components(bvh, *comps)
                k3 = packet.traverse_packet_components(bvh, *comps,
                                                       count_pops=True)
                check_equal(k, k1, f"[20] {what} K7 {name} against K1")
                check_equal(kc, k3, f"[20] {what} K7 {name} against K3")
            if scene == "hall-260K" and kind == "primary" and \
                    name == "ct-fold":
                plain_ms, _ = common.timed(
                    lambda body=body: api.traverse_ct_components(
                        bvh, comps[0], comps[1], comps[2], comps[4],
                        comps[5], any_hit, **body), device, blocks=1)
        log(f"[20] {what}: K7 {', '.join(bodies)} == the plain version bit "
            f"for bit (hits, pops, leaf pops, rows read)"
            + ("; K7-PF == the plain version and K7 bit for bit in hits"
               if scene == "hall-260K" else "")
            + ("" if any_hit else "; ct-sort-nofma == K1's hits and K3's "
               "counters bit for bit"))
        if kind == "interleaved":
            continue
        out = measure_ct.measure(bvh, comps, device, bodies, any_hit,
                                 warmup_s=common.WARMUP_S if first else 0.0,
                                 rows=rows)
        first = False
        for name, r in out.items():
            res[(scene, kind, name)] = r
            log(f"[20] {what} {measure_ct.report(name, r)}")
    log(f"[20] hall primary ct-fold's plain version: {plain_ms:.1f} ms")
    return {"res": res, "plain_ms": plain_ms}


def phase_pf(device, bvh, dists, regs):
    """[20] K7-PF, the carry-top body with the exact next-pop L2 prefetch,
    on powerplant-4.3M's 1M sorted primaries, bounce and ao rays (Tri24,
    phase 8's dists): every variant of measure_ct.VARIANTS (closest-hit) and
    ANY_HIT_VARIANTS bit for bit against its plain version (K7's) and
    against K7 in hits; then each timed in turns with K7 and in turns with
    K2 (measure_ct.measure_pf) beside its pops per ray, its bound (K7's own
    pops and rows) and the registers of its instantiation and K7's (regs:
    phase_build's map). Returns
    {"res": {(kind, variant): measure_pf's result with "registers"},
    "plain_ms": the plain version's time on the primaries (ct-fold)}."""
    from rodent_tpu_torch.experiments import common, measure_ct
    from rodent_tpu_torch.traversal import api, packet
    cap = packet.stack_cap(bvh)
    m = bvh["tris"].shape[1] // 14
    res, plain_ms = {}, None
    for i, kind in enumerate(measure_ct.PF_DISTS):
        comps, any_hit = dists[kind]
        what = f"powerplant-4.3M {kind}"
        bodies = (measure_ct.ANY_HIT_VARIANTS if any_hit
                  else measure_ct.VARIANTS)
        rows = {}
        for name, body in bodies.items():
            p = common.ct_plain(bvh, comps, any_hit, **body)
            rows[name] = (int(p["nodes_read"].sum()),
                          int(p["tris_read"].sum()))
            for key in ("nodes_read", "tris_read", "pops", "leaf_pops"):
                del p[key]
            kp = measure_ct.call(bvh, comps, dict(body, prefetch=True),
                                 any_hit)
            k = measure_ct.call(bvh, comps, body, any_hit)
            check_equal(kp, p, f"[20] {what} K7-PF {name}")
            check_equal(kp, k, f"[20] {what} K7-PF {name} against K7")
            if kind == "primary" and name == "ct-fold":
                plain_ms, _ = common.timed(
                    lambda body=body: api.traverse_ct_components(
                        bvh, comps[0], comps[1], comps[2], comps[4],
                        comps[5], any_hit, **body), device, blocks=1)
        log(f"[20] {what}: K7-PF {', '.join(bodies)} == the plain version "
            f"and K7 bit for bit in hits")
        out = measure_ct.measure_pf(
            bvh, comps, device, bodies, any_hit,
            warmup_s=common.WARMUP_S if i == 0 else 0.0, rows=rows)
        for name, r in out.items():
            body = bodies[name]
            targs = (int(any_hit), 8, m, cap,
                     int(body["select"] == "sort" and not any_hit),
                     int(body["fma_slab"]), 0)
            r["registers"] = {"K7-PF": regs.get(targs + (1,)),
                              "K7": regs.get(targs + (0,))}
            res[(kind, name)] = r
            log(f"[20] {what} {measure_ct.report_pf(name, r)}; registers "
                f"{r['registers']['K7-PF']} (K7 {r['registers']['K7']})")
    log(f"[20] powerplant primary ct-fold's plain version: {plain_ms:.1f} "
        f"ms")
    return {"res": res, "plain_ms": plain_ms}


def phase_tri12(device, hall, side=1024):
    """[20] Tri12 leaves on hall-260K: a pk12 build (leaf_threshold 12, as
    race_hall_packet's), its 1M sorted primaries and ao rays. K1 against
    the plain version (prim_id equal but exact-t ties, t/u/v within atol
    1e-5 / rtol 1e-6; any-hit hit/miss equal), K2 equal to K1, K3's hits
    and counters, K7's fold and sort (with the fused slab; with and
    without counters) and K7-PF's bit for bit against their plain
    versions; then K1
    and K7's fold timed in turns (measure_ct.measure) on the primaries.
    Returns the kernels line's variants: {"K1": {...}, "K7": {...}}."""
    from rodent_tpu_torch.accel import build_bvh
    from rodent_tpu_torch.experiments import common, measure_ct
    from rodent_tpu_torch.traversal import api, packet
    t0 = time.perf_counter()
    verts, idx = hall.mesh.vertices, hall.mesh.indices
    bvh = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=12,
                                      leaf_threshold=12), device)
    check(bvh["tris"].shape[1] == 14 * 12, "the pk12 build's rows")
    dists = common.distributions("hall", verts, idx, bvh, side, device,
                                 ("primary", "ao"))
    for kind, (comps, any_hit) in dists.items():
        what = f"hall-260K pk12 {kind}"
        n = comps[4].shape[0]
        o, d, inv, _, tmin, tmax = comps
        plain = api.traverse_components(bvh, o, d, inv, tmin, tmax,
                                        any_hit=any_hit, count_pops=True)
        k1 = packet.traverse_packet_components(bvh, *comps, any_hit=any_hit)
        k2 = packet.traverse_packet_components(bvh, *comps, any_hit=any_hit,
                                               prefetch=True)
        k3 = packet.traverse_packet_components(bvh, *comps, any_hit=any_hit,
                                               count_pops=True)
        check_equal(k2, k1, f"[20] {what} K2 against K1")
        check_equal(k3, plain, f"[20] {what} K3")
        if any_hit:
            check(bool(torch.equal(k1["prim_id"] >= 0,
                                   plain["prim_id"] >= 0)),
                  f"[20] {what}: K1 hit/miss differs")
            ties = 0
        else:
            ties, _ = compare_hits(k1, plain, f"[20] {what} K1")
            check(ties < TIE_LIMIT * n, f"[20] {what}: {ties} ties")
        bodies = (measure_ct.ANY_HIT_VARIANTS if any_hit else
                  {k: measure_ct.VARIANTS[k] for k in ("ct-fold",
                                                       "ct-sort")})
        for name, body in bodies.items():
            p = api.traverse_components(bvh, o, d, inv, tmin, tmax,
                                        any_hit=any_hit, count_pops=True,
                                        carry_top=True, **body)
            kc = measure_ct.call(bvh, comps, body, any_hit, True)
            k = measure_ct.call(bvh, comps, body, any_hit)
            kp = measure_ct.call(bvh, comps, dict(body, prefetch=True),
                                 any_hit)
            check_equal(kc, p, f"[20] {what} K7 {name} with counters")
            del p["pops"], p["leaf_pops"]
            check_equal(k, p, f"[20] {what} K7 {name}")
            check_equal(kp, p, f"[20] {what} K7-PF {name}")
        log(f"[20] {what}: {n} rays; K2 == K1, K3 (hits, counters), K7 and "
            f"K7-PF {', '.join(bodies)} == plain bit for bit; K1 against "
            f"plain {ties} exact-t ties, pops/ray "
            f"{float(plain['pops'].double().mean()):.4f}")
    comps, _ = dists["primary"]
    r = measure_ct.measure(bvh, comps, device,
                           {"ct-fold": measure_ct.VARIANTS["ct-fold"]})
    r = r["ct-fold"]
    log(f"[20] hall-260K pk12 primary {measure_ct.report('ct-fold', r)}; "
        f"the Tri12 runs took {time.perf_counter() - t0:.1f} s")
    return {"K1": {"ms": r["k1_ms"], "rows": bvh["tris"].shape[0]},
            "K7": {"ms": r["ms"], "k1_ms": r["k1_ms"], "ratio": r["ratio"],
                   "pops_ray": r["stats"]["pops_ray"],
                   "leaf_ray": r["stats"]["leaf_ray"],
                   "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                   "share": r["share"], "k1_differences": r["differences"]}}


def phase_cornell(device, w=1080, h=720, spp=4, mpl=64):
    """[21] The cornell programs through their run() on the stand-in (the
    open box of experiments.common, the dense tier) at the reference's
    camera: ab_cornell_engine's eight variants, one untimed and one timed
    iteration each, whose films must be equal bit for bit, the packet
    variants launching K1 and dense and tiled no kernel; then measure_splat
    at 3 iterations. Returns (K1's launches, the rows for the log)."""
    from rodent_tpu_torch.experiments import ab_cornell_engine as ace
    from rodent_tpu_torch.experiments import measure_splat
    from rodent_tpu_torch.render.compiler import packet_mode
    from rodent_tpu_torch.traversal import packet
    t0 = time.perf_counter()
    scene, _, size, line = ace.load_scene(None, device, mpl, (w, h))
    check(packet_mode(scene.device) == "dense"
          and scene.mesh.num_tris == 12,
          f"cornell stand-in: {scene.mesh.num_tris} triangles, tier "
          f"{packet_mode(scene.device)}")
    policy, policy_name = ace.policy_variant(scene)
    log(f"[21] {line}; {w}x{h} spp {spp} mpl {mpl}; select_render_policy "
        f"{policy} = {policy_name}")
    packet.reset_launches()
    rows, film = ace.run(device, scene, size, spp, 2,
                         out=lambda m: log(f"[21] {m}"))
    k1_rows = packet.launches["bvh_traverse"]
    splat = measure_splat.run(device, scene, None, size, spp, 3,
                              out=lambda m: log(f"[21] measure_splat: {m}"))
    torch.cuda.synchronize()
    launched = dict(packet.launches)
    splat_k1 = launched["bvh_traverse"] - k1_rows
    check(len(rows) == len(ace.VARIANTS) and policy_name in ace.VARIANTS,
          f"cornell: rows {[r['name'] for r in rows]}, policy {policy}")
    check(film.shape == (w * h, 3) and bool(torch.isfinite(film).all())
          and float(film.min()) >= 0.0 and float(film.mean()) > 0.0,
          "cornell: the film is not finite, negative or black")
    check(bool(torch.isfinite(splat["film"]).all()) and splat["mean"] > 1.0,
          f"cornell: measure_splat's film is not finite or its image is "
          f"black (mean {splat['mean']:.2f})")
    for r in rows:
        k1 = r["launches"]["bvh_traverse"]
        others = {k: v for k, v in r["launches"].items()
                  if k != "bvh_traverse" and v}
        engine = r["kw"]["packet"]
        check(not others and (k1 > 0 if engine is True else k1 == 0),
              f"cornell {r['name']} (packet={engine!r}): launches "
              f"{r['launches']}")
    check(k1_rows == sum(r["launches"]["bvh_traverse"] for r in rows)
          and splat["packet"] is True and splat_k1 > 0,
          f"cornell: K1 launches {launched}, measure_splat's {splat_k1} "
          f"(packet={splat['packet']})")
    log(f"[21] the cornell phase took {time.perf_counter() - t0:.1f} s, K1 "
        f"launches {launched['bvh_traverse']}")
    return launched["bvh_traverse"], {
        "rows": {r["name"]: {k: r[k] for k in ("ms", "msamples", "steps")}
                 | {"k1_launches": r["launches"]["bvh_traverse"]}
                 for r in rows},
        "measure_splat": {k: splat[k] for k in ("ms", "msamples", "mean")}
        | {"k1_launches": splat_k1}}


def pf_entry(pf, launched):
    """The kernels-line entry of K7-PF: its headline on powerplant-4.3M's
    1M sorted primaries (ct-fold, the JAX tools' body on the big-scene
    tiers), every (distribution, variant) under "variants"; its hits
    equalled the plain version's bit for bit (max_abs_err 0)."""
    head = pf["res"][("primary", "ct-fold")]
    variants = {
        f"powerplant-4.3M {kind} {name}": {
            "ms": r["ms"], "k7_ms": r["k7_ms"], "ratio_k7": r["ratio_k7"],
            "k2_ms": r["k2_ms"], "ratio_k2": r["ratio_k2"],
            "pops_ray": r["stats"]["pops_ray"],
            "leaf_ray": r["stats"]["leaf_ray"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "share": r["share"],
            "k2_differences": r["differences"],
            "registers": r["registers"]}
        for (kind, name), r in pf["res"].items()}
    return {"name": "bvh_traverse_ct_prefetch", "route": "cuda",
            "source": "rodent_tpu_torch/csrc/bvh_ct.cu",
            "replaces": "rodent_tpu/traversal/pallas_packet.py:96",
            "used_at": "rodent_tpu/traversal/pallas_packet.py:905-931",
            "launches": launched, "max_abs_err": 0.0, "ms": head["ms"],
            "plain_ms": pf["plain_ms"], "bound_ms": head["bound"][0],
            "bound_by": head["bound"][1], "library_ms": None,
            "variants": variants}


def ct_entry(ct, launched, tri12):
    """The kernels-line entry of K7: its headline on hall-260K's 1M sorted
    primaries (ct-fold, the JAX bench's body), every variant under
    "variants" with the pk12 build's ct-fold (tri12); its hits equalled the
    plain version's bit for bit (max_abs_err 0)."""
    head = ct["res"][("hall-260K", "primary", "ct-fold")]
    variants = {
        f"{scene} {kind} {name}": {
            "ms": r["ms"], "k1_ms": r["k1_ms"], "ratio": r["ratio"],
            "pops_ray": r["stats"]["pops_ray"],
            "leaf_ray": r["stats"]["leaf_ray"],
            "warp_pops": r["stats"]["warp_pops"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "share": r["share"],
            "k1_differences": r["differences"]}
        for (scene, kind, name), r in ct["res"].items()}
    variants["hall-260K pk12 primary ct-fold"] = tri12
    return {"name": "bvh_traverse_ct", "route": "cuda",
            "source": "rodent_tpu_torch/csrc/bvh_ct.cu",
            "replaces": "rodent_tpu/traversal/pallas_packet.py:878",
            "launches": launched, "max_abs_err": 0.0, "ms": head["ms"],
            "plain_ms": ct["plain_ms"], "bound_ms": head["bound"][0],
            "bound_by": head["bound"][1], "library_ms": None,
            "variants": variants}


def multi_card(cards):
    """--cards N: phase 17b's sharded calls on an NCCL group of N ranks,
    rank r on cuda:r (the multi-card path of torchrun --nproc-per-node N),
    against the single-device films and K1's hits on cuda:0; nothing else
    of the smoke run."""
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.kernels.build import load_library
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.compiler import (compile_mesh,
                                                  select_render_policy)
    from rodent_tpu_torch.traversal.packet import traverse_packet_components
    from rodent_tpu_torch.utils import testscenes
    check(cards >= 2 and cards % 2 == 0 and
          torch.cuda.device_count() >= cards,
          f"--cards {cards}: an even count of at least 2, and "
          f"{torch.cuda.device_count()} cards are visible")
    t_start = time.perf_counter()
    device = torch.device("cuda:0")
    phase_env()
    load_library(kind="main")      # built once, before the ranks start
    verts, idx = testscenes.make_hall(common.SIZES["hall"])
    scene = compile_mesh(verts, idx, device, max_path_len=20,
                         emitter="inside", bvh_kwargs=common.TRI8)
    bvh = scene.device["bvh"]
    prim = common.distributions("hall", scene.mesh.vertices,
                                scene.mesh.indices, bvh, 1024, device,
                                ("primary",))["primary"][0]
    k1_hits = traverse_packet_components(bvh, *prim)
    size = (1920, 1088, 4)
    cam = Camera.make(*HALL_VIEW, size[0], size[1])
    policy = select_render_policy(scene.device)
    singles, _ = single_films(device, scene.device, cam, policy, size)
    samples = size[0] * size[1] * size[2]
    log(f"[17b] single device (cuda:0), hall-260K {size[0]}x{size[1]} spp "
        f"{size[2]} mpl 20: persistent under the policy {policy} "
        f"{samples / singles[3] / 1e6:.3f} Msamples/s, progressive "
        f"{samples / singles[2] / 1e6:.3f}")
    launched, _ = sharded_group("nccl", cards, None, scene.device, cam, prim,
                                k1_hits, policy, singles, size)
    log(f"[17b] K1 launches in the {cards} NCCL ranks: {launched}")
    log(f"all phases passed in {time.perf_counter() - t_start:.0f} s")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    if sys.argv[1:]:
        if sys.argv[1:2] != ["--cards"] or len(sys.argv) != 3:
            sys.exit("usage: chip_smoke.py [--cards N]")
        multi_card(int(sys.argv[2]))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    from rodent_tpu_torch.device import cuda_device
    from rodent_tpu_torch.experiments import common
    from rodent_tpu_torch.render.compiler import compile_mesh
    from rodent_tpu_torch.utils import testscenes
    from rodent_tpu_torch.traversal.packet import stack_cap
    device = cuda_device()
    t_start = time.perf_counter()
    phase_env()
    ct_regs = phase_build()
    phase_soups(device)

    t0 = time.perf_counter()
    verts, idx = testscenes.make_hall(common.SIZES["hall"])
    scene = compile_mesh(verts, idx, device, max_path_len=20,
                         emitter="inside", bvh_kwargs=common.TRI8)
    bvh = scene.device["bvh"]
    log(f"[4] hall-260K: {scene.mesh.num_tris} tris, "
        f"{bvh['nodes'].shape[0]} BVH8 nodes, {bvh['tris'].shape[0]} Tri8 "
        f"packets, stack {bvh['meta'].shared_stack}+2 of {stack_cap(bvh)}; "
        f"compiled in {time.perf_counter() - t0:.1f} s")
    k_ms, p_ms, err, k1_bound, hall_prim, hall_ao = phase_primary(device,
                                                                  scene)
    launches = phase_render(device, scene)
    phase_golden(device)
    hall, hall_bvh = scene, bvh          # phase 14 renders hall once more
    del scene, bvh
    big = phase_bigscene(device)
    (big_ms, big_plain_ms, big_err, k3_launches, bounds, big_prim,
     big_ao, big_dists) = phase_bigscene_traversal(device, big)
    k2_launches, pool = phase_bigscene_render(device, big)
    big_bvh = big.device["bvh"]
    del big
    phase_golden_persistent(device)
    t_att = time.perf_counter()
    k4_err = phase_option_soups(device)
    k4_launches, variants = 0, {}
    for name, bvh, prim, ao, nonode in (
            ("hall-260K", hall_bvh, hall_prim, hall_ao, SUBSET),
            ("powerplant-4.3M", big_bvh, big_prim, big_ao, NONODE_BIG)):
        n, runs, e = phase_options(device, name, bvh, prim, ao, nonode)
        k4_launches += n
        k4_err = max(k4_err, e)
        variants[name] = {run: {o: {"ms": r["ms"], "k3_ms": r["k3_ms"]}
                                for o, r in res.items() if o != "K3"}
                          for run, res in runs.items()}
    log(f"[11] the attribution phase took {time.perf_counter() - t_att:.1f} s")
    t_tile = time.perf_counter()
    phase_tile_soups(device)
    tile_launches, tiles, tile_plain = phase_tiles(
        device, hall_bvh, verts, idx, big_bvh, big_prim)
    log(f"[12] the tile phase took {time.perf_counter() - t_tile:.1f} s")
    t_probe = time.perf_counter()
    probe_entries = phase_probes(device)
    log(f"[13] the probe phase took {time.perf_counter() - t_probe:.1f} s")
    t_bodies = time.perf_counter()
    bodies = phase_bodies(device, hall, verts, idx, big_bvh, big_prim,
                          big_ao, pool)
    log(f"[14] the body phase took {time.perf_counter() - t_bodies:.1f} s")
    t_obj = time.perf_counter()
    mathall_k1, mathall, mats, texs = phase_mathall(device)
    obj_k2 = phase_obj_files(device, mathall, mats, texs)
    del mathall
    log(f"[15] the OBJ scene phase took {time.perf_counter() - t_obj:.1f} s")
    t_eng = time.perf_counter()
    engines = phase_dual_queue(device, hall_bvh, verts, idx)
    box, _ = common.write_boxes(os.path.join(REPO, "build", "phase16"))
    engines["dense"] = phase_dense(device, box)
    engines["crown_mse"], engines["crown_s"] = phase_golden_tiled(device)
    engines["hybrid_policy"] = phase_hybrid_policy(device, hall)
    phase_engine_tools(device)
    log(f"[16] engines {json.dumps(engines)}")
    log(f"[16] the engine phase took {time.perf_counter() - t_eng:.1f} s")
    t_shard = time.perf_counter()
    shard_k1 = phase_sharded(device, hall, hall_prim)
    phase_bench_tools(device, verts, idx)
    log(f"[17] the sharding and tools phase took "
        f"{time.perf_counter() - t_shard:.1f} s")
    t_tools = time.perf_counter()
    tools = phase_tools(device, verts, idx)
    log(f"[18] the bench and measuring tools phase took "
        f"{time.perf_counter() - t_tools:.1f} s")
    t_prog = time.perf_counter()
    programs, prog_launches = phase_programs(device)
    log(f"[19] the measuring programs phase took "
        f"{time.perf_counter() - t_prog:.1f} s")
    t_ct = time.perf_counter()
    ct = phase_ct(device, hall, big_bvh, big_prim)
    pf = phase_pf(device, big_bvh, big_dists, ct_regs)
    tri12 = phase_tri12(device, hall)
    log(f"[20] the carry-top phase took {time.perf_counter() - t_ct:.1f} s")
    cornell_k1, cornell = phase_cornell(device)
    log(f"[21] cornell {json.dumps(cornell)}")
    log(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    src = "rodent_tpu_torch/csrc/bvh_traverse.cu"
    pallas = "rodent_tpu/traversal/pallas_packet.py"
    # no PyTorch call computes a BVH traversal: library_ms is null. K1-K3
    # run the first body; "variants" holds both bodies' times from phase
    # 14. K1's launches: hall's render (phase 5), mathall's (15a) and the
    # sharded renders of phase 17 (all ranks) and the cornell programs of
    # phase 21; K2's: powerplant's
    # persistent render (phase 9) and tools.render's hbm run on the mathall
    # OBJ (15b); K1-K3's launches in the bench and the tools of phase 18
    # and the measuring programs of phase 19; "sass": each kernel's
    # instantiations in phase 19's SASS audit
    sass = programs["sass_audit"]

    def sass_of(k):
        return {label: r for label, r in sass.items()
                if label.startswith(k + " ")}
    log(json.dumps({"kernels": [
        {"name": "bvh_traverse", "route": "cuda", "source": src,
         "replaces": f"{pallas}:1132",
         "launches": launches + mathall_k1 + shard_k1
                     + tools["bvh_traverse"]
                     + prog_launches["bvh_traverse"] + cornell_k1,
         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None,
         "variants": dict(bodies["bvh_traverse"],
                          **{"hall-260K pk12 primary": tri12["K1"]}),
         "sass": sass_of("K1")},
        {"name": "bvh_traverse_prefetch", "route": "cuda", "source": src,
         "replaces": f"{pallas}:96",
         "launches": k2_launches + obj_k2 + tools["bvh_traverse_prefetch"]
                     + prog_launches["bvh_traverse_prefetch"],
         "max_abs_err": big_err, "ms": big_ms["K2"],
         "plain_ms": big_plain_ms, "bound_ms": bounds["K2"][0],
         "bound_by": bounds["K2"][1], "library_ms": None,
         "variants": bodies["bvh_traverse_prefetch"], "sass": sass_of("K2")},
        {"name": "bvh_traverse_count", "route": "cuda", "source": src,
         "replaces": f"{pallas}:395",
         "launches": k3_launches + tools["bvh_traverse_count"]
                     + prog_launches["bvh_traverse_count"],
         "max_abs_err": big_err, "ms": big_ms["K3"],
         "plain_ms": big_plain_ms, "bound_ms": bounds["K3"][0],
         "bound_by": bounds["K3"][1], "library_ms": None,
         "variants": bodies["bvh_traverse_count"], "sass": sass_of("K3")},
        # ms: row_loads on the powerplant primaries, which does K3's work
        # (so K3's bound); every variant's time is under "variants"
        {"name": "bvh_traverse_option", "route": "cuda", "source": src,
         "replaces": f"{pallas}:395", "launches": k4_launches,
         "max_abs_err": k4_err,
         "ms": variants["powerplant-4.3M"]["primary"]["row_loads"]["ms"],
         "plain_ms": big_plain_ms, "bound_ms": bounds["K3"][0],
         "bound_by": bounds["K3"][1], "library_ms": None,
         "variants": variants},
        # ms: the headline configurations on hall-260K's 1M sorted
        # primaries (K5 tile_rows 16, K6 tiles of 2048 rays), whose plain
        # versions ran on all of those rays; launches: phase 12's
        dict(tile_entry("bvh_traverse_tile", f"{pallas}:395", "K5",
                        tile_launches, tile_plain["K5"], tiles),
             sass=sass_of("K5")),
        dict(tile_entry("bvh_traverse_pair",
                        "experiments/pallas_pair.py:127", "K6",
                        tile_launches, tile_plain["K6"], tiles),
             sass=sass_of("K6")),
        # launches: the bench's, race_hall_packet's and tools.benchmark's
        # primary rows (phase 18) and sass_audit's runs (phase 19); phase
        # 20's are measurement
        dict(ct_entry(ct, tools["bvh_traverse_ct"]
                      + prog_launches["bvh_traverse_ct"], tri12["K7"]),
             sass=sass_of("K7")),
        # launches: tools.benchmark's hbm row on hall's primaries (phase
        # 18); phase 20's are measurement
        pf_entry(pf, tools["bvh_traverse_ct_prefetch"]
                 + prog_launches["bvh_traverse_ct_prefetch"])]
        + probe_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
