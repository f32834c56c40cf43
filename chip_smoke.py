#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rodent_tpu_torch) on one NVIDIA GPU.

Drives the port's main path once at the size the repository's benchmark
calls real, and checks it:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. builds the BVH traversal kernels (csrc/bvh_traverse.cu) with nvcc: K1,
   its prefetching variant K2 and its pop-counting variant K3;
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
   counters, and 65,536 any-hit ao rays through K2;
9. the persistent renderer on powerplant-4.3M at 1920x1088, spp 4, max
   path length 20 under the port's select_render_policy (K2, pool sort),
   three iterations, with every kernel's launch count read around them,
   then one iteration with a 16x larger pool for comparison;
10. the hall golden gate through render_iteration_persistent (K1).

Run from the repository root: python3 chip_smoke.py
Needs one CUDA card, nvcc and g++; writes only under build/ and, when
the shared BVH builder's library is missing, rodent_tpu/native/. Any failed
check raises, so the exit code is not 0; the last line of a successful
run is a JSON object naming the device.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TIE_LIMIT = 1e-4            # exact-t ties allowed in phases 4, 8: < 0.01%
SUBSET = 65_536             # ao rays held against the plain version
# the big-scene build of bench.py:174-175 (Tri24 leaves, cheap DP leaves)
BIG_BVH = {"packet": 24, "quality": 0, "leaf_threshold": 12,
           "leaf_cost": 0.45}
BIG_CAM = ((-30.0, 60.0, -30.0), (130.0, -40.0, 130.0), (0, 1, 0), 55.0)


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def timed(fn, iters, blocks, warmup_s=0.0):
    """Median per-call milliseconds over `blocks` blocks of `iters` calls,
    timed with CUDA events after warm-up calls (at least one, and for at
    least warmup_s seconds, so the card leaves its idle clocks); returns
    (ms, result)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    while time.perf_counter() - t0 < warmup_s:
        out = fn()
        torch.cuda.synchronize()
    samples = []
    for _ in range(blocks):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            out = fn()
        e1.record()
        torch.cuda.synchronize()
        samples.append(e0.elapsed_time(e1) / iters)
    samples.sort()
    return samples[len(samples) // 2], out


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


def phase_build():
    from rodent_tpu_torch.kernels.build import build, load_library
    t0 = time.perf_counter()
    path, nvcc_log = build()
    dt = time.perf_counter() - t0
    load_library()
    if nvcc_log is None:
        log(f"[2] kernel library already built: "
            f"{os.path.relpath(path, REPO)}")
        return
    with open(os.path.join(os.path.dirname(path), "nvcc.log"), "w") as f:
        f.write(nvcc_log)
    regs = [int(w) for line in nvcc_log.splitlines()
            if "Used" in line and "registers" in line
            for w in [line.split("Used")[1].split()[0]]]
    spills = sum("0 bytes spill stores" not in line
                 for line in nvcc_log.splitlines() if "spill stores" in line)
    log(f"[2] built K1, K2 and K3 from rodent_tpu_torch/csrc/"
        f"bvh_traverse.cu in {dt:.1f} s: {len(regs)} kernels, registers "
        f"{min(regs)}-{max(regs)}, {spills} with spills -> "
        f"{os.path.relpath(path, REPO)}")


def phase_soups(device):
    from rodent_tpu.accel import build_bvh
    from rodent_tpu_torch.traversal import api
    from rodent_tpu_torch.traversal.packet import traverse_packet
    err = 0.0
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
            rays = api.make_rays(org, d, 0.0, tmax, device=device)
            k = traverse_packet(dev, rays)
            p = api.traverse(dev, rays)
            ties, e = compare_hits(k, p, f"soup A{arity} M{m}")
            check(ties == 0, f"soup A{arity} M{m}: {ties} prim_id ties")
            err = max(err, e)
            short = api.make_rays(org, d, 0.0, np.minimum(tmax, 2.0),
                                  device=device)
            ka = traverse_packet(dev, short, any_hit=True)["prim_id"] >= 0
            pa = api.traverse(dev, short, any_hit=True)["prim_id"] >= 0
            check(bool(torch.equal(ka, pa)),
                  f"soup A{arity} M{m}: any-hit hit/miss differs")
    log(f"[3] K1 == plain on 9 soups (A 2/4/8 x M 4/8/16), closest-hit "
        f"and any-hit: prim_id identical, max |dt,du,dv| {err:.3g}")


def phase_primary(device, scene):
    from rodent_tpu.utils import testscenes
    from rodent_tpu_torch.core.math import FLT_MAX
    from rodent_tpu_torch.traversal import api
    from rodent_tpu_torch.traversal.packet import (
        traverse_packet_components)
    from rodent_tpu_torch.traversal.sorting import sort_rays
    bvh = scene.device["bvh"]
    org, dirs = testscenes.hall_primary_rays(1024, 1024)
    n = len(org)
    rays = api.make_rays(org, dirs, 0.0, FLT_MAX, device=device)
    srt, perm = sort_rays(rays, scene.device["scene_lo"],
                          scene.device["scene_hi"])
    o, d, inv, inv_o, tmin, tmax = api.components(srt)

    def k1():
        return traverse_packet_components(bvh, o, d, inv, inv_o, tmin,
                                          tmax)

    k_ms, hit = timed(k1, iters=20, blocks=5, warmup_s=0.5)
    clock = sm_clock()
    mrays = n / k_ms / 1e3
    hit_frac = float((hit["prim_id"] >= 0).float().mean())
    log(f"[4] hall-260K primary, {n} sorted rays: K1 {k_ms:.4f} ms = "
        f"{mrays:.1f} Mrays/s (median of 5 blocks x 20 after 0.5 s of "
        f"warm-up; SM clock, power after: {clock}), hit fraction "
        f"{hit_frac:.4f}")

    def plain():
        return api.traverse_components(bvh, o, d, inv, tmin, tmax)

    p_ms, phit = timed(plain, iters=1, blocks=3)
    log(f"[4] plain version on the same {n} rays: {p_ms:.1f} ms = "
        f"{n / p_ms / 1e3:.3f} Mrays/s (median of 3)")
    ties, err = compare_hits(hit, phit, "hall primary")
    check(ties < TIE_LIMIT * n, f"hall primary: {ties} ties")
    log(f"[4] K1 vs plain on all {n} primary rays: {ties} exact-t ties "
        f"({100.0 * ties / n:.4f}%), other prim_id mismatches 0, max "
        f"|dt,du,dv| {err:.3g}")

    # ao rays from the primary hit points, in pixel order
    t = torch.empty_like(hit["t"])
    t[perm] = hit["t"]
    pid = torch.empty_like(hit["prim_id"])
    pid[perm] = hit["prim_id"]
    mesh = scene.mesh
    o2, d2, tmin2, tmax2 = testscenes.secondary_rays_from_trace(
        "ao", org, dirs, t.cpu().numpy(), pid.cpu().numpy(),
        mesh.vertices, mesh.indices.reshape(-1, 4))
    sub = slice(0, SUBSET)
    ao = api.make_rays(o2[sub], d2[sub], tmin2[sub], tmax2[sub],
                       device=device)
    oc, dc, ic, ioc, tmn, tmx = api.components(ao)
    ka = traverse_packet_components(bvh, oc, dc, ic, ioc, tmn, tmx,
                                    any_hit=True)["prim_id"] >= 0
    pa = api.traverse_components(bvh, oc, dc, ic, tmn, tmx,
                                 any_hit=True)["prim_id"] >= 0
    check(bool(torch.equal(ka, pa)), "hall ao: any-hit hit/miss differs")
    log(f"[4] {SUBSET} ao any-hit rays: hit/miss identical, occluded "
        f"fraction {float(ka.float().mean()):.4f}")
    return k_ms, p_ms, err


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
    from rodent_tpu.io import png
    from rodent_tpu.utils import testscenes
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


def phase_bigscene(device, tris=5_000_000):
    from rodent_tpu.utils import testscenes
    from rodent_tpu_torch.render.compiler import (compile_mesh,
                                                  fast_memory_bytes,
                                                  packet_mode)
    from rodent_tpu_torch.traversal.packet import stack_cap
    t0 = time.perf_counter()
    verts, idx = testscenes.make_powerplant(tris)
    t_gen = time.perf_counter() - t0
    timings = {}
    scene = compile_mesh(verts, idx, device, max_path_len=20,
                         emitter="above", bvh_kwargs=BIG_BVH,
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
    return verts, scene


def phase_bigscene_traversal(device, verts, scene, side=1024):
    from rodent_tpu.utils import testscenes
    from rodent_tpu_torch.core.math import FLT_MAX
    from rodent_tpu_torch.traversal import api, packet
    from rodent_tpu_torch.traversal.sorting import sort_rays
    bvh = scene.device["bvh"]
    org, dirs = testscenes.powerplant_primary_rays(side, side)
    n = len(org)
    rays = api.make_rays(org, dirs, 0.0, FLT_MAX, device=device)
    srt, perm = sort_rays(rays, verts.min(0), verts.max(0))
    comps = api.components(srt)
    o, d, inv, _, tmin, tmax = comps

    def kernel(**kw):
        return lambda: packet.traverse_packet_components(bvh, *comps, **kw)

    torch.cuda.reset_peak_memory_stats()
    ms, hits = {}, {}
    # in turns, K1, K2, K2, K1, then K3; a kernel's time is the mean of
    # its turns, each the median of 5 blocks of 10 launches
    for name, kw in (("K1", {}), ("K2", {"prefetch": True}),
                     ("K2", {"prefetch": True}), ("K1", {}),
                     ("K3", {"count_pops": True})):
        t, hits[name] = timed(kernel(**kw), iters=10, blocks=5,
                              warmup_s=0.5)
        ms.setdefault(name, []).append(t)
    clock = sm_clock()
    k1, k2, k3 = hits["K1"], hits["K2"], hits["K3"]
    for key in ("t", "u", "v", "prim_id", "geom_id"):
        check(bool(torch.equal(k1[key], k2[key])),
              f"powerplant primary: K2 {key} differs from K1")
    p_ms, plain = timed(lambda: api.traverse_components(
        bvh, o, d, inv, tmin, tmax, count_pops=True), iters=1, blocks=2)
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
    pops = float(att["pops"].double().mean())
    leaf = float(att["leaf_pops"].double().mean())
    log(f"[8] K3 counters == plain counters on all {n} rays: mean pops "
        f"per ray {pops:.3f}, leaf pops {leaf:.3f}, leaf share "
        f"{leaf / pops:.4f}")

    # ao rays from the primary hit points, in pixel order
    t = torch.empty_like(k1["t"])
    t[perm] = k1["t"]
    pid = torch.empty_like(k1["prim_id"])
    pid[perm] = k1["prim_id"]
    mesh = scene.mesh
    o2, d2, tmin2, tmax2 = testscenes.secondary_rays_from_trace(
        "ao", org, dirs, t.cpu().numpy(), pid.cpu().numpy(),
        mesh.vertices, mesh.indices.reshape(-1, 4))
    sub = slice(0, SUBSET)
    ao = api.make_rays(o2[sub], d2[sub], tmin2[sub], tmax2[sub],
                       device=device)
    aoc = api.components(ao)
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
    return k_ms, p_ms, err, k3_launches


def phase_bigscene_render(device, scene, w=1920, h=1088):
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
    cam = Camera.make(*BIG_CAM, w, h)
    film = film_mod.new_film(w, h, device)
    secs, steps = [], []
    packet.reset_launches()
    for it in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
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
    return launches["bvh_traverse_prefetch"]


def phase_golden_persistent(device):
    from rodent_tpu.io import png
    from rodent_tpu.utils import testscenes
    from rodent_tpu_torch.render import film as film_mod
    from rodent_tpu_torch.render.camera import Camera
    from rodent_tpu_torch.render.compiler import compile_mesh
    from rodent_tpu_torch.render.integrator import (
        render_iteration_persistent)
    from rodent_tpu_torch.traversal import packet
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
    packet.reset_launches()
    for it in range(m["test_iters"]):
        film = render_iteration_persistent(scene.device, cam, film, w, h,
                                           m["spp"], it, packet=True)
    check(packet.launches["bvh_traverse"] > 0
          and packet.launches["bvh_traverse_prefetch"] == 0,
          f"persistent golden: launches {packet.launches}")
    img = film_mod.tonemap(film, w, h, m["test_iters"])
    golden = png.read_png(os.path.join(gdir, "hall.png"))[..., :3]
    mse = film_mod.mse_u8(golden, img)
    gate = 3.0 * m["calib_mse_u8"] + 1.0
    check(mse <= gate, f"persistent golden: MSE {mse:.1f} over the gate "
          f"{gate:.1f}")
    check(abs(float(img.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"],
          f"persistent golden: image mean {img.mean():.1f} vs "
          f"{m['mean_u8']}")
    log(f"[10] hall golden gate through render_iteration_persistent "
        f"(K1, {packet.launches['bvh_traverse']} launches): MSE "
        f"{mse:.2f} <= {gate:.2f}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    from rodent_tpu.utils import testscenes
    from rodent_tpu_torch.device import cuda_device
    from rodent_tpu_torch.render.compiler import compile_mesh
    from rodent_tpu_torch.traversal.packet import stack_cap
    device = cuda_device()
    t_start = time.perf_counter()
    phase_env()
    phase_build()
    phase_soups(device)

    t0 = time.perf_counter()
    verts, idx = testscenes.make_hall(260_000)
    scene = compile_mesh(verts, idx, device, max_path_len=20,
                         emitter="inside",
                         bvh_kwargs={"packet": 8, "leaf_threshold": 12})
    bvh = scene.device["bvh"]
    log(f"[4] hall-260K: {scene.mesh.num_tris} tris, "
        f"{bvh['nodes'].shape[0]} BVH8 nodes, {bvh['tris'].shape[0]} Tri8 "
        f"packets, stack {bvh['meta'].shared_stack}+2 of {stack_cap(bvh)}; "
        f"compiled in {time.perf_counter() - t0:.1f} s")
    k_ms, p_ms, err = phase_primary(device, scene)
    launches = phase_render(device, scene)
    phase_golden(device)
    del scene, bvh
    big_verts, big = phase_bigscene(device)
    big_ms, big_plain_ms, big_err, k3_launches = phase_bigscene_traversal(
        device, big_verts, big)
    k2_launches = phase_bigscene_render(device, big)
    del big
    phase_golden_persistent(device)
    log(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    src = "rodent_tpu_torch/csrc/bvh_traverse.cu"
    pallas = "rodent_tpu/traversal/pallas_packet.py"
    log(json.dumps({"kernels": [
        {"name": "bvh_traverse", "route": "cuda", "source": src,
         "replaces": f"{pallas}:878", "launches": launches,
         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms},
        {"name": "bvh_traverse_prefetch", "route": "cuda", "source": src,
         "replaces": f"{pallas}:96", "launches": k2_launches,
         "max_abs_err": big_err, "ms": big_ms["K2"],
         "plain_ms": big_plain_ms},
        {"name": "bvh_traverse_count", "route": "cuda", "source": src,
         "replaces": f"{pallas}:395", "launches": k3_launches,
         "max_abs_err": big_err, "ms": big_ms["K3"],
         "plain_ms": big_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
