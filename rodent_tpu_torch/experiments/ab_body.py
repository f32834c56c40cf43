"""K1/K2/K3's two bodies on the card: what each instantiation holds, and the
two timed in turns at the widths the port launches them.

csrc/bvh_traverse.cu carries two bodies of the per-ray traversal (BODIES):
the group stack ("group", one stack entry per expanded node) and the first
body ("v1", one entry per hit child). Both pop the same entries in the same
order, so both must return the plain version's bits. The renderers and
benchmarks run the first body, from the main library; the group stack is
built only into the "group" library (-DRT_GROUP), beside a copy of the
first body, so that the two are timed against each other in one build.
launch() is that library's wrapper; it sizes the group stack from the
tree's depth (compute_depth, group_cap). This tool:

- prints, for the instantiations the renderers and benchmarks launch
  (BVH8 with Tri8 and Tri24 rows, closest- and any-hit, K1, K2 and K3, each
  body at the stack it takes on hall-260K and powerplant-4.3M), the
  registers, stack frame (local memory) bytes and spills per thread from
  ptxas' -v lines (kept in <library>.nvcc.log), and the resident warps per
  SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor; and, where ncu
  is on the machine, what it says of one hall primary launch;
- holds both bodies bit for bit against the plain version (K1's hits, K2
  equal to K1 in every output, K3's counters equal to the plain counters)
  on the tie scenes (two coincident triangles, in one Tri row and in two
  leaves) and on the given rays;
- times the two in turns (group, v1, v1, group; each turn the median of
  blocks of about 20 ms of launches) on hall-260K's 1M sorted primaries,
  ao and bounce rays; the launches of one render_iteration sample on
  hall-260K at 1920x1088 (2,088,960 rays each: bounce 0, its shadow rays
  and bounce 1 alone, and every launch of the sample back to back, the
  render's K1 time per sample); powerplant-4.3M's 1M sorted primaries
  (K1, K2, K3); and the 32,768 rays of one step of
  render_iteration_persistent on powerplant-4.3M under
  select_render_policy (K2: its closest-hit and any-hit launch alone and
  back to back), each beside its bound (common.bound_ms, summed over a
  sequence's launches).

Usage: python -m rodent_tpu_torch.experiments.ab_body [--resources]
    [--blocks 5]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from ..accel.layout import WideBvh
from ..kernels import build
from ..traversal import api, packet
from . import common

# K1-K3's two bodies, in the order of csrc/bvh_traverse.cu (kGroup,
# kStackV1): the group stack, one entry per expanded node, and the first
# body, one entry per hit child
BODIES = ("group", "v1")
GROUP_CAPS = (16, 64)    # the group stack's compile-time sizes (entries)
# (arity, Tri-M) of the builds the renderers and benchmarks launch
SHAPES = ((8, 8), (8, 24))
VARIANTS = ("K1", "K2", "K3")    # kPlain, kPrefetch, kCount
# the render launches timed: (label, index of the traversal call within
# one render_iteration sample on hall, its any_hit)
HALL_RENDER = (("render bounce 0", 0, False), ("render shadow 0", 1, True),
               ("render bounce 1", 2, False))
# the step of render_iteration_persistent (spp 4) whose rays are timed
POOL_STEP = 100
# launches of the group library's kernels since the last reset_launches(),
# per "<body> <variant>"; raised by one where launch() launches
launches = {f"{b} {v}": 0 for b in BODIES for v in VARIANTS}
# the tie scenes' two prim ids, in lane / leaf order: the first one found
# is the one a first-hit rule keeps
TIE_PRIMS = (5, 3)
TIE_LAYOUTS = ("row", "leaves")


def reset_launches():
    for k in launches:
        launches[k] = 0


# -- the group library -------------------------------------------------------

def compute_depth(child):
    """The deepest inner node's distance from the root of a child table
    ((N, A) int32: > 0 an inner node's row + 1, < 0 a leaf, 0 empty): 0 for
    a root alone. It bounds the group stack, whose entries are proper
    ancestors of the node being expanded, one each. One pass per tree
    level."""
    child = np.asarray(child)
    level = np.zeros(1, np.int64)          # the root's row
    depth = 0
    for d in range(child.shape[0]):
        codes = child[level]
        level = codes[codes > 0].astype(np.int64) - 1
        if level.size == 0:
            return depth
        depth = d + 1
    raise ValueError("BVH child graph is not a tree")


def group_cap(dev):
    """The smallest compiled group stack (GROUP_CAPS) that holds this
    BVH's depth; copies the child codes to the host."""
    nodes = dev["nodes"]
    a = nodes.shape[1] // 7
    child = nodes[:, 6 * a:].contiguous().view(torch.int32).cpu().numpy()
    need = compute_depth(child)
    for cap in GROUP_CAPS:
        if need <= cap:
            return cap
    raise ValueError(f"BVH of depth {need} needs {need} group stack "
                     f"entries; the kernels hold at most {GROUP_CAPS[-1]}")


def caps_of(dev):
    """{body: the compiled stack it takes on this BVH}."""
    return {"group": group_cap(dev), "v1": packet.stack_cap(dev)}


def launch(dev, comps, variant="K1", any_hit=False, body="group", cap=None):
    """K1, K2 or K3 (variant) in `body`, from the group library. comps: the
    ray components in api.components' order; cap: caps_of(dev)[body]
    (computed here when None). Returns the hits, and K3's "pops" and
    "leaf_pops". CPU tensors take the plain version
    (api.traverse_components), the same for both bodies."""
    if body not in BODIES or variant not in VARIANTS:
        raise ValueError(f"ab_body.launch: body {body!r}, variant "
                         f"{variant!r}; takes {BODIES} x {VARIANTS}")
    o, d, inv, _, tmin, tmax = comps
    nodes, tris = dev["nodes"], dev["tris"]
    if nodes.device.type == "cpu":
        return api.traverse_components(dev, o, d, inv, tmin, tmax,
                                       any_hit=any_hit,
                                       count_pops=variant == "K3")
    arity, m = nodes.shape[1] // 7, tris.shape[1] // 14
    shapes_ok = (arity in packet.ARITIES and m in packet.PACKETS
                 if variant == "K1" else
                 arity == packet.WIDE_ARITY and m in packet.WIDE_PACKETS)
    if not shapes_ok or nodes.shape[1] != 7 * arity \
            or tris.shape[1] != 14 * m:
        raise ValueError(f"ab_body.launch: {variant} is not built for "
                         f"node rows of {nodes.shape[1]} and Tri rows of "
                         f"{tris.shape[1]} floats")
    if body == "group" and max(nodes.shape[0], tris.shape[0]) >= 1 << 28:
        raise ValueError("ab_body.launch: the group stack carries child "
                         "codes in 29 bits; tables of 2^28 rows or more "
                         "are not taken")
    cap = caps_of(dev)[body] if cap is None else cap
    flat = [*inv, *o, *d, tmin, tmax]
    n = packet.check_inputs("rt_group_traverse", flat, nodes, tris)

    def empty(dtype):
        return torch.empty(n, dtype=dtype, device=nodes.device)

    out = {"t": empty(torch.float32), "u": empty(torch.float32),
           "v": empty(torch.float32), "prim_id": empty(torch.int32),
           "geom_id": empty(torch.int32)}
    counters = [None, None]
    if variant == "K3":
        out["pops"] = empty(torch.int32)
        out["leaf_pops"] = empty(torch.int32)
        counters = [out["pops"].data_ptr(), out["leaf_pops"].data_ptr()]
    if n == 0:
        return out
    lib = build.load_library(kind="group")
    ptrs = (ctypes.c_void_p * 11)(*(x.data_ptr() for x in flat))
    err = packet.call_on_card(
        nodes.device, lib.rt_group_traverse, nodes.data_ptr(),
        tris.data_ptr(), ptrs, n, arity, m, int(bool(any_hit)), cap,
        *(out[k].data_ptr() for k in ("t", "u", "v", "prim_id",
                                      "geom_id")),
        *counters, VARIANTS.index(variant), BODIES.index(body))
    if err != 0:
        raise RuntimeError(f"rt_group_traverse ({body} {variant}) failed "
                           f"with CUDA error {err}")
    launches[f"{body} {variant}"] += 1
    return out


# -- what an instantiation holds ------------------------------------------

def nvcc_log(kind="group"):
    """ptxas' output of the library's build: built now, or kept beside the
    library when an earlier run built it."""
    path, log = build.build(kind=kind)
    return build.kept_log(path) if log is None else log


def demangle(names):
    """The C++ names of mangled kernel symbols, through cu++filt beside
    nvcc (else c++filt)."""
    nvcc = build.find_nvcc()
    tool = os.path.join(os.path.dirname(nvcc), "cu++filt") if nvcc else None
    if not tool or not os.path.exists(tool):
        tool = shutil.which("c++filt")
    if tool is None:
        raise RuntimeError("neither cu++filt nor c++filt found")
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def normal(name):
    """A kernel's C++ name without spaces and casts, bools as 0/1, as
    c++filt and cu++filt print template arguments differently."""
    for a, b in (("(bool)", ""), ("(int)", ""), (" ", ""), ("true", "1"),
                 ("false", "0")):
        name = name.replace(a, b)
    return name


def resources(log):
    """{normal() C++ name: {"regs", "stack", "spill_st", "spill_ld"}} of
    every kernel in ptxas -v lines: per thread, its registers, its stack
    frame (the local memory its arrays take) and its spill stores and
    loads, in bytes."""
    res, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            res.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            res[cur].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                            spill_ld=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            res.setdefault(cur, {})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            res[cur]["regs"] = int(m.group(1))
    names = demangle(list(res))
    return {normal(names[k]): v for k, v in res.items() if "regs" in v}


def kernel_name(body, variant, arity, m, any_hit, cap):
    """The normal() name of one instantiation's template."""
    fn = "bvh_group_kernel" if body == "group" else "bvh_traverse_kernel"
    return (f"::{fn}<{int(any_hit)},{arity},{m},{cap},"
            f"{VARIANTS.index(variant)}>(")


def resident_warps(body, variant, arity, m, any_hit, cap):
    """Resident warps per SM of one group-library instantiation (blocks of
    128 threads)."""
    lib = build.load_library(kind="group")
    blocks = ctypes.c_int(0)
    err = lib.rt_group_traverse_occupancy(
        BODIES.index(body), VARIANTS.index(variant), arity, m,
        int(any_hit), cap, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed with CUDA error {err}")
    return blocks.value * 128 // 32


def resource_table(caps):
    """{(body, variant, arity, M, any_hit): {"cap", "regs", "stack",
    "spills", "warps"}} for every launched shape; caps: {body: the stack
    it takes on these scenes}."""
    res = resources(nvcc_log())
    table = {}
    for body in BODIES:
        for variant in VARIANTS:
            for (arity, m) in SHAPES:
                for any_hit in (False, True):
                    cap = caps[body]
                    want = kernel_name(body, variant, arity, m, any_hit, cap)
                    hits = [v for k, v in res.items() if want in k]
                    if len(hits) != 1:
                        raise RuntimeError(
                            f"ptxas reports {len(hits)} kernels named "
                            f"{want}; some of its names: {list(res)[:4]}")
                    r = hits[0]
                    table[(body, variant, arity, m, any_hit)] = {
                        "cap": cap, "regs": r["regs"], "stack": r["stack"],
                        "spills": r["spill_st"] + r["spill_ld"],
                        "warps": resident_warps(body, variant, arity, m,
                                                any_hit, cap)}
    return table


def ncu_path():
    """ncu's path, or None where the machine has none."""
    found = shutil.which("ncu")
    if found:
        return found
    nvcc = build.find_nvcc()
    if nvcc:
        cand = os.path.join(os.path.dirname(nvcc), "ncu")
        if os.path.exists(cand):
            return cand
    return None


def ncu_target(device):
    """One K1 launch on hall-260K's 1M sorted primaries, for ncu."""
    verts, idx, dev, _ = common.load("hall", common.TRI8, device)
    comps, _ = common.distributions("hall", verts, idx, dev, 1024, device,
                                    ("primary",))["primary"]
    packet.traverse_packet_components(dev, *comps)


def ncu_stalls(ncu):
    """ncu's warp-state (issue stall) and scheduler sections for one hall
    primary K1 launch: its exit code and its output's last lines."""
    cmd = [ncu, "--section", "WarpStateStats", "--section", "SchedulerStats",
           "-k", "regex:bvh_traverse", "--launch-count", "1", sys.executable,
           "-m", "rodent_tpu_torch.experiments.ab_body", "--ncu-target"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except subprocess.TimeoutExpired:
        return "ncu: no result within 300 s"
    lines = (res.stdout + res.stderr).strip().splitlines()
    return f"ncu exit {res.returncode}:\n" + "\n".join(lines[-40:])


# -- the tie scenes ----------------------------------------------------------

def tie_bvh(layout, arity=8, m=8):
    """A WideBvh of two coincident triangles (the same vertices, prim ids
    TIE_PRIMS) under one root: "row" puts both in one Tri row (lanes 0 and
    1, so lane order decides which a first-hit rule keeps), "leaves" one in
    each of two leaves with the same box (slots 0 and 1, so the visit
    order decides)."""
    v0 = np.array([0.0, 0.0, 0.0], np.float32)
    v1 = np.array([1.0, 0.0, 0.0], np.float32)
    v2 = np.array([0.0, 1.0, 0.0], np.float32)
    e1, e2 = v0 - v1, v2 - v0
    nrm = np.cross(e1, e2).astype(np.float32)
    rows = 1 if layout == "row" else 2
    bounds = np.zeros((1, 6, arity), np.float32)
    child = np.zeros((1, arity), np.int32)
    box = np.array([0.0, 1.0, 0.0, 1.0, -0.01, 0.01], np.float32)
    for r in range(rows):
        bounds[0, :, r] = box
        child[0, r] = ~r
    pid = np.full((rows, m), -1, np.int32)
    if layout == "row":
        pid[0, :2] = TIE_PRIMS
    else:
        pid[:, 0] = TIE_PRIMS
    lanes = (pid != -1)[..., None]
    tri = [np.where(lanes, x, np.float32(0.0)).astype(np.float32)
           for x in (v0, e1, e2, nrm)]
    return WideBvh(arity=arity, packet=m, bounds=bounds, child=child,
                   tri_v0=tri[0], tri_e1=tri[1], tri_e2=tri[2], tri_n=tri[3],
                   prim_id=pid,
                   geom_id=np.where(pid != -1, 7, -1).astype(np.int32))


def tie_rays(n=256, seed=11):
    """(org, dir) numpy rays from z = -1 towards the tie triangle at z = 0,
    most of them through its inside, a few past its edges."""
    r = np.random.RandomState(seed)
    org = np.stack([r.uniform(-0.1, 0.6, n), r.uniform(-0.1, 0.6, n),
                    np.full(n, -1.0)], 1).astype(np.float32)
    d = np.stack([r.uniform(-0.05, 0.05, n), r.uniform(-0.05, 0.05, n),
                  np.ones(n)], 1).astype(np.float32)
    return org, d


# -- both bodies against the plain version ---------------------------------

def run(dev, comps, variant="K1", any_hit=False, body=None, cap=None):
    """One launch of K1, K2 or K3: in `body` from the group library
    (launch()), or from the main library, as the renderers run it, when
    body is None."""
    if body is not None:
        return launch(dev, comps, variant, any_hit, body, cap)
    kw = {"K1": {}, "K2": {"prefetch": True},
          "K3": {"count_pops": True}}[variant]
    return packet.traverse_packet_components(dev, *comps, any_hit=any_hit,
                                             **kw)


def check_bodies(dev, comps, any_hit, what):
    """Both bodies against the plain version on these rays: K1's five
    outputs bit for bit, K2's equal to K1's and K3's counters equal to the
    plain counters (K2 and K3 where the build is theirs, BVH8 with Tri
    rows packet.WIDE_PACKETS). Raises on a difference; returns the plain
    version's output (with its counters)."""
    o, d, inv, _, tmin, tmax = comps
    plain = api.traverse_components(dev, o, d, inv, tmin, tmax,
                                    any_hit=any_hit, count_pops=True)
    wide = (dev["nodes"].shape[1] == 7 * packet.WIDE_ARITY
            and dev["tris"].shape[1] // 14 in packet.WIDE_PACKETS)
    caps = caps_of(dev)
    for body in BODIES:
        k1 = run(dev, comps, "K1", any_hit, body, caps[body])
        for key, val in k1.items():
            if not torch.equal(val, plain[key]):
                bad = int((val != plain[key]).sum())
                raise RuntimeError(f"{what}: {body} K1 {key} differs from "
                                   f"the plain version on {bad} rays")
        if not wide:
            continue
        k2 = run(dev, comps, "K2", any_hit, body, caps[body])
        k3 = run(dev, comps, "K3", any_hit, body, caps[body])
        for key, val in k2.items():
            if not torch.equal(val, k1[key]):
                raise RuntimeError(f"{what}: {body} K2 {key} differs from K1")
        for key, val in k3.items():
            if not torch.equal(val, plain[key]):
                raise RuntimeError(f"{what}: {body} K3 {key} differs from "
                                   "the plain version")
    return plain


def check_ties(device):
    """Both bodies on the tie scenes, closest- and any-hit: equal to the
    plain version bit for bit, and every ray that hits keeps the first of
    the two coincident triangles (TIE_PRIMS[0]). Returns {layout: rays that
    hit}."""
    org, d = tie_rays()
    hits = {}
    for layout in TIE_LAYOUTS:
        dev = api.bvh_to_device(tie_bvh(layout), device)
        for any_hit in (False, True):
            rays = api.make_rays(org, d, 0.0, 1e30, device=device)
            plain = check_bodies(dev, api.components(rays), any_hit,
                                 f"tie {layout} any_hit={any_hit}")
            hit = plain["prim_id"] >= 0
            if not bool((plain["prim_id"][hit] == TIE_PRIMS[0]).all()):
                raise RuntimeError(f"tie {layout}: a ray kept the second of "
                                   "two equal hits")
            hits[layout] = int(hit.sum())
    return hits


# -- the widths the port launches ------------------------------------------

class Capture:
    """Records the ray components of chosen traversal calls of the
    renderers (integrator.traverse_packet_components) while a render runs:
    `pick(i, any_hit)` says which call numbers to keep. The calls still run
    through the kernels as they would."""

    def __init__(self, pick):
        self.pick = pick
        self.calls = 0
        self.kept = {}

    def __enter__(self):
        from ..render import integrator
        self.mod = integrator
        self.orig = integrator.traverse_packet_components

        def rec(dev, org, dirv, inv_d, inv_o, tmin, tmax, any_hit=False,
                **kw):
            if self.pick(self.calls, any_hit):
                self.kept[self.calls] = (
                    (tuple(c.clone() for c in org),
                     tuple(c.clone() for c in dirv),
                     tuple(c.clone() for c in inv_d),
                     tuple(c.clone() for c in inv_o), tmin.clone(),
                     tmax.clone()), any_hit)
            self.calls += 1
            return self.orig(dev, org, dirv, inv_d, inv_o, tmin, tmax,
                             any_hit=any_hit, **kw)
        integrator.traverse_packet_components = rec
        return self

    def __exit__(self, *exc):
        self.mod.traverse_packet_components = self.orig


def hall_render_rays(scene, w=1920, h=1088):
    """The traversal launches of one render_iteration sample on hall at
    chip_smoke phase 5's camera: {label: (comps, any_hit)} of the
    HALL_RENDER calls, and "render sample": [(comps, any_hit)] of every
    call of the sample, in order (closest-hit bounces and their any-hit
    shadow rays, each at the full width, dead rays included)."""
    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.integrator import render_iteration
    device = scene.device["bvh"]["nodes"].device
    cam = Camera.make((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0,
                      w, h)
    with Capture(lambda i, _: True) as cap:
        render_iteration(scene.device, cam, film_mod.new_film(w, h, device),
                         w, h, 1, 0)
    out = {}
    for label, i, any_hit in HALL_RENDER:
        comps, got = cap.kept[i]
        if got != any_hit:
            raise RuntimeError(f"{label}: call {i} has any_hit={got}")
        out[label] = (comps, any_hit)
    out["render sample"] = [cap.kept[i] for i in range(cap.calls)]
    return out


def pool_capture(step=POOL_STEP):
    """A Capture, around one render_iteration_persistent iteration, of its
    step `step`: its closest-hit and its any-hit launch (the first of each
    from the 2 * step-th traversal call on). pool_launches() reads them."""
    first = {}

    def pick(i, any_hit):
        if i >= 2 * step and any_hit not in first:
            first[any_hit] = i
            return True
        return False
    cap = Capture(pick)
    cap.first = first
    return cap


def pool_launches(cap):
    """{label: (comps, any_hit)} of a pool_capture()'s two launches."""
    return {"pool closest": cap.kept[cap.first[False]],
            "pool any-hit": cap.kept[cap.first[True]]}


def pool_rays(scene, cam=common.BIG_CAM, w=1920, h=1088, spp=4,
              step=POOL_STEP):
    """pool_launches() of step `step` of one render_iteration_persistent
    iteration (iteration 0, as chip_smoke.py phase 9 renders it) on the big
    scene under select_render_policy."""
    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.compiler import select_render_policy
    from ..render.integrator import render_iteration_persistent
    device = scene.device["bvh"]["nodes"].device
    with pool_capture(step) as cap:
        render_iteration_persistent(scene.device, Camera.make(*cam, w, h),
                                    film_mod.new_film(w, h, device), w, h,
                                    spp, 0, **select_render_policy(
                                        scene.device))
    return pool_launches(cap)


def bound(dev, comps, any_hit, counted):
    """The launch's bound (common.bound_ms) from a counted run's pops and
    the table rows the plain version reads."""
    s = common.pop_stats(counted)
    rows = common.rows_read(dev, comps, any_hit)
    return common.bound_ms(dev, s["n"], s["node"], s["leaf"], rows, any_hit)


def ab(dev, seq_launches, device, variant="K1", blocks=5):
    """The two bodies of one kernel in turns (group, v1, v1, group) on a
    sequence of launches [(comps, any_hit)], launched back to back: {"group",
    "v1": ms per sequence, "bound": (ms, by) summed over the launches, each
    launch's bound (common.bound_ms) being the least time the card could
    take for it, "pops_ray", "n": rays}."""
    caps = caps_of(dev)

    def seq(body):
        return lambda: [run(dev, comps, variant, any_hit, body, caps[body])
                        for comps, any_hit in seq_launches]
    g_ms, v_ms, _, _ = common.in_turns(seq("group"), seq("v1"), device,
                                       blocks, warmup_s=common.WARMUP_S)
    b_ms, by, pops, n = 0.0, {}, 0, 0
    for comps, any_hit in seq_launches:
        counted = run(dev, comps, "K3", any_hit)
        s = common.pop_stats(counted)
        ms, what = bound(dev, comps, any_hit, counted)
        b_ms += ms
        by[what] = by.get(what, 0.0) + ms
        pops += s["pops"]
        n += s["n"]
    return {"group": g_ms, "v1": v_ms,
            "bound": (b_ms, max(by, key=by.get)), "pops_ray": pops / n,
            "n": n}


def measure(device, widths, blocks=5):
    """Every width in turns. widths: [(scene, label, dev, launches,
    variants)], launches as ab() takes them. Returns {(scene, label,
    variant): ab() + {"any_hit": whether every launch is any-hit}}."""
    res = {}
    for scene, label, dev, launches, variants in widths:
        for variant in variants:
            r = ab(dev, launches, device, variant, blocks)
            res[(scene, label, variant)] = r | {
                "any_hit": all(a for _, a in launches)}
    return res


def report(res, table, m_of):
    """Lines of the A/B: per width and kernel, both bodies' ms and share of
    the bound and their ratio, with registers, local bytes and resident
    warps of each instantiation (closest-hit's for a sequence that mixes
    both); m_of: {scene: Tri-M}."""
    lines = []
    for (scene, label, variant), r in res.items():
        b_ms, by = r["bound"]
        cells = []
        for body in BODIES:
            t = table[(body, variant, 8, m_of[scene], r["any_hit"])]
            cells.append(f"{body} {r[body]:.4f} ms ({b_ms / r[body]:.1%}; "
                         f"{t['regs']} regs, {t['stack']} B local, "
                         f"{t['warps']} warps)")
        lines.append(f"{scene} {label} {variant}, {r['n']} rays, "
                     f"{r['pops_ray']:.2f} pops/ray: {'; '.join(cells)}; "
                     f"group/v1 {r['group'] / r['v1']:.4f}; bound "
                     f"{b_ms:.4f} ms ({by})")
    return lines


def widths_of(hall_bvh, hall_dists, hall_render, big_bvh, big_prim, pool):
    """The A/B's widths (measure()): hall's distributions and render
    launches (K1), powerplant's primaries (K1, K2, K3) and its pool step
    (K2, each launch and the step's two back to back)."""
    widths = [("hall", name, hall_bvh, [(comps, any_hit)], ("K1",))
              for name, (comps, any_hit) in hall_dists.items()]
    for label, val in hall_render.items():
        widths.append(("hall", label, hall_bvh,
                       val if isinstance(val, list) else [val], ("K1",)))
    widths.append(("powerplant", "primary", big_bvh, [(big_prim, False)],
                   ("K1", "K2", "K3")))
    widths += [("powerplant", label, big_bvh, [val], ("K2",))
               for label, val in pool.items()]
    widths.append(("powerplant", "pool step", big_bvh, list(pool.values()),
                   ("K2",)))
    return widths


def main(argv=None):
    p = argparse.ArgumentParser(prog="ab_body")
    p.add_argument("--resources", action="store_true",
                   help="the resource table and ncu's result only")
    p.add_argument("--ncu-target", action="store_true",
                   help="one hall primary K1 launch, the program ncu runs")
    p.add_argument("--blocks", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ab_body: no CUDA card")
    device = torch.device("cuda")
    if args.ncu_target:
        ncu_target(device)
        return
    from ..render.compiler import compile_mesh
    from ..utils import testscenes
    print(f"card: {common.card(device)}", flush=True)
    t0 = time.perf_counter()
    verts, idx = testscenes.make_hall(common.SIZES["hall"])
    hall = compile_mesh(verts, idx, device, max_path_len=20,
                        emitter="inside", bvh_kwargs=common.TRI8)
    hdev = hall.device["bvh"]
    table = resource_table(caps_of(hdev))
    print("body variant arity M any_hit: stack cap, registers, stack frame "
          "bytes, spill bytes, resident warps per SM")
    for key, r in table.items():
        print(" ".join(str(x) for x in key), r, flush=True)
    ncu = ncu_path()
    print(ncu_stalls(ncu) if ncu else "ncu: not on this machine",
          flush=True)
    if args.resources:
        return
    print(f"tie scenes: rays that hit {check_ties(device)}; both bodies == "
          "plain", flush=True)
    dists = common.distributions("hall", verts, idx, hdev, 1024, device,
                                 ("primary", "ao", "bounces"))
    for name, (comps, any_hit) in dists.items():
        check_bodies(hdev, comps, any_hit, f"hall {name}")
    render = hall_render_rays(hall)
    del hall
    big = compile_mesh(*testscenes.make_powerplant(common.SIZES["powerplant"]),
                       device, max_path_len=20, emitter="above",
                       bvh_kwargs=common.TRI24)
    bdev = big.device["bvh"]
    if caps_of(bdev) != caps_of(hdev):
        raise RuntimeError(f"powerplant takes stacks {caps_of(bdev)}")
    prim = common.distributions("powerplant", big.mesh.vertices,
                                big.mesh.indices, bdev, 1024, device,
                                ("primary",))["primary"][0]
    check_bodies(bdev, prim, False, "powerplant primary")
    pool = pool_rays(big)
    print(f"set-up and checks {time.perf_counter() - t0:.1f} s", flush=True)
    res = measure(device, widths_of(hdev, dists, render, bdev, prim, pool),
                  args.blocks)
    print(f"card after: {common.card(device)}", flush=True)
    for line in report(res, table, {"hall": 8, "powerplant": 24}):
        print(line, flush=True)


if __name__ == "__main__":
    main()
