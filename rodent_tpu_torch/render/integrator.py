"""Wavefront path tracer (torch port of rodent_tpu/render/integrator.py).

The estimator is the JAX package's, term for term (renderer.impala:62-163):
FNV-seeded camera rays with pixel jitter, emissive hits weighted by MIS
against light sampling, next-event estimation with an any-hit shadow ray,
and BSDF-sampled bounces with Russian roulette clamped at 0.75.

Per-ray state is a set of flat (B,) tensors, Vec3s as tuples of them
(core.vmath). The JAX `while_loop`s are Python loops that read one boolean
back per step. Every traversal (camera and bounce rays closest-hit, shadow
rays any-hit) goes to the engine the packet argument names (_engine):
traversal.packet.traverse_packet_components, on a CUDA device the kernel
K1 (packet=True, the default) or its prefetching variant K2
(packet="hbm"/"giga", the big-scene tiers) and on the CPU their plain
torch version; the dual-queue engine of traversal/tiled.py (packet=False,
with compact and sub) or the dense engine of traversal/dense.py
(packet="dense"), torch ops on either device.

Textured scenes (a texture bank in the scene, compiler.compile_obj or
compile_mesh with tex_images) take kd/ks from the bank at the hit's uv,
and textured lights their radiance, on hit and in NEE (_sample_bank).

Two renderers: render_iteration (spp wavefront passes, each traced to
completion over the whole image) and render_iteration_persistent (a fixed
pool of ray slots; a slot whose path ends is splatted and re-emitted with
the next unprocessed sample, the reference's megakernel regeneration).
"""
from __future__ import annotations

import torch

from ..core import vmath as vm
from ..core.math import FLT_MAX, safe_rcp
from ..core.rng import randf, seed_camera_rays
from ..traversal.dense import traverse_dense_components
from ..traversal.packet import traverse_packet_components
from ..traversal.sorting import ray_sort_keys
from ..traversal.tiled import traverse_components
from . import bsdf as bsdf_mod
from . import light as light_mod

OFFSET = 1e-3  # shadow/bounce epsilon (renderer.impala:64)
_DEAD_KEY = 0xFFFFFFFF


def make_rays_c(org, dirv, tmin, tmax):
    """Component-layout ray bundle with precomputed inverses
    (intersection.impala make_ray)."""
    inv_d = tuple(safe_rcp(d) for d in dirv)
    inv_o = tuple(-o * i for o, i in zip(org, inv_d))
    return {"org": org, "dir": dirv, "inv_dir": inv_d, "inv_org": inv_o,
            "tmin": tmin, "tmax": tmax}


# the hybrid tiers' full-packet flavours (integrator.py:479-485, :628-629)
_HYBRID = {"hybrid": True, "hybrid-hbm": "hbm", "hybrid-giga": "giga"}


def _engine(packet):
    """The renderer's packet argument -> the engine that traces a bundle:
    "packet" (True: K1), "hbm" or "giga" (K2: on the card one prefetching
    kernel serves both of the TPU's HBM transports), "tiled" (False: the
    dual-queue engine, traversal/tiled.py) or "dense" (the brute-force
    engine, traversal/dense.py). The hybrid tiers take their full-packet
    flavour: the TPU peels their depth-0 rays onto its packet kernel and
    traces the bounces on the dual-queue engine to spare the bounces the
    packet kernel's tile-union tax, which K1 (one stack per ray) does not
    pay."""
    packet = _HYBRID.get(packet, packet)
    if packet is True:
        return "packet"
    if packet is False:
        return "tiled"
    if packet in ("hbm", "giga", "dense"):
        return packet
    raise ValueError(f"unknown packet engine {packet!r}")


def _traverse(scene, rays, any_hit=False, packet=True, sort=False,
              compact=0, sub=0):
    """Traversal of a ray bundle (integrator.py:68-140) on the engine that
    `packet` names (see _engine): K1, K2, the dual-queue engine (with its
    staged compaction `compact` and sub-batches `sub`) or the dense engine.
    sort=True traces the bundle in octant+Morton key order (dead rays,
    tmax <= 0, to the tail) and scatters the hits back to slot order; the
    dense engine is order-insensitive and is never sorted."""
    engine = _engine(packet)
    sort = sort and engine != "dense"
    if sort:
        keys = ray_sort_keys(rays["org"], rays["dir"], scene["scene_lo"],
                             scene["scene_hi"])
        keys = torch.where(rays["tmax"] > 0.0, keys, _DEAD_KEY)
        perm = torch.sort(keys, stable=True).indices
        rays = make_rays_c(tuple(x[perm] for x in rays["org"]),
                           tuple(x[perm] for x in rays["dir"]),
                           rays["tmin"][perm], rays["tmax"][perm])
    args = (rays["org"], rays["dir"], rays["inv_dir"], rays["inv_org"],
            rays["tmin"], rays["tmax"])
    if engine == "dense":
        hit = traverse_dense_components(scene["bvh"], *args,
                                        any_hit=any_hit)
    elif engine == "tiled":
        hit = traverse_components(scene["bvh"], *args, any_hit=any_hit,
                                  compact_stages=compact, sub_batches=sub)
    else:
        hit = traverse_packet_components(scene["bvh"], *args,
                                         any_hit=any_hit,
                                         prefetch=engine != "packet")
    if not sort:
        return hit
    out = {k: torch.empty_like(v) for k, v in hit.items()}
    for k, v in hit.items():
        out[k][perm] = v
    return out


def _i32(x):
    return x.contiguous().view(torch.int32)


def surface_element(scene, rays, hit):
    """make_tri_mesh_geometry's surface element (geometry.impala:21-54):
    one row gather from the pre-joined per-triangle shading table, or the
    4-gather path (tri row + 3 vertex rows) for scenes without it; both
    give the same values. The interpolated texture coordinates ("uv") are
    computed where the scene has a texture bank, the only place they are
    read (XLA drops them from the JAX package's untextured programs)."""
    prim = torch.clamp(hit["prim_id"], min=0).long()
    u, v = hit["u"], hit["v"]
    textured = "textures" in scene
    w = 1.0 - u - v if textured else None
    uv = None
    if "tri_shade" in scene:
        ts = scene["tri_shade"][prim]                     # (B, 20)
        mat_id = _i32(ts[:, 0])
        face_n = (ts[:, 1], ts[:, 2], ts[:, 3])
        light_id = _i32(ts[:, 4])
        n0 = (ts[:, 5], ts[:, 6], ts[:, 7])
        n1 = (ts[:, 8], ts[:, 9], ts[:, 10])
        n2 = (ts[:, 11], ts[:, 12], ts[:, 13])
        normal = vm.normalize(vm.lerp2(n0, n1, n2, u, v))
        if textured:
            uv = (w * ts[:, 14] + u * ts[:, 16] + v * ts[:, 18],
                  w * ts[:, 15] + u * ts[:, 17] + v * ts[:, 19])
    else:
        tg = scene["tri_geo"][prim]                       # (B, 8)
        tgi = _i32(tg)
        mat_id = tgi[:, 3]
        face_n = (tg[:, 4], tg[:, 5], tg[:, 6])
        light_id = tgi[:, 7]
        vg = [scene["vtx_geo"][tgi[:, k].long()] for k in range(3)]
        normal = vm.normalize(vm.lerp2(
            (vg[0][:, 0], vg[0][:, 1], vg[0][:, 2]),
            (vg[1][:, 0], vg[1][:, 1], vg[1][:, 2]),
            (vg[2][:, 0], vg[2][:, 1], vg[2][:, 2]), u, v))
        if textured:
            uv = (w * vg[0][:, 3] + u * vg[1][:, 3] + v * vg[2][:, 3],
                  w * vg[0][:, 4] + u * vg[1][:, 4] + v * vg[2][:, 4])

    is_entering = vm.dot(rays["dir"], face_n) <= 0.0
    point = vm.add(rays["org"], vm.scale(rays["dir"], hit["t"]))
    face_normal = vm.where(is_entering, face_n, vm.neg(face_n))
    shade_n = vm.where(vm.dot(rays["dir"], normal) <= 0.0,
                       normal, vm.neg(normal))
    t_, b_, n_ = vm.onb(shade_n)
    surf = {
        "is_entering": is_entering,
        "point": point,
        "face_normal": face_normal,
        "t": t_, "b": b_, "n": n_,
        "mat_id": mat_id,
        "light_id": light_id,
    }
    if uv is not None:
        surf["uv"] = uv
    return surf


_MAT_KEYS = ("kind", "kd", "ks", "ns", "ni", "tf", "mix_k", "emissive")


def gather_material(scene, mat_id):
    """Per-ray material parameters from the scene's material table (the
    converter's per-material shader closures, converter.cpp:859-927, as
    data), with the kd/ks texture ids where the scene has a bank."""
    mt = scene["mat_table"]
    idx = mat_id.long()
    keys = _MAT_KEYS + (("kd_tex", "ks_tex") if "textures" in scene else ())
    out = {}
    for key in keys:
        c = mt[key][idx]
        out[key] = (c[:, 0], c[:, 1], c[:, 2]) if c.ndim == 2 else c
    return out


def _sample_bank(scene, tex_id, uv):
    """Per-ray texture-bank lookup, bilinear with the repeat border
    (integrator.py:239-272; render.texture's semantics, the blend written
    as vm.lerp). Texel indices are int64, so a bank of many large
    textures cannot overflow them; negative ids read texture 0 (mask the
    result)."""
    bank = scene["textures"]
    hw = scene["tex_hw"]
    T, HM, WM, _ = bank.shape
    flat = bank.reshape(T * HM * WM, 3)
    tid = torch.clamp(tex_id.long(), min=0)
    h = hw[:, 0][tid].long()
    w = hw[:, 1][tid].long()
    u = uv[0] - torch.floor(uv[0])
    v = uv[1] - torch.floor(uv[1])
    x = u * w.to(torch.float32)
    y = v * h.to(torch.float32)
    # the reference's corner convention (image.impala:65-84): x0 = trunc,
    # weight = frac; u - floor(u) may round to 1.0, the min() keeps it in
    x0 = torch.minimum(x.long(), w - 1)
    y0 = torch.minimum(y.long(), h - 1)
    fx = x - torch.floor(x)
    fy = y - torch.floor(y)
    x1 = torch.minimum(x0 + 1, w - 1)
    y1 = torch.minimum(y0 + 1, h - 1)

    def fetch(xi, yi):
        g = flat[tid * (HM * WM) + yi * WM + xi]
        return (g[:, 0], g[:, 1], g[:, 2])

    top = vm.lerp(fetch(x0, y0), fetch(x1, y0), fx)
    bot = vm.lerp(fetch(x0, y1), fetch(x1, y1), fx)
    return vm.lerp(top, bot, fy)


def _shade(scene, rays, hit, state, packet=True, sort=False,
           shadow_packet=None, compact=0, sub=0):
    """One shading stage: on_hit accumulation, NEE shadow rays, bounce
    sampling (integrator.py:297-409). Returns (next_rays, next_state).
    shadow_packet (default: packet) is the engine of the NEE shadow
    traversal alone; compact and sub configure it where it is the
    dual-queue engine (integrator.py:380-382)."""
    if shadow_packet is None:
        shadow_packet = packet
    alive = state["alive"] & (hit["prim_id"] >= 0)
    surf = surface_element(scene, rays, hit)
    mat = gather_material(scene, surf["mat_id"])
    textured = "textures" in scene
    ke_textured = textured and "ke_tex" in scene["lights"]
    if textured:
        # textured kd/ks replace the constants (converter.cpp:877-895)
        kd_t = _sample_bank(scene, mat["kd_tex"], surf["uv"])
        ks_t = _sample_bank(scene, mat["ks_tex"], surf["uv"])
        mat["kd"] = vm.where(mat["kd_tex"] >= 0, kd_t, mat["kd"])
        mat["ks"] = vm.where(mat["ks_tex"] >= 0, ks_t, mat["ks"])
    rnd = state["rnd"]
    out_dir = vm.neg(rays["dir"])
    num_lights = scene["num_lights"]
    pdf_lightpick = 1.0 / num_lights
    kinds = scene.get("mat_kinds")

    # ---- on_hit: emissive surface seen by the path ----
    emit = light_mod.emission(scene["lights"], surf["light_id"], out_dir)
    if ke_textured:
        # textured emission (converter.cpp:794-806): the radiance is the
        # Ke texture at the hit point's uv
        ket = emit["ke_tex"]
        emit["intensity"] = vm.where(
            (ket >= 0) & emit["valid"], _sample_bank(scene, ket, surf["uv"]),
            emit["intensity"])
    cos_o = vm.dot(out_dir, surf["n"])
    next_mis = state["mis"] * hit["t"] * hit["t"] / torch.where(
        cos_o != 0.0, cos_o, 1.0)
    mis_w = 1.0 / (1.0 + next_mis * pdf_lightpick * emit["pdf_area"])
    hit_light = alive & mat["emissive"] & surf["is_entering"]
    emit_color = vm.scale(vm.mul(state["contrib"], emit["intensity"]),
                          mis_w)
    zero3 = vm.splat((0.0, 0.0, 0.0), like=mis_w)
    acc = vm.add(state["acc"], vm.where(hit_light, emit_color, zero3))

    # ---- on_shadow: next-event estimation (skipped for specular) ----
    do_nee = alive & ~bsdf_mod.is_specular(mat)
    lidx, rnd = light_mod.pick_uniform(num_lights, rnd)
    ls, rnd = light_mod.sample_direct(scene["lights"], lidx, rnd,
                                      surf["point"])
    if ke_textured:
        ket = ls["ke_tex"]
        ls["intensity"] = vm.where(
            (ket >= 0) & ls["valid"], _sample_bank(scene, ket, ls["uv"]),
            ls["intensity"])
    light_vec = vm.sub(ls["pos"], surf["point"])
    vis = vm.dot(light_vec, surf["n"])
    nee_ok = do_nee & (vis > 0.0) & (ls["cos"] > 0.0)
    inv_d = 1.0 / torch.clamp(vm.length(light_vec), min=1e-30)
    inv_d2 = inv_d * inv_d
    in_dir = vm.scale(light_vec, inv_d)
    pdf_e_c, pdf_e = bsdf_mod.eval_pdf(mat, surf, in_dir, out_dir,
                                       kinds=kinds)
    pdf_e = torch.where(ls["has_area"], pdf_e, 0.0)
    pdf_l = ls["pdf_area"] * pdf_lightpick
    inv_pdf_l = 1.0 / pdf_l
    cos_e = vis * inv_d
    cos_l = ls["cos"]
    mis = torch.where(ls["has_area"],
                      1.0 / (1.0 + pdf_e * cos_l * inv_d2 * inv_pdf_l), 1.0)
    geom = cos_e * cos_l * inv_d2 * inv_pdf_l
    shadow_color = vm.scale(
        vm.mul(vm.mul(ls["intensity"], state["contrib"]), pdf_e_c),
        geom * mis)

    off = torch.full_like(vis, OFFSET)
    shadow_rays = make_rays_c(surf["point"], light_vec, off,
                              torch.where(nee_ok, 1.0 - OFFSET, -1.0))
    shadow_hit = _traverse(scene, shadow_rays, any_hit=True,
                           packet=shadow_packet, sort=sort, compact=compact,
                           sub=sub)
    add_shadow = nee_ok & (shadow_hit["prim_id"] < 0)
    acc = vm.add(acc, vm.where(add_shadow, shadow_color, zero3))

    # ---- on_bounce: russian roulette + BSDF sampling ----
    rr = torch.clamp(2.0 * vm.luminance(state["contrib"]), max=0.75)
    u_rr, rnd = randf(rnd)
    continue_ = alive & (state["depth"] < scene["max_path_len"]) & (u_rr < rr)
    new_dir, pdf, cos, color, rnd = bsdf_mod.sample(
        mat, surf, rnd, out_dir, kinds=kinds)
    spec = bsdf_mod.is_specular(mat)
    contrib = vm.scale(vm.mul(state["contrib"], color),
                       cos / torch.clamp(pdf * rr, min=1e-30))
    new_mis = torch.where(spec, 0.0, 1.0 / torch.clamp(pdf, min=1e-30))

    next_rays = make_rays_c(surf["point"], new_dir, off,
                            torch.where(continue_, FLT_MAX, -1.0))
    next_state = {
        "rnd": rnd,
        "contrib": vm.where(continue_, contrib, zero3),
        "mis": new_mis,
        "depth": state["depth"] + 1,
        "alive": continue_,
        "acc": acc,
    }
    return next_rays, next_state


def _emit_camera(camera, width, height, sample, iteration, pix):
    """make_camera_emitter (renderer.impala:26-40): FNV-seeded RNG, pixel
    jitter, pinhole direction. pix: (B,) int64 pixel ids."""
    x = pix % width
    y = pix // width
    rnd = seed_camera_rays(sample, iteration, x, y)
    jx, rnd = randf(rnd)
    jy, rnd = randf(rnd)
    kx = 2.0 * (x.to(torch.float32) + jx) / width - 1.0
    ky = 1.0 - 2.0 * (y.to(torch.float32) + jy) / height
    right = vm.splat(camera.right, like=kx)
    up = vm.splat(camera.up, like=kx)
    d = vm.splat(camera.dir, like=kx)
    raydir = vm.normalize(vm.add(vm.add(vm.scale(right, camera.w * kx),
                                        vm.scale(up, camera.h * ky)), d))
    org = vm.splat(camera.eye, like=kx)
    return org, raydir, rnd


def render_sample(scene, camera, film, width, height, sample, iteration,
                  pixel_ids=None, packet=True, sort=False, stats=None):
    """Traces one sample per pixel to completion (one wavefront pass) and
    returns film + the pass's radiance (integrator.py:432-500). pixel_ids
    (default: every pixel) index the global image, so the camera rays and
    their RNG streams are those of the whole-image render; a film of the
    same length as pixel_ids is taken as their own strip (row i for
    pixel_ids[i], parallel.mesh), any other film is indexed by the global
    ids (scatter-added, in order). packet
    picks the traversal engine of every depth (_engine): True K1, "hbm"/
    "giga" K2, False the dual-queue engine, "dense" the dense engine; the
    hybrid tiers run their full-packet flavour for every depth, where the
    JAX renderer peels depth 0 onto its packet kernel and traces the
    bounces on the dual-queue engine. sort="pool" exists only in the
    persistent renderer and means sort=True here. The bounce loop runs
    until no path is alive; stats, a dict, counts the bounces under
    "bounces"."""
    sort = sort in (True, "pool")
    device = film.device
    if pixel_ids is None:
        pix = torch.arange(width * height, dtype=torch.int64, device=device)
    else:
        pix = pixel_ids.to(device=device, dtype=torch.int64)
    n = pix.shape[0]
    org, d, rnd = _emit_camera(camera, width, height, sample, iteration,
                               pix)
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    rays = make_rays_c(org, d, zeros, torch.full_like(zeros, FLT_MAX))
    state = {
        "rnd": rnd,
        "contrib": (ones, ones, ones),
        "mis": zeros,
        "depth": torch.zeros(n, dtype=torch.int32, device=device),
        "alive": torch.ones(n, dtype=torch.bool, device=device),
        "acc": (zeros, zeros, zeros),
    }
    while bool(state["alive"].any()):      # one host sync per bounce
        hit = _traverse(scene, rays, packet=packet, sort=sort)
        rays, state = _shade(scene, rays, hit, state, packet=packet,
                             sort=sort)
        if stats is not None:
            stats["bounces"] = stats.get("bounces", 0) + 1
    rows = torch.stack(state["acc"], dim=-1)
    if film.shape[0] == n:
        return film + rows
    film = film.clone()
    _index_add_in_order(film, pix, rows)
    return film


def render_debug(scene, camera, film, width, height, iteration,
                 packet=True):
    """Eye-light debug renderer (integrator.py:505-526,
    make_debug_renderer, renderer.impala:42-60): one camera pass, no NEE
    or bounces, accumulates white * -dot(ray.dir, shading normal); spp is
    1 as in the reference."""
    device = film.device
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=device)
    org, d, _ = _emit_camera(camera, width, height, 0, iteration, pix)
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    rays = make_rays_c(org, d, zeros, torch.full_like(zeros, FLT_MAX))
    hit = _traverse(scene, rays, packet=packet)
    surf = surface_element(scene, rays, hit)
    shade = torch.clamp(-vm.dot(rays["dir"], surf["n"]), min=0.0)
    shade = torch.where(hit["prim_id"] >= 0, shade, 0.0)
    return film + torch.stack((shade, shade, shade), dim=-1)


def render_iteration(scene, camera, film, width, height, spp, iteration,
                     packet=True, sort=False, stats=None):
    """One progressive iteration (integrator.py:532-543): spp wavefront
    passes summed into zeros, then film + delta * (1/spp), so the film
    holds per-iteration means and the tonemapper divides by the iteration
    count alone (mapping_cpu.impala:365-370, driver.cpp:145-162)."""
    delta = torch.zeros_like(film)
    for s in range(spp):
        delta = render_sample(scene, camera, delta, width, height, s,
                              iteration, packet=packet, sort=sort,
                              stats=stats)
    return film + delta * (1.0 / spp)


def _index_add_in_order(plane, idx, val):
    """plane[idx[j]] += val[j], summed in the order of j. On the CPU
    index_put_(accumulate=True) runs serially in that order; on a CUDA
    card it uses atomics unless deterministic algorithms are on, and then
    sorts the indices stably and adds each run of equal indices in order,
    so a film does not change in its last bits from run to run."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        plane.index_put_((idx,), val, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn_only)


def _splat_planar(planes, slot, color, mask):
    """Writes a Vec3 into the rows `slot` of a component-planar sample
    buffer (3 x (S + 1,) tensors, updated in place; the splat of
    integrator.py:284-294, one row per sample instead of a scatter-add per
    pixel). Masked-off rays write to the last row, which no sample owns, so
    no index has to be compacted on the host; every other row is written
    by one ray at most."""
    spare = planes[0].shape[0] - 1
    idx = torch.where(mask, slot, spare)
    for p, c in zip(planes, color):
        p.index_put_((idx,), c)


def render_iteration_persistent(scene, camera, film, width, height, spp,
                                iteration, pool=None, packet=True,
                                pixel_lo=0, n_pixels=None, sample_lo=0,
                                spp_weight=None, sort=False, compact=0,
                                sub=0, retire_every=1, bounce_packet=None,
                                shadow_packet=None, depth_split=False,
                                return_steps=False):
    """Persistent-wavefront iteration (integrator.py:552-834): the
    reference's megakernel regeneration (gpu_mega_kernel_trace,
    mapping_gpu.impala:371-474). A pool of `pool` ray slots (default
    min(total, 32768)) processes all n_pixels * spp samples of the
    iteration; when a path ends, its radiance is written to its sample's
    row of a buffer and its slot is re-emitted with the next unprocessed
    sample id. At the end each pixel adds its samples' rows to the film in
    sample order (film + s0 + s1 + ...). RNG seeds depend only on (sample,
    iteration, x, y), and the order of the additions does not depend on
    when paths end, so the film does not change in a single bit with the
    pool, retire_every, the sort or the engine. (The JAX package
    scatter-adds each dead slot into its pixel, in the order the paths
    end; its film matches this one to the last bits of a float sum.)

    The JAX while_loop is a Python loop that reads one boolean per step
    (any slot alive, or samples left); lax.cond is a Python `if`, which
    with retire_every > 1 reads a second boolean on the steps between
    retirements. The retirement follows the JAX order exactly: splat the
    dead slots, zero their radiance, number them by a cumsum in slot
    order, re-emit those whose new id is below the total, and under
    sort="pool" reorder the whole pool by the stable sort of the
    post-regeneration ray keys (dead slots last). The flat pool has no
    padding slots, so the JAX package's carried real-slot mask is not
    needed.

    packet / bounce_packet / shadow_packet pick the engine of the whole
    pool's traversal, of the bounce rays and of the NEE shadow rays (see
    _engine: K1, K2, the dual-queue engine with packet=False, the dense
    engine with "dense"); depth_split traces the depth-0 rays on `packet`
    and the rest on `bounce_packet`. compact (staged row compaction) and
    sub (sequential sub-batches) configure the dual-queue traversals of
    the bounce and shadow rays. pixel_lo / n_pixels restrict the pass to a
    strip of the image, sample_lo offsets the sample ids and spp_weight
    overrides the 1/spp film weight (the sharding hooks); a film of
    n_pixels rows is taken as the strip's own. Returns the film, and with
    return_steps=True (film, steps)."""
    packet = _HYBRID.get(packet, packet)
    bounce_packet = packet if bounce_packet is None else bounce_packet
    shadow_packet = packet if shadow_packet is None else shadow_packet
    for p in (packet, bounce_packet, shadow_packet):
        _engine(p)                     # refuse unknown engines up front
    depth_split = depth_split and bounce_packet != packet
    device = film.device
    n_pixels = n_pixels or width * height
    total = n_pixels * spp
    weight = spp_weight if spp_weight is not None else (1.0 / spp)
    local_film = film.shape[0] == n_pixels
    pool = pool or min(total, 1 << 15)
    pool_sort = sort == "pool" and "scene_lo" in scene
    call_sort = sort is True

    def emit_rays(sample_id):
        pix = pixel_lo + torch.clamp(sample_id // spp, max=n_pixels - 1)
        s = sample_lo + sample_id % spp
        return _emit_camera(camera, width, height, s, iteration, pix)

    sample_id = torch.arange(pool, dtype=torch.int64, device=device)
    next_free = torch.tensor(pool, dtype=torch.int64, device=device)
    org, d, rnd = emit_rays(sample_id)
    live = sample_id < min(total, pool)
    # the sample each slot holds; `total` (the buffer's spare row) where it
    # holds none
    slot = torch.where(live, sample_id, total)
    zeros = torch.zeros(pool, dtype=torch.float32, device=device)
    ones = torch.ones(pool, dtype=torch.float32, device=device)
    rays = make_rays_c(org, d, zeros, torch.where(live, FLT_MAX, -1.0))
    state = {
        "rnd": rnd,
        "contrib": (ones, ones, ones),
        "mis": zeros,
        "depth": torch.zeros(pool, dtype=torch.int32, device=device),
        "alive": live,
        "acc": (zeros, zeros, zeros),
    }
    zero3 = (zeros, zeros, zeros)
    ones3 = (ones, ones, ones)
    # each sample's radiance, one row per sample id and a spare row, as 3
    # component planes (written in place)
    samples = tuple(torch.zeros(total + 1, dtype=torch.float32,
                                device=device) for _ in range(3))

    def retire(rays, state, slot, next_free):
        dead = ~state["alive"]
        _splat_planar(samples, slot, vm.scale(state["acc"], weight), dead)
        state = dict(state, acc=vm.where(dead, zero3, state["acc"]))
        dead_i = dead.to(torch.int64)
        new_id = next_free + torch.cumsum(dead_i, 0) - 1
        can = dead & (new_id < total)
        slot = torch.where(can, new_id, torch.where(dead, total, slot))
        next_free = torch.clamp(next_free + dead_i.sum(), max=total)
        norg, nd, nrnd = emit_rays(torch.where(can, new_id, 0))
        fresh = make_rays_c(norg, nd, zeros, torch.full_like(zeros, FLT_MAX))
        rays = {k: (vm.where(can, fresh[k], rays[k])
                    if isinstance(rays[k], tuple)
                    else torch.where(can, fresh[k], rays[k]))
                for k in rays}
        state = {
            "rnd": torch.where(can, nrnd, state["rnd"]),
            "contrib": vm.where(can, ones3, state["contrib"]),
            "mis": torch.where(can, 0.0, state["mis"]),
            "depth": torch.where(can, 0, state["depth"]),
            "alive": state["alive"] | can,
            "acc": state["acc"],     # zeroed above for retired slots
        }
        if pool_sort:
            # reorder the pool by the post-regeneration rays' keys so the
            # next steps' bounce and shadow traversals see coherent warps;
            # slot identity carries (acc, sample): the film is unchanged
            keys = ray_sort_keys(rays["org"], rays["dir"],
                                 scene["scene_lo"], scene["scene_hi"])
            if depth_split:
                keys = (keys >> 1) | torch.where(state["depth"] == 0, 0,
                                                 0x80000000)
            keys = torch.where(state["alive"], keys, _DEAD_KEY)
            perm = torch.sort(keys, stable=True).indices

            def gt(t):
                return tuple(x[perm] for x in t)
            rays = make_rays_c(gt(rays["org"]), gt(rays["dir"]),
                               rays["tmin"][perm], rays["tmax"][perm])
            state = {k: gt(v) if isinstance(v, tuple) else v[perm]
                     for k, v in state.items()}
            slot = slot[perm]
        return rays, state, slot, next_free

    step = 0
    while bool(state["alive"].any() | (next_free < total)):  # host read
        if depth_split:
            # depth-0 camera rays on `packet`, the bounce depths on
            # `bounce_packet`; each traversal sees the other's rays dead
            d0 = state["depth"] == 0
            h0 = _traverse(scene, dict(rays, tmax=torch.where(
                d0, rays["tmax"], -1.0)), packet=packet, sort=call_sort)
            hb = _traverse(scene, dict(rays, tmax=torch.where(
                d0, -1.0, rays["tmax"])), packet=bounce_packet,
                sort=call_sort, compact=compact, sub=sub)
            hit = {k: torch.where(d0, h0[k], hb[k]) for k in h0}
        else:
            hit = _traverse(scene, rays, packet=bounce_packet,
                            sort=call_sort, compact=compact, sub=sub)
        rays, state = _shade(scene, rays, hit, state, packet=packet,
                             sort=call_sort, shadow_packet=shadow_packet,
                             compact=compact, sub=sub)
        step += 1
        # deferred retirement: every retire_every-th step, or whenever no
        # slot is alive (else the loop could spin with samples pending)
        if (retire_every == 1 or step % retire_every == 0
                or not bool(state["alive"].any())):
            rays, state, slot, next_free = retire(rays, state, slot,
                                                  next_free)
    # slots that ran out of samples never reached a retirement's splat
    _splat_planar(samples, slot, vm.scale(state["acc"], weight),
                  torch.ones_like(state["alive"]))
    # each pixel adds its samples in sample order; the film rides as 3
    # component planes
    lo = 0 if local_film else pixel_lo
    planes = []
    for i, plane in enumerate(samples):
        p = film[:, i].clone(memory_format=torch.contiguous_format)
        rows = plane[:total].view(n_pixels, spp)
        for k in range(spp):
            p[lo:lo + n_pixels] += rows[:, k]
        planes.append(p)
    film = torch.stack(planes, dim=-1)
    if return_steps:
        return film, step
    return film
