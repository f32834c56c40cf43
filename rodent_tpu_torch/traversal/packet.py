"""BVH traversal through the hand-written CUDA kernels of
csrc/bvh_traverse.cu and csrc/bvh_ct.cu: the counterpart of
rodent_tpu/traversal/pallas_packet.py.

  K1 bvh_traverse           the traversal in the legacy order
                            (_kernel_multi, the JAX renderers' body):
                            hit children sorted and pushed far-to-near
  K2 bvh_traverse_prefetch  K1 plus the exact next-pop L2 prefetch
                            (_pf_helpers and the tris_hbm / nodes_hbm
                            transport): prefetch=True
  K3 bvh_traverse_count     K1 plus per-ray pop counters (_kernel's
                            count_pops): count_pops=True
  K4 bvh_traverse_option    K3 with one option of the legacy body _kernel
                            compiled in: ablate=("nonodetest",),
                            ("noleaftest",) or ("nosort",), pops=2,
                            leaf_chain=2 or 4, or row_loads=True (the
                            counterpart of scalar_reads); or with none,
                            base=True, the body each option is timed
                            against
  K5 bvh_traverse_tile      _kernel's own contract (csrc/bvh_tile.cu): a
                            tile of tile_rows * 128 rays walks the BVH
                            from ONE shared stack: tile_rows=1-32, with
                            frustum=True or ablate=("nopure",)
  K7 bvh_traverse_ct        the carry-top body _kernel_ct (csrc/bvh_ct.cu):
                            carry_top=True with select="fold" (the
                            default) or "sort" and fma_slab=True (the
                            default) or False, per-ray counters with
                            count_pops=True; BVH8 with Tri8/12/16/24 rows
  K7-PF bvh_traverse_ct_prefetch
                            K7 plus the exact next-pop L2 prefetch that
                            _kernel_ct runs with _pf_helpers in the HBM
                            modes (tris_hbm, and nodes_hbm, the giga tier:
                            on the card Tri rows only, as K2):
                            carry_top=True, prefetch=True

K6, bvh_traverse_pair (experiments/pallas_pair.py's tile stack of whole
nodes), has its wrapper in traversal/pair.py; its launches are counted here.

Contract (pallas_packet.py:1394-1459): rays in as flat (B,) components,
{t, u, v, prim_id, geom_id} out; a ray with tmax < tmin is dead; on a miss
t = tmax and prim_id = geom_id = -1. K2 returns K1's hits bit for bit; K3
adds "pops" and "leaf_pops", (B,) int32 per ray. K4 follows the option's
semantics (api.traverse_components), base and row_loads change no bit
of K3's output, and count_pops=True adds K4's counters, where a pops=2
ray whose stack would have overflowed reads -1 (without the counters,
that call raises). K5 follows api.traverse_tile_components; count_pops=True adds its
"pops" and "leaf_pops" per tile, (nt,) int32.

The device of the tensors decides the route and nothing else: CUDA
tensors launch the variant's kernel (or raise), CPU tensors take the plain
torch version (api.traverse_components, which follows the kernels' rules
exactly and counts the same pops; api.traverse_tile_components for
tile_rows=; api.traverse_ct_components for carry_top=True). The kernels
take one option at a time and none with prefetch, on either route.
tile_rows= (1, 2, 4, 8, 16 or 32) asks for the tile route, which alone
takes frustum=True and ablate "nopure" (api.check_options).

carry_top, select and fma_slab are the Pallas wrapper's, with its defaults
(False, "fold", True; select and fma_slab are read only with carry_top):
they are rules of a ray's traversal, not tile shapes, so they keep their
meaning for one ray per thread. Where the JAX wrapper silently runs the
legacy body instead of the carry-top one (frustum, pops > 1, ablate,
leaf_chain > 1: pallas_packet.py:1517-1520), the port raises, naming the
demotion; carry_top also refuses tile_rows=, row_loads and a select other
than "fold" or "sort". carry_top with prefetch=True is K7-PF, the JAX
wrapper's carry_top with tris_hbm (or nodes_hbm) and prefetch
(:1532-1536): one kernel for both TPU transports, since on the card every
table sits behind the L2 and the node table of a big scene stays there
(csrc/bvh_ct.cu). Its plain version is K7's, a prefetch moves no bit.
Where the JAX wrapper silently drops the prefetch, under count_pops
(:1537-1538), the port raises. The Pallas wrapper's other TPU knobs
(multi, tris_hbm, nodes_hbm, scalar_reads, interpret, ...) have no meaning
on the card and are not accepted.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels.build import load_library
from .api import (check_options, components, stack_entries,
                  traverse_components, traverse_ct_components,
                  traverse_tile_components)

ARITIES = (2, 4, 8)
PACKETS = (1, 4, 8, 12, 16, 24)
STACK_CAPS = (64, 128)   # the kernels' compile-time per-thread stack sizes
# K2 and K3 are built for these shapes only (the builds that use them)
WIDE_ARITY = 8
WIDE_PACKETS = (4, 8, 12, 16, 24)
# K4's options, in the order of csrc/bvh_traverse.cu (kNoNodeTest ...
# kBase), with the traverse_packet arguments that ask for each, and the
# Tri rows it is built for; "base" is K4 with no option
OPTION_ARGS = {"nonodetest": {"ablate": ("nonodetest",)},
               "noleaftest": {"ablate": ("noleaftest",)},
               "nosort": {"ablate": ("nosort",)},
               "pops2": {"pops": 2},
               "chain2": {"leaf_chain": 2},
               "chain4": {"leaf_chain": 4},
               "row_loads": {"row_loads": True},
               "base": {"base": True}}
OPTIONS = tuple(OPTION_ARGS)
OPTION_PACKETS = (8, 24)
POPS2_STACK_CAPS = (128, 256)

# K5's modes, in the order of csrc/bvh_tile.cu (kPlain, kFrustum, kNoPure),
# the Tri rows it is built for and its largest stack
TILE_MODES = ("plain", "frustum", "nopure")
TILE_PACKETS = (8, 24)
TILE_STACK_MAX = 256
# the warp schedule's largest stack for a frustum tile of 32 rows: the
# tile's rays in shared memory (212,992 B), a copy of the stack per warp
# (16 x 4 B an entry) and the frustum's row boxes (9,344 B) within the
# card's 232,448 B a block (csrc/bvh_tile.cu)
TILE_FRUSTUM_R32_STACK_MAX = 158
# K7 and K7-PF are built for BVH8 (WIDE_ARITY) with these Tri rows
CT_PACKETS = (8, 12, 16, 24)

# launches per kernel since the last reset_launches(); raised by one where
# the kernel is launched and nowhere else
launches = {"bvh_traverse": 0, "bvh_traverse_prefetch": 0,
            "bvh_traverse_count": 0, "bvh_traverse_option": 0,
            "bvh_traverse_tile": 0, "bvh_traverse_pair": 0,
            "bvh_traverse_ct": 0, "bvh_traverse_ct_prefetch": 0}

_ENTRY = {"bvh_traverse": "rt_bvh_traverse",
          "bvh_traverse_prefetch": "rt_bvh_traverse_prefetch",
          "bvh_traverse_count": "rt_bvh_traverse_count",
          "bvh_traverse_option": "rt_bvh_traverse_option"}


def reset_launches():
    for k in launches:
        launches[k] = 0


def call_on_card(device, fn, *args):
    """fn(*args, stream): a C entry called with `device` as the current
    CUDA device and that device's current stream as its last argument.
    The entries launch on the current device, which is not the tensors'
    card in a rank of a multi-card group unless it is set here. Returns
    fn's CUDA error code."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def stack_cap(dev, pops=1):
    """The smallest compiled stack that holds this BVH's worst case (for
    pops=2, K4's doubled bound)."""
    need = stack_entries(dev, pops)
    caps = POPS2_STACK_CAPS if pops == 2 else STACK_CAPS
    for cap in caps:
        if need <= cap:
            return cap
    raise ValueError(f"BVH needs {need} stack entries; the kernels hold at "
                     f"most {caps[-1]}")


def option_name(ablate=(), pops=1, leaf_chain=1, row_loads=False,
                base=False):
    """The K4 option these arguments ask for (an entry of OPTIONS), or None
    for none (K1-K3); base=True asks for K4 with no option, "base". The
    arguments must already pass api.check_options."""
    picked = list(ablate)
    if pops == 2:
        picked.append("pops2")
    if leaf_chain != 1:
        picked.append(f"chain{leaf_chain}")
    if row_loads:
        picked.append("row_loads")
    if base:
        picked.append("base")
    if len(picked) > 1:
        raise ValueError(f"traverse_packet: options {picked} at once; the "
                         "kernels take one at a time")
    return picked[0] if picked else None


def check_inputs(kernel, comps, nodes, tris):
    """Raises unless the tables and the 11 ray components are contiguous
    float32 on one device and the components share one shape (n,); returns
    n."""
    n = comps[-1].shape[0]
    device = nodes.device
    for x in [*comps, nodes, tris]:
        if x.device != device or x.dtype != torch.float32:
            raise ValueError(f"{kernel}: every input must be float32 on "
                             f"{device}, got {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: inputs must be contiguous")
    for x in comps:
        if x.shape != (n,):
            raise ValueError(f"{kernel}: ray component of shape "
                             f"{tuple(x.shape)}, expected ({n},)")
    return n


def _launch(dev, comps, any_hit, kernel, option=None, lib=None):
    """One of K1-K4 on CUDA tensors. comps: the 11 (n,) ray components in
    the C entry's order (inv_dir xyz, org xyz, dir xyz, tmin, tmax);
    option: K4's entry of OPTIONS. lib: another build of the kernel's
    library to launch instead of this package's
    (experiments.ablate_packet --against times another checkout's K4);
    its launches are not counted."""
    nodes, tris = dev["nodes"], dev["tris"]
    arity = nodes.shape[1] // 7
    m = tris.shape[1] // 14
    if arity not in ARITIES or nodes.shape[1] != 7 * arity:
        raise ValueError(f"{kernel}: unsupported node row width "
                         f"{nodes.shape[1]}")
    if m not in PACKETS or tris.shape[1] != 14 * m:
        raise ValueError(f"{kernel}: unsupported Tri row width "
                         f"{tris.shape[1]}")
    packets = OPTION_PACKETS if option else WIDE_PACKETS
    if kernel != "bvh_traverse" and (arity != WIDE_ARITY
                                     or m not in packets):
        raise ValueError(f"{kernel} is built for BVH{WIDE_ARITY} with Tri-M "
                         f"rows, M in {packets}; got BVH{arity}, Tri{m}")
    cap = stack_cap(dev, 2 if option == "pops2" else 1)
    n = check_inputs(kernel, comps, nodes, tris)
    device = nodes.device
    if option == "row_loads" and (nodes.data_ptr() % 16
                                  or tris.data_ptr() % 16):
        raise ValueError(f"{kernel}: row_loads needs 16-byte aligned "
                         "node and Tri tables")

    def empty(dtype):
        return torch.empty(n, dtype=dtype, device=device)

    out = {"t": empty(torch.float32), "u": empty(torch.float32),
           "v": empty(torch.float32), "prim_id": empty(torch.int32),
           "geom_id": empty(torch.int32)}
    extra = []
    if kernel in ("bvh_traverse_count", "bvh_traverse_option"):
        out["pops"] = empty(torch.int32)
        out["leaf_pops"] = empty(torch.int32)
        extra = [out["pops"].data_ptr(), out["leaf_pops"].data_ptr()]
    if option:
        extra.append(OPTIONS.index(option))
    if n == 0:
        return out
    own = lib is None
    if own:
        lib = load_library(kind="options" if option else "main")
    fn = getattr(lib, _ENTRY[kernel])
    ptrs = (ctypes.c_void_p * 11)(*(x.data_ptr() for x in comps))
    err = call_on_card(
        device, fn, nodes.data_ptr(), tris.data_ptr(), ptrs, n, arity, m,
        int(bool(any_hit)), cap,
        *(out[k].data_ptr() for k in ("t", "u", "v", "prim_id", "geom_id")),
        *extra)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")
    if own:
        launches[kernel] += 1
    return out


def _launch_ct(dev, comps, any_hit, count_pops, select, fma_slab,
               prefetch=False, lib=None):
    """K7, or K7-PF with prefetch (without counters), on CUDA tensors;
    comps as in _launch. Returns the hits, and with count_pops the per-ray
    "pops" and "leaf_pops". lib: another build of the "ct" library to
    launch instead of this package's (experiments.measure_ct --against
    times another checkout's body); its launches are not counted."""
    kernel = "bvh_traverse_ct_prefetch" if prefetch else "bvh_traverse_ct"
    if prefetch and count_pops:
        raise ValueError(f"{kernel} has no counters")
    nodes, tris = dev["nodes"], dev["tris"]
    arity = nodes.shape[1] // 7
    m = tris.shape[1] // 14
    if nodes.shape[1] != 7 * WIDE_ARITY or m not in CT_PACKETS or \
            tris.shape[1] != 14 * m:
        raise ValueError(f"{kernel} is built for BVH{WIDE_ARITY} with Tri-M "
                         f"rows, M in {CT_PACKETS}; got BVH{arity}, Tri{m}")
    cap = stack_cap(dev)
    n = check_inputs(kernel, comps, nodes, tris)
    device = nodes.device
    if nodes.data_ptr() % 16 or tris.data_ptr() % 16:
        raise ValueError(f"{kernel} reads rows in 16-byte loads: the node "
                         "and Tri tables must be 16-byte aligned")

    def empty(dtype):
        return torch.empty(n, dtype=dtype, device=device)

    out = {"t": empty(torch.float32), "u": empty(torch.float32),
           "v": empty(torch.float32), "prim_id": empty(torch.int32),
           "geom_id": empty(torch.int32)}
    counters = [None, None]
    if count_pops:
        out["pops"] = empty(torch.int32)
        out["leaf_pops"] = empty(torch.int32)
        counters = [out["pops"].data_ptr(), out["leaf_pops"].data_ptr()]
    if n == 0:
        return out
    own = lib is None
    if own:
        lib = load_library(kind="ct")
    ptrs = (ctypes.c_void_p * 11)(*(x.data_ptr() for x in comps))
    err = call_on_card(
        device, lib.rt_bvh_traverse_ct, nodes.data_ptr(), tris.data_ptr(),
        ptrs, n, arity, m, int(bool(any_hit)), cap,
        *(out[k].data_ptr() for k in ("t", "u", "v", "prim_id", "geom_id")),
        *counters, int(select == "sort" and not any_hit),
        int(bool(fma_slab)), int(bool(prefetch)))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")
    if own:
        launches[kernel] += 1
    return out


def _traverse_ct(dev, org, dirv, inv_d, tmin, tmax, any_hit, count_pops,
                 select, fma_slab, prefetch=False):
    """The carry-top route of traverse_packet_components: K7 (K7-PF with
    prefetch) on CUDA tensors, its plain version on CPU tensors."""
    if tmin.device.type == "cuda":
        return _launch_ct(dev, [*inv_d, *org, *dirv, tmin, tmax], any_hit,
                          count_pops, select, fma_slab, prefetch)
    if tmin.device.type == "cpu":
        return traverse_ct_components(dev, org, dirv, inv_d, tmin, tmax,
                                      any_hit, count_pops, select=select,
                                      fma_slab=fma_slab)
    raise ValueError(f"traverse_packet: unsupported device {tmin.device}")


def tile_mode(frustum=False, ablate=()):
    """K5's entry of TILE_MODES for these (checked) tile options."""
    return ("frustum" if frustum else
            "nopure" if "nopure" in ablate else "plain")


def _launch_tile(dev, comps, any_hit, tile_rows, mode, cap=None):
    """K5 on CUDA tensors; comps as in _launch. Returns
    the hits and the per-tile "pops" and "leaf_pops"; a tile whose stack
    would have overflowed (never within BvhMeta's worst case, the stack
    it gets unless `cap` entries are asked for) stops with pops -1."""
    nodes, tris = dev["nodes"], dev["tris"]
    arity = nodes.shape[1] // 7
    m = tris.shape[1] // 14
    if nodes.shape[1] != 56 or m not in TILE_PACKETS or \
            tris.shape[1] != 14 * m:
        raise ValueError(f"bvh_traverse_tile is built for BVH8 with Tri-M "
                         f"rows, M in {TILE_PACKETS}; got BVH{arity}, "
                         f"Tri{m}")
    cap = stack_entries(dev) if cap is None else cap
    if not 1 <= cap <= TILE_STACK_MAX:
        raise ValueError(f"a stack of {cap} entries: bvh_traverse_tile "
                         f"holds 1 to {TILE_STACK_MAX}")
    if (tile_rows == 32 and mode == "frustum"
            and cap > TILE_FRUSTUM_R32_STACK_MAX):
        raise ValueError(f"a stack of {cap} entries: bvh_traverse_tile's "
                         f"frustum mode at tile_rows 32 holds at most "
                         f"{TILE_FRUSTUM_R32_STACK_MAX} in shared memory "
                         f"beside the tile's rays")
    n = check_inputs("bvh_traverse_tile", comps, nodes, tris)
    nt = -(-n // (128 * tile_rows))
    device = nodes.device

    def empty(dtype, size=n):
        return torch.empty(size, dtype=dtype, device=device)

    out = {"t": empty(torch.float32), "u": empty(torch.float32),
           "v": empty(torch.float32), "prim_id": empty(torch.int32),
           "geom_id": empty(torch.int32), "pops": empty(torch.int32, nt),
           "leaf_pops": empty(torch.int32, nt)}
    if n == 0:
        return out
    lib = load_library(kind="tile")
    ptrs = (ctypes.c_void_p * 11)(*(x.data_ptr() for x in comps))
    err = call_on_card(
        device, lib.rt_bvh_traverse_tile, nodes.data_ptr(), tris.data_ptr(),
        ptrs, n, m, int(bool(any_hit)), tile_rows, TILE_MODES.index(mode),
        cap, *(out[k].data_ptr() for k in ("t", "u", "v", "prim_id",
                                           "geom_id", "pops", "leaf_pops")))
    if err != 0:
        raise RuntimeError(f"bvh_traverse_tile launch failed with CUDA "
                           f"error {err}")
    launches["bvh_traverse_tile"] += 1
    return out


def _traverse_tile(dev, org, dirv, inv_d, tmin, tmax, any_hit, count_pops,
                   ablate, tile_rows, frustum):
    """The tile route of traverse_packet_components: K5 on CUDA tensors,
    its plain version on CPU tensors."""
    if tmin.device.type == "cuda":
        out = _launch_tile(dev, [*inv_d, *org, *dirv, tmin, tmax], any_hit,
                           tile_rows, tile_mode(frustum, ablate))
    elif tmin.device.type == "cpu":
        out = traverse_tile_components(dev, org, dirv, inv_d, tmin, tmax,
                                       any_hit, tile_rows, frustum, ablate)
    else:
        raise ValueError(f"traverse_packet: unsupported device "
                         f"{tmin.device}")
    if not count_pops:
        del out["pops"], out["leaf_pops"]
    return out


def traverse_packet_components(dev, org, dirv, inv_d, inv_o, tmin, tmax,
                               any_hit=False, prefetch=False,
                               count_pops=False, ablate=(), pops=1,
                               leaf_chain=1, row_loads=False, frustum=False,
                               tile_rows=None, carry_top=False,
                               select="fold", fma_slab=True, base=False):
    """Component-level traversal: Vec3 tuples of (B,) tensors in, hit dict
    of (B,) tensors out. prefetch=True takes K2, count_pops=True takes K3
    (and adds "pops"/"leaf_pops"); one of ablate, pops=2, leaf_chain=2/4
    or row_loads takes K4 (its counters with count_pops=True), and
    base=True K4 with no option, whose plain version is K3's. prefetch
    excludes the others. tile_rows= takes the tile route, K5, with
    frustum=True or ablate=("nopure",) at most, and per-tile counters with
    count_pops=True. carry_top=True takes K7 with its select and fma_slab,
    per-ray counters with count_pops=True, or K7-PF with prefetch=True
    (without counters), and none of the other options.
    inv_o belongs to the contract but is not read: the kernels slab-test
    in the NaN-free (bound - org) * inv_dir form, or K7's fused form from
    the clamped inverse."""
    del inv_o
    if carry_top:
        if row_loads or base:
            raise ValueError("traverse_packet: carry_top=True with "
                             f"{'row_loads' if row_loads else 'base'}: K4 "
                             "runs the legacy body, not the carry-top one; "
                             "ask for one")
        if prefetch and count_pops:
            raise ValueError("traverse_packet: carry_top=True with prefetch "
                             "and count_pops: the JAX wrapper drops the "
                             "prefetch under count_pops "
                             "(pallas_packet.py:1537-1538) and K7-PF has no "
                             "counters; ask for one")
        check_options(any_hit, ablate, pops, leaf_chain, frustum, tile_rows,
                      carry_top=True, select=select)
        return _traverse_ct(dev, org, dirv, inv_d, tmin, tmax, any_hit,
                            count_pops, select, fma_slab, prefetch)
    check_options(any_hit, select=select)
    if tile_rows is not None:
        if prefetch or row_loads or base:
            raise ValueError("traverse_packet: the tile route (tile_rows=) "
                             "has no prefetch, no row_loads and no base")
        ablate = check_options(any_hit, ablate, pops, leaf_chain, frustum,
                               tile_rows)
        return _traverse_tile(dev, org, dirv, inv_d, tmin, tmax, any_hit,
                              count_pops, ablate, tile_rows, frustum)
    ablate = check_options(any_hit, ablate, pops, leaf_chain, frustum)
    option = option_name(ablate, pops, leaf_chain, row_loads, base)
    if prefetch and (count_pops or option):
        raise ValueError("traverse_packet: prefetch and count_pops or an "
                         "option are different kernels; ask for one")
    if tmin.device.type == "cuda":
        kernel = ("bvh_traverse_option" if option else
                  "bvh_traverse_prefetch" if prefetch else
                  "bvh_traverse_count" if count_pops else "bvh_traverse")
        out = _launch(dev, [*inv_d, *org, *dirv, tmin, tmax], any_hit,
                      kernel, option)
        if option and not count_pops:
            # pops=2's doubled stack bound is not proven: K4 stops a ray
            # whose stack would overflow and marks its pops -1. A caller
            # that asked for the counters reads the mark; for the others
            # this one synchronising check raises where the plain version
            # would
            if option == "pops2" and bool((out["pops"] < 0).any()):
                raise ValueError(f"traversal stack of {stack_cap(dev, 2)} "
                                 "entries overflowed (pops=2)")
            del out["pops"], out["leaf_pops"]
        return out
    if tmin.device.type == "cpu":
        return traverse_components(dev, org, dirv, inv_d, tmin, tmax,
                                   any_hit=any_hit, count_pops=count_pops,
                                   ablate=ablate, pops=pops,
                                   leaf_chain=leaf_chain)
    raise ValueError(f"traverse_packet: unsupported device {tmin.device}")


def traverse_packet(dev, rays, any_hit=False, prefetch=False,
                    count_pops=False, **options):
    """traverse_packet_components over a make_rays dict ((B, 3) org/dir);
    options: ablate, pops, leaf_chain, row_loads, frustum, tile_rows,
    carry_top, select, fma_slab, base."""
    return traverse_packet_components(dev, *components(rays),
                                      any_hit=any_hit, prefetch=prefetch,
                                      count_pops=count_pops, **options)
