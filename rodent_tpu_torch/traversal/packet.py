"""BVH traversal through the hand-written CUDA kernels of
csrc/bvh_traverse.cu: the counterpart of
rodent_tpu/traversal/pallas_packet.py.

  K1 bvh_traverse           the traversal (_kernel_ct / _kernel_multi)
  K2 bvh_traverse_prefetch  K1 plus the exact next-pop L2 prefetch
                            (_pf_helpers and the tris_hbm / nodes_hbm
                            transport): prefetch=True
  K3 bvh_traverse_count     K1 plus per-ray pop counters (_kernel's
                            count_pops): count_pops=True
  K4 bvh_traverse_option    K3 with one option of the legacy body _kernel
                            compiled in: ablate=("nonodetest",),
                            ("noleaftest",) or ("nosort",), pops=2,
                            leaf_chain=2 or 4, or row_loads=True (the
                            counterpart of scalar_reads)

Contract (pallas_packet.py:1394-1459): rays in as flat (B,) components,
{t, u, v, prim_id, geom_id} out; a ray with tmax < tmin is dead; on a miss
t = tmax and prim_id = geom_id = -1. K2 returns K1's hits bit for bit; K3
adds "pops" and "leaf_pops", (B,) int32 per ray. K4 follows the option's
semantics (api.traverse_components), row_loads changes no bit of K3's
output, and count_pops=True adds K4's counters, where a pops=2 ray whose
stack would have overflowed reads -1 (without the counters, that call
raises).

The device of the tensors decides the route and nothing else: CUDA
tensors launch the variant's kernel (or raise), CPU tensors take the plain
torch version (api.traverse_components, which follows the kernels' rules
exactly and counts the same pops). The kernels take one option at a time
and none with prefetch, on either route. The Pallas wrapper's TPU tuning
knobs (tile_rows, multi, carry_top, select, fma_slab, tris_hbm, nodes_hbm,
interpret, ...) have no meaning for a one-thread-per-ray kernel and are not
accepted; frustum and ablate "nopure" raise (api.check_options).
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels.build import load_library
from .api import check_options, components, stack_entries, traverse_components

ARITIES = (2, 4, 8)
PACKETS = (1, 4, 8, 16, 24)
STACK_CAPS = (64, 128)   # the kernels' compile-time per-thread stack sizes
# K2 and K3 are built for these shapes only (the builds that use them)
WIDE_ARITY = 8
WIDE_PACKETS = (4, 8, 16, 24)
# K4's options, in the order of csrc/bvh_traverse.cu (kNoNodeTest ...
# kRowLoads), with the traverse_packet arguments that ask for each, and the
# Tri rows it is built for
OPTION_ARGS = {"nonodetest": {"ablate": ("nonodetest",)},
               "noleaftest": {"ablate": ("noleaftest",)},
               "nosort": {"ablate": ("nosort",)},
               "pops2": {"pops": 2},
               "chain2": {"leaf_chain": 2},
               "chain4": {"leaf_chain": 4},
               "row_loads": {"row_loads": True}}
OPTIONS = tuple(OPTION_ARGS)
OPTION_PACKETS = (8, 24)
POPS2_STACK_CAPS = (128, 256)

# launches per kernel since the last reset_launches(); raised by one where
# the kernel is launched and nowhere else
launches = {"bvh_traverse": 0, "bvh_traverse_prefetch": 0,
            "bvh_traverse_count": 0, "bvh_traverse_option": 0}

_ENTRY = {"bvh_traverse": "rt_bvh_traverse",
          "bvh_traverse_prefetch": "rt_bvh_traverse_prefetch",
          "bvh_traverse_count": "rt_bvh_traverse_count",
          "bvh_traverse_option": "rt_bvh_traverse_option"}


def reset_launches():
    for k in launches:
        launches[k] = 0


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


def option_name(ablate=(), pops=1, leaf_chain=1, row_loads=False):
    """The K4 option these arguments ask for (an entry of OPTIONS), or None
    for none; the arguments must already pass api.check_options."""
    picked = list(ablate)
    if pops == 2:
        picked.append("pops2")
    if leaf_chain != 1:
        picked.append(f"chain{leaf_chain}")
    if row_loads:
        picked.append("row_loads")
    if len(picked) > 1:
        raise ValueError(f"traverse_packet: options {picked} at once; the "
                         "kernels take one at a time")
    return picked[0] if picked else None


def _launch(dev, comps, any_hit, kernel, option=None):
    """One of K1-K4 on CUDA tensors. comps: the 11 (n,) ray components in
    the C entry's order (inv_dir xyz, org xyz, dir xyz, tmin, tmax);
    option: K4's entry of OPTIONS."""
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
    lib = load_library(kind="options" if option else "main")
    fn = getattr(lib, _ENTRY[kernel])
    ptrs = (ctypes.c_void_p * 11)(*(x.data_ptr() for x in comps))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(nodes.data_ptr(), tris.data_ptr(), ptrs, n, arity, m,
             int(bool(any_hit)), cap,
             out["t"].data_ptr(), out["u"].data_ptr(), out["v"].data_ptr(),
             out["prim_id"].data_ptr(), out["geom_id"].data_ptr(), *extra,
             stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")
    launches[kernel] += 1
    return out


def traverse_packet_components(dev, org, dirv, inv_d, inv_o, tmin, tmax,
                               any_hit=False, prefetch=False,
                               count_pops=False, ablate=(), pops=1,
                               leaf_chain=1, row_loads=False, frustum=False):
    """Component-level traversal: Vec3 tuples of (B,) tensors in, hit dict
    of (B,) tensors out. prefetch=True takes K2, count_pops=True takes K3
    (and adds "pops"/"leaf_pops"); one of ablate, pops=2, leaf_chain=2/4
    or row_loads takes K4 (its counters with count_pops=True). prefetch
    excludes the others. inv_o belongs to the contract but is not read:
    the kernels slab-test in the NaN-free (bound - org) * inv_dir form."""
    del inv_o
    ablate = check_options(any_hit, ablate, pops, leaf_chain, frustum)
    option = option_name(ablate, pops, leaf_chain, row_loads)
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
    options: ablate, pops, leaf_chain, row_loads, frustum."""
    return traverse_packet_components(dev, *components(rays),
                                      any_hit=any_hit, prefetch=prefetch,
                                      count_pops=count_pops, **options)
