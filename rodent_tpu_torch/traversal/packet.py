"""BVH traversal through the hand-written CUDA kernels of
csrc/bvh_traverse.cu: the counterpart of
rodent_tpu/traversal/pallas_packet.py.

  K1 bvh_traverse           the traversal (_kernel_ct / _kernel_multi)
  K2 bvh_traverse_prefetch  K1 plus the exact next-pop L2 prefetch
                            (_pf_helpers and the tris_hbm / nodes_hbm
                            transport): prefetch=True
  K3 bvh_traverse_count     K1 plus per-ray pop counters (_kernel's
                            count_pops): count_pops=True

Contract (pallas_packet.py:1394-1459): rays in as flat (B,) components,
{t, u, v, prim_id, geom_id} out; a ray with tmax < tmin is dead; on a miss
t = tmax and prim_id = geom_id = -1. K2 returns K1's hits bit for bit; K3
adds "pops" and "leaf_pops", (B,) int32 per ray.

The device of the tensors decides the route and nothing else: CUDA
tensors launch the variant's kernel (or raise), CPU tensors take the plain
torch version (api.traverse_components, which follows K1's rules exactly
and counts the same pops). The TPU tuning knobs of the Pallas wrapper
(tile_rows, multi, carry_top, select, fma_slab, tris_hbm, nodes_hbm,
interpret, pops, ...) have no meaning for a one-thread-per-ray kernel and
are not accepted.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels.build import load_library
from .api import components, stack_entries, traverse_components

ARITIES = (2, 4, 8)
PACKETS = (1, 4, 8, 16, 24)
STACK_CAPS = (64, 128)   # the kernels' compile-time per-thread stack sizes
# K2 and K3 are built for these shapes only (the builds that use them)
WIDE_ARITY = 8
WIDE_PACKETS = (4, 8, 16, 24)

# launches per kernel since the last reset_launches(); raised by one where
# the kernel is launched and nowhere else
launches = {"bvh_traverse": 0, "bvh_traverse_prefetch": 0,
            "bvh_traverse_count": 0}

_ENTRY = {"bvh_traverse": "rt_bvh_traverse",
          "bvh_traverse_prefetch": "rt_bvh_traverse_prefetch",
          "bvh_traverse_count": "rt_bvh_traverse_count"}


def reset_launches():
    for k in launches:
        launches[k] = 0


def stack_cap(dev):
    """The smallest compiled stack that holds this BVH's worst case."""
    need = stack_entries(dev)
    for cap in STACK_CAPS:
        if need <= cap:
            return cap
    raise ValueError(f"BVH needs {need} stack entries; the kernels hold at "
                     f"most {STACK_CAPS[-1]}")


def _launch(dev, comps, any_hit, kernel):
    """One of K1/K2/K3 on CUDA tensors. comps: the 11 (n,) ray components
    in the C entry's order (inv_dir xyz, org xyz, dir xyz, tmin, tmax)."""
    nodes, tris = dev["nodes"], dev["tris"]
    arity = nodes.shape[1] // 7
    m = tris.shape[1] // 14
    if arity not in ARITIES or nodes.shape[1] != 7 * arity:
        raise ValueError(f"{kernel}: unsupported node row width "
                         f"{nodes.shape[1]}")
    if m not in PACKETS or tris.shape[1] != 14 * m:
        raise ValueError(f"{kernel}: unsupported Tri row width "
                         f"{tris.shape[1]}")
    if kernel != "bvh_traverse" and (arity != WIDE_ARITY
                                     or m not in WIDE_PACKETS):
        raise ValueError(f"{kernel} is built for BVH{WIDE_ARITY} with Tri-M "
                         f"rows, M in {WIDE_PACKETS}; got BVH{arity}, "
                         f"Tri{m}")
    cap = stack_cap(dev)
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

    def empty(dtype):
        return torch.empty(n, dtype=dtype, device=device)

    out = {"t": empty(torch.float32), "u": empty(torch.float32),
           "v": empty(torch.float32), "prim_id": empty(torch.int32),
           "geom_id": empty(torch.int32)}
    extra = []
    if kernel == "bvh_traverse_count":
        out["pops"] = empty(torch.int32)
        out["leaf_pops"] = empty(torch.int32)
        extra = [out["pops"].data_ptr(), out["leaf_pops"].data_ptr()]
    if n == 0:
        return out
    fn = getattr(load_library(), _ENTRY[kernel])
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
                               count_pops=False):
    """Component-level traversal: Vec3 tuples of (B,) tensors in, hit dict
    of (B,) tensors out. prefetch=True takes K2, count_pops=True takes K3
    (and adds "pops"/"leaf_pops"); the two exclude each other. inv_o
    belongs to the contract but is not read: the kernels slab-test in the
    NaN-free (bound - org) * inv_dir form."""
    del inv_o
    if prefetch and count_pops:
        raise ValueError("traverse_packet: prefetch and count_pops are two "
                         "different kernels; ask for one")
    if tmin.device.type == "cuda":
        kernel = ("bvh_traverse_prefetch" if prefetch else
                  "bvh_traverse_count" if count_pops else "bvh_traverse")
        return _launch(dev, [*inv_d, *org, *dirv, tmin, tmax], any_hit,
                       kernel)
    if tmin.device.type == "cpu":
        return traverse_components(dev, org, dirv, inv_d, tmin, tmax,
                                   any_hit=any_hit, count_pops=count_pops)
    raise ValueError(f"traverse_packet: unsupported device {tmin.device}")


def traverse_packet(dev, rays, any_hit=False, prefetch=False,
                    count_pops=False):
    """traverse_packet_components over a make_rays dict ((B, 3) org/dir)."""
    return traverse_packet_components(dev, *components(rays),
                                      any_hit=any_hit, prefetch=prefetch,
                                      count_pops=count_pops)
