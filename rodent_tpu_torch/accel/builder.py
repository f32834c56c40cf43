"""Host-side BVH construction (the native path of
rodent_tpu/accel/builder.py).

Reimplements the role of the reference's SplitBvhBuilder + MultiNode
collapse (src/driver/bvh.h:44-246) with the same output conventions
(BvhNTriMAdapter, src/driver/converter.cpp:97-260), in the C++ builder of
rodent_tpu_torch/native: a top-down SAH build (with spatial splits at
quality 1), collapsed into N-wide nodes by the slot-constrained DP of the
packet kernel's cost model, with the node/tri packet encoding of
accel.layout. The library is built at first use, and a failed build
raises: the port has no second builder (the JAX package's numpy builder
gives another tree).
"""
from __future__ import annotations

import numpy as np

from .layout import WideBvh


def build_bvh(vertices, indices, arity=8, packet=4, leaf_threshold=4,
              quality=1, leaf_cost=0.0):
    """Builds a WideBvh from a triangle soup.

    vertices: (V, 3) f32; indices: flat i32, 4 per tri (v0, v1, v2, mat) —
    the reference's index convention — or (T, 3) with geom_ids implied 0.
    quality=1 (default) builds an SBVH (sweep SAH + spatial splits +
    unsplitting, the reference SplitBvhBuilder tier,
    src/driver/bvh.h:102-539); quality=0 is the faster binned-SAH build for
    huge scenes. leaf_cost > 0 overrides the DP collapse's C_LEAF ratio
    (leaf-packet pop vs node pop, default 1.2): a larger value trades node
    pops for fewer, smaller-area leaf packets.
    """
    from .. import native
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    if indices.ndim == 1:
        idx4 = indices.reshape(-1, 4)
    elif indices.shape[1] == 4:
        idx4 = indices
    else:
        idx4 = np.concatenate(
            [indices[:, :3],
             np.zeros((len(indices), 1), np.int32)], axis=1)
    bounds, child, tv0, te1, te2, tn, pid, gid = native.bvh_build(
        vertices, idx4, arity=arity, packet=packet,
        leaf_threshold=leaf_threshold, quality=quality, leaf_cost=leaf_cost)
    return WideBvh(arity=arity, packet=packet, bounds=bounds, child=child,
                   tri_v0=tv0, tri_e1=te1, tri_e2=te2, tri_n=tn,
                   prim_id=pid, geom_id=gid)
