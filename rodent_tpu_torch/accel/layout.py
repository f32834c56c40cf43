"""Wide-BVH SoA container and conversions to/from the .bvh file layout
(copy of rodent_tpu/accel/layout.py).

The runtime layout mirrors the reference's NodeN/Tri4 records
(src/traversal/mapping_cpu.impala:3-22) as flat numpy arrays:

- bounds (num_nodes, 6, N): xmin, xmax, ymin, ymax, zmin, zmax per child
  slot; empty slots are (+inf, -inf) so every slab test misses them.
- child (num_nodes, N): >0 inner node (index+1), <0 leaf (~packet index),
  0 empty.
- Tri packets (num_packets, M lanes): v0/e1/e2/n with e1 = v0-v1,
  e2 = v2-v0, n = cross(e1, e2); prim_id -1 = invalid lane, sign bit on
  lane M-1 marks the last packet of a leaf; geom_id = per-tri material id.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import formats


@dataclass
class WideBvh:
    arity: int                # N: children per node
    packet: int               # M: tris per packet (4 for Tri4, 1 for Tri1)
    bounds: np.ndarray        # (num_nodes, 6, N) f32
    child: np.ndarray         # (num_nodes, N) i32
    tri_v0: np.ndarray        # (num_packets, M, 3) f32
    tri_e1: np.ndarray        # (num_packets, M, 3) f32
    tri_e2: np.ndarray        # (num_packets, M, 3) f32
    tri_n: np.ndarray         # (num_packets, M, 3) f32
    prim_id: np.ndarray       # (num_packets, M) i32 (raw, with flags)
    geom_id: np.ndarray       # (num_packets, M) i32

    @property
    def num_nodes(self):
        return len(self.child)

    @property
    def num_packets(self):
        return len(self.prim_id)

    def to_block(self):
        """Converts to a formats.BvhBlock in the reference's file layout."""
        n = self.arity
        btype = {(2, 1): formats.BVH2_TRI1,
                 (4, 4): formats.BVH4_TRI4,
                 (8, 4): formats.BVH8_TRI4}[(n, self.packet)]
        nodes = np.zeros(self.num_nodes, formats.node_dtype(n))
        nodes["bounds"] = self.bounds
        nodes["child"] = self.child
        if self.packet == 4:
            tris = np.zeros(self.num_packets, formats.TRI4_DTYPE)
            # runtime layout (P, M, 3) -> file layout (P, 3, M)
            tris["v0"] = self.tri_v0.transpose(0, 2, 1)
            tris["e1"] = self.tri_e1.transpose(0, 2, 1)
            tris["e2"] = self.tri_e2.transpose(0, 2, 1)
            tris["n"] = self.tri_n.transpose(0, 2, 1)
            tris["prim_id"] = self.prim_id
            tris["geom_id"] = self.geom_id
        else:
            tris = np.zeros(self.num_packets, formats.TRI1_DTYPE)
            tris["v0"] = self.tri_v0[:, 0]
            tris["e1"] = self.tri_e1[:, 0]
            tris["e2"] = self.tri_e2[:, 0]
            tris["prim_id"] = self.prim_id[:, 0]
            tris["geom_id"] = self.geom_id[:, 0]
        return formats.BvhBlock(btype, nodes, tris)

    @classmethod
    def from_block(cls, block):
        n = block.arity
        if block.type == formats.BVH2_TRI1:
            t = block.tris
            v0 = t["v0"][:, None, :]
            e1 = t["e1"][:, None, :]
            e2 = t["e2"][:, None, :]
            nrm = np.cross(e1, e2)
            return cls(arity=2, packet=1,
                       bounds=np.ascontiguousarray(block.nodes["bounds"]),
                       child=np.ascontiguousarray(block.nodes["child"]),
                       tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_n=nrm,
                       prim_id=t["prim_id"][:, None],
                       geom_id=t["geom_id"][:, None])
        t = block.tris
        return cls(arity=n, packet=4,
                   bounds=np.ascontiguousarray(block.nodes["bounds"]),
                   child=np.ascontiguousarray(block.nodes["child"]),
                   tri_v0=np.ascontiguousarray(t["v0"].transpose(0, 2, 1)),
                   tri_e1=np.ascontiguousarray(t["e1"].transpose(0, 2, 1)),
                   tri_e2=np.ascontiguousarray(t["e2"].transpose(0, 2, 1)),
                   tri_n=np.ascontiguousarray(t["n"].transpose(0, 2, 1)),
                   prim_id=np.ascontiguousarray(t["prim_id"]),
                   geom_id=np.ascontiguousarray(t["geom_id"]))
