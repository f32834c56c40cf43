"""Readers/writers for the reference's binary interchange formats (copy
of rodent_tpu/io/formats.py).

- .bvh  : magic 0x95CBED1F, then blocks of
          [u64 offset][u32 type][u32 node_count][u32 tri_count][nodes][tris]
          where `offset` is the byte distance from just after the offset field
          to the next block header (tools/common/load_bvh.h:8-43,
          tools/bvh_extractor/bvh_extractor.cpp:79-107).
          type: 1 = BVH2_TRI1, 2 = BVH4_TRI4, 3 = BVH8_TRI4.
- .rays : raw binary, 6 x f32 per ray = (org, dir) (tools/common/load_rays.h).
- .fbuf : raw f32 per pixel (tools/fbuf2png/fbuf2png.cpp).

Node/Tri record layouts (src/traversal/mapping_cpu.impala:3-22,
mapping_gpu.impala:3-16):
  NodeN: f32 bounds[6][N] (xmin,xmax,ymin,ymax,zmin,zmax) + i32 child[N]
         + i32 pad[N]
  Tri4 : f32 v0[3][4], e1[3][4], e2[3][4], n[3][4], i32 prim_id[4], geom_id[4]
         prim_id sign bit set on lane 3 marks the last packet of a leaf;
         prim_id == -1 marks an invalid lane.
  Node2: f32 bounds[12] = child0 (lox,hix,loy,hiy,loz,hiz) then child1,
         + i32 child[2] + i32 pad[2]
  Tri1 : f32 v0[3], pad, e1[3], pad(geom_id), e2[3], prim_id

Child encoding: child > 0 -> inner node at index child-1; child < 0 -> leaf
starting at tri packet index ~child; child == 0 -> empty slot.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

BVH_MAGIC = 0x95CBED1F
BVH2_TRI1 = 1
BVH4_TRI4 = 2
BVH8_TRI4 = 3

_ARITY = {BVH2_TRI1: 2, BVH4_TRI4: 4, BVH8_TRI4: 8}


def node_dtype(arity):
    return np.dtype([("bounds", np.float32, (6, arity)),
                     ("child", np.int32, (arity,)),
                     ("pad", np.int32, (arity,))])


TRI4_DTYPE = np.dtype([("v0", np.float32, (3, 4)),
                       ("e1", np.float32, (3, 4)),
                       ("e2", np.float32, (3, 4)),
                       ("n", np.float32, (3, 4)),
                       ("prim_id", np.int32, (4,)),
                       ("geom_id", np.int32, (4,))])

# Tri1 (mapping_gpu.impala:9-16): 48 bytes; geom_id lives in the pad after e1,
# prim_id after e2.
TRI1_DTYPE = np.dtype([("v0", np.float32, (3,)), ("pad", np.float32),
                       ("e1", np.float32, (3,)), ("geom_id", np.int32),
                       ("e2", np.float32, (3,)), ("prim_id", np.int32)])


@dataclass
class BvhBlock:
    type: int
    nodes: np.ndarray  # structured node_dtype(arity)
    tris: np.ndarray   # structured TRI4_DTYPE or TRI1_DTYPE

    @property
    def arity(self):
        return _ARITY[self.type]


def _tri_dtype(btype):
    return TRI1_DTYPE if btype == BVH2_TRI1 else TRI4_DTYPE


def read_bvh(path, bvh_type=None):
    """Reads a .bvh file. Returns the block matching bvh_type (or the first
    block if None). Raises KeyError if absent."""
    blocks = read_bvh_all(path, only_type=bvh_type)
    if not blocks:
        raise KeyError(f"no block of type {bvh_type} in {path}")
    return blocks[0]


def read_bvh_all(path, only_type=None):
    blocks = []
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<I", f.read(4))
        if magic != BVH_MAGIC:
            raise ValueError(f"{path}: bad magic {magic:#x}")
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            (offset,) = struct.unpack("<Q", hdr)
            pos = f.tell()
            (btype,) = struct.unpack("<I", f.read(4))
            if only_type is not None and btype != only_type:
                f.seek(pos + offset)
                continue
            node_count, tri_count = struct.unpack("<II", f.read(8))
            ndt = node_dtype(_ARITY[btype])
            tdt = _tri_dtype(btype)
            nodes = np.fromfile(f, ndt, node_count)
            tris = np.fromfile(f, tdt, tri_count)
            blocks.append(BvhBlock(btype, nodes, tris))
            if only_type is not None:
                break
            f.seek(pos + offset)
    return blocks


def write_bvh(path, blocks):
    """Writes block(s) in the reference's multi-block .bvh format."""
    if isinstance(blocks, BvhBlock):
        blocks = [blocks]
    with open(path, "wb") as f:
        f.write(struct.pack("<I", BVH_MAGIC))
        for b in blocks:
            nodes = np.ascontiguousarray(b.nodes)
            tris = np.ascontiguousarray(b.tris)
            payload = nodes.tobytes() + tris.tobytes()
            # offset counts from after the offset field to the next header
            offset = 4 + 4 + 4 + len(payload)
            f.write(struct.pack("<Q", offset))
            f.write(struct.pack("<III", b.type, len(nodes), len(tris)))
            f.write(payload)


def read_lz4_buffer(f, dtype=np.uint8):
    """Reads one LZ4 buffer record: [u32 uncompressed][u32 compressed]
    [lz4 block] (src/driver/buffer.h read_buffer). f: path or open file."""
    from .. import native
    if isinstance(f, (str, bytes)) or hasattr(f, "__fspath__"):
        with open(f, "rb") as fh:
            return read_lz4_buffer(fh, dtype)
    in_size, out_size = struct.unpack("<II", f.read(8))
    raw = native.lz4_decompress(f.read(out_size), in_size)
    return np.frombuffer(raw, dtype)


def write_lz4_buffer(f, array):
    """Writes one LZ4 buffer record (src/driver/buffer.h write_buffer)."""
    from .. import native
    if isinstance(f, (str, bytes)) or hasattr(f, "__fspath__"):
        with open(f, "wb") as fh:
            return write_lz4_buffer(fh, array)
    raw = np.ascontiguousarray(array).tobytes()
    comp = native.lz4_compress(raw)
    f.write(struct.pack("<II", len(raw), len(comp)))
    f.write(comp)


def read_rays(path, tmin=0.0, tmax=None):
    """Reads a .rays file -> dict of float32 arrays org (N,3), dir (N,3),
    tmin (N,), tmax (N,)."""
    raw = np.fromfile(path, np.float32).reshape(-1, 6)
    n = len(raw)
    if tmax is None:
        tmax = np.float32(3.402823466e38)
    return {
        "org": np.ascontiguousarray(raw[:, 0:3]),
        "dir": np.ascontiguousarray(raw[:, 3:6]),
        "tmin": np.full(n, tmin, np.float32),
        "tmax": np.full(n, tmax, np.float32),
    }


def write_rays(path, org, dir):
    org = np.asarray(org, np.float32).reshape(-1, 3)
    dir = np.asarray(dir, np.float32).reshape(-1, 3)
    np.concatenate([org, dir], axis=1).astype(np.float32).tofile(path)


def read_fbuf(path):
    return np.fromfile(path, np.float32)


def write_fbuf(path, values):
    np.asarray(values, np.float32).tofile(path)


def fbuf_to_png_array(values, width, height, normalize=False):
    """Maps an .fbuf to grayscale u8 like tools/fbuf2png (optional -n)."""
    img = np.asarray(values, np.float32).reshape(height, width)
    if normalize:
        img = img / max(float(np.max(img)), 1e-30)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)
