"""converter: OBJ -> data/ directory of device buffers + scene program
(torch port of rodent_tpu/tools/converter.py; it writes the same files
byte for byte).

The reference converter (src/driver/converter.cpp) writes LZ4-compressed
buffers (data/vertices.bin, normals.bin, face_normals.bin, indices.bin,
texcoords.bin, light_*.bin, bvh.bin) and *generates Impala source*
instantiating the scene. Our scene program is data, not code: scene.json
records the static configuration (materials, lights, spp, max_path_len)
that the reference bakes into main.impala, and the runtime
(render.compiler.load_data_dir) reads it back.

Buffer formats match the reference byte for byte:
- every .bin is one LZ4 buffer record (src/driver/buffer.h);
- indices.bin is 4 x i32 per triangle (v0, v1, v2, material);
- bvh.bin is [u32 sizeof(node)][u32 sizeof(tri)] then two LZ4 buffers of
  node and tri records (converter.cpp:428-438);
- vec3 buffers are padded to vec4 with --pad (GPU targets'
  enable_padding).

Usage:
  python -m rodent_tpu_torch.tools.converter scene.obj [-d data/] [--width 8]
      [--spp 4] [--max-path-len 64] [--pad]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import sys

import numpy as np

from ..accel import build_bvh
from ..io import formats
from ..render import compiler as scene_compiler
from ..render import light as light_mod


def _pad_vec3(a, pad):
    if not pad:
        return a
    out = np.zeros((len(a), 4), np.float32)
    out[:, :3] = a
    return out


def write_scene_data(obj_path, out_dir="data", arity=8, spp=4,
                     max_path_len=64, pad=False):
    os.makedirs(out_dir, exist_ok=True)
    scene = scene_compiler.compile_obj(obj_path, "cpu", arity=arity,
                                       max_path_len=max_path_len)
    mesh = scene.mesh

    def w(name, arr):
        formats.write_lz4_buffer(os.path.join(out_dir, name), arr)

    w("vertices.bin", _pad_vec3(mesh.vertices, pad))
    w("normals.bin", _pad_vec3(mesh.normals, pad))
    w("face_normals.bin", _pad_vec3(mesh.face_normals, pad))
    w("texcoords.bin", mesh.texcoords)
    w("indices.bin", mesh.indices.astype(np.int32))

    # light buffers (converter.cpp:840-855) + per-tri light ids
    ke = np.asarray([p["ke"] for p in scene.mat_params], np.float32)
    emissive_tri = np.asarray(
        [scene.mat_params[m]["emissive"] for m in mesh.tri_materials], bool)
    lights, light_ids = light_mod.build_light_table(mesh, ke, emissive_tri)
    tri_lights = lights["kind"] == light_mod.TRIANGLE
    if tri_lights.any():
        lv = np.stack([lights["v0"], lights["v1"], lights["v2"]],
                      axis=1).reshape(-1, 3)
        w("light_verts.bin", _pad_vec3(lv, pad))
        w("light_areas.bin", lights["inv_area"].astype(np.float32))
        w("light_norms.bin", _pad_vec3(lights["n"], pad))
        w("light_colors.bin", _pad_vec3(lights["color"], pad))
    w("light_ids.bin", light_ids.astype(np.int32))

    # bvh.bin: [u32 node_bytes][u32 tri_bytes][lz4 nodes][lz4 tris]
    bvh = build_bvh(mesh.vertices, mesh.indices, arity=arity)
    block = bvh.to_block()
    with open(os.path.join(out_dir, "bvh.bin"), "wb") as f:
        f.write(struct.pack("<II", block.nodes.dtype.itemsize,
                            block.tris.dtype.itemsize))
        formats.write_lz4_buffer(f, block.nodes)
        formats.write_lz4_buffer(f, block.tris)

    # texture images travel with the data dir (the reference's generated
    # code loads them by path at runtime, converter.cpp:877-895)
    if scene.tex_files:
        tex_dir = os.path.join(out_dir, "textures")
        os.makedirs(tex_dir, exist_ok=True)
        base = os.path.dirname(os.path.abspath(obj_path))
        for name in scene.tex_files:
            dst = os.path.join(tex_dir, name)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(os.path.join(base, name), dst)

    program = {
        "scene": os.path.basename(obj_path),
        "arity": arity,
        "spp": spp,
        "max_path_len": max_path_len,
        "padded_vec3": pad,
        "num_tris": int(mesh.num_tris),
        "num_lights": scene.num_lights,
        "textures": scene.tex_files,
        "materials": [
            {"name": n, **{k: v for k, v in p.items()}}
            for n, p in zip(scene.materials, scene.mat_params)
        ],
    }
    with open(os.path.join(out_dir, "scene.json"), "w") as f:
        json.dump(program, f, indent=1)
    # build stamp (converter.cpp:559-573)
    with open(os.path.join(out_dir, "bvh.stamp"), "w") as f:
        f.write(f"{arity} {obj_path}")
    return program


def read_bvh_bin(path):
    """Reads data/bvh.bin back into (nodes, tris) structured arrays."""
    with open(path, "rb") as f:
        node_bytes, tri_bytes = struct.unpack("<II", f.read(8))
        raw_nodes = formats.read_lz4_buffer(f)
        raw_tris = formats.read_lz4_buffer(f)
    arity = {128: 4, 256: 8, 64: 2}[node_bytes]
    ndt = formats.node_dtype(arity)
    tdt = formats.TRI1_DTYPE if arity == 2 else formats.TRI4_DTYPE
    assert ndt.itemsize == node_bytes and tdt.itemsize == tri_bytes
    return (np.frombuffer(raw_nodes.tobytes(), ndt),
            np.frombuffer(raw_tris.tobytes(), tdt))


def main(argv=None):
    p = argparse.ArgumentParser(prog="converter")
    p.add_argument("scene")
    p.add_argument("-d", "--data-dir", default="data")
    p.add_argument("--width", type=int, default=8, choices=(2, 4, 8))
    p.add_argument("-spp", "--spp", type=int, default=4)
    p.add_argument("--max-path-len", type=int, default=64)
    p.add_argument("--pad", action="store_true",
                   help="pad vec3 buffers to vec4 (GPU-target parity)")
    args = p.parse_args(argv)
    program = write_scene_data(args.scene, args.data_dir, args.width,
                               args.spp, args.max_path_len, args.pad)
    print(f"converted '{args.scene}': {program['num_tris']} tris, "
          f"{len(program['materials'])} materials, "
          f"{program['num_lights']} light(s) -> {args.data_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
