"""bvh_extractor: OBJ -> standalone multi-block .bvh file (copy of
rodent_tpu/tools/bvh_extractor.py).

Mirrors tools/bvh_extractor: emits BVH2_TRI1, BVH4_TRI4 and BVH8_TRI4
blocks (or a subset via --width) into the magic-0x95CBED1F format consumed
by bench_traversal.

Usage:
  python -m rodent_tpu_torch.tools.bvh_extractor scene.obj out.bvh \
      [--width 8 ...]
"""
from __future__ import annotations

import argparse
import sys

from ..accel import build_bvh
from ..io import formats, obj


def main(argv=None):
    p = argparse.ArgumentParser(prog="bvh_extractor")
    p.add_argument("obj")
    p.add_argument("output")
    p.add_argument("--width", type=int, action="append", choices=(2, 4, 8),
                   help="BVH widths to emit (default: 2 4 8)")
    args = p.parse_args(argv)
    widths = args.width or [2, 4, 8]

    mesh, _, _ = obj.load_scene_mesh(args.obj)
    blocks = []
    for w in widths:
        packet = 1 if w == 2 else 4
        bvh = build_bvh(mesh.vertices, mesh.indices, arity=w, packet=packet)
        blocks.append(bvh.to_block())
        print(f"BVH{w}: {bvh.num_nodes} nodes, {bvh.num_packets} packets")
    formats.write_bvh(args.output, blocks)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
