"""fbuf2png: raw f32-per-pixel buffer -> grayscale PNG (copy of
rodent_tpu/tools/fbuf2png.py).

Mirrors tools/fbuf2png/fbuf2png.cpp: -sx/-sy set dimensions, -n normalizes
by the max value.

Usage:
  python -m rodent_tpu_torch.tools.fbuf2png [-n] -sx W -sy H in.fbuf out.png
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import formats, png


def main(argv=None):
    p = argparse.ArgumentParser(prog="fbuf2png")
    p.add_argument("-n", "--normalize", action="store_true")
    p.add_argument("-sx", "--width", type=int, required=True)
    p.add_argument("-sy", "--height", type=int, required=True)
    p.add_argument("input")
    p.add_argument("output")
    args = p.parse_args(argv)

    vals = formats.read_fbuf(args.input)
    if len(vals) < args.width * args.height:
        print("Not enough data in the float buffer", file=sys.stderr)
        return 1
    img = formats.fbuf_to_png_array(vals[:args.width * args.height],
                                    args.width, args.height,
                                    normalize=args.normalize)
    rgba = np.stack([img, img, img, np.full_like(img, 255)], axis=-1)
    png.write_png(args.output, rgba)
    return 0


if __name__ == "__main__":
    sys.exit(main())
