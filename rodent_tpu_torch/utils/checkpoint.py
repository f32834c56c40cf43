"""Render checkpoints and a content-addressed BVH cache (torch port of
rodent_tpu/utils/checkpoint.py, in the same file formats, so either
package reads what the other wrote).

The reference has no render-state checkpoint; its nearest mechanisms are
the progressive film divided by the iteration count at display time
(src/driver/driver.cpp:118-135) and the BVH stamp file that skips a
rebuild when (target, scene) are unchanged (src/driver/converter.cpp:
559-573):

- a render checkpoint keeps the film sum, the iteration count and any
  metadata (an .npz), so a progressive render resumes exactly;
- the BVH cache keys a build on a hash of (vertices, indices, arity,
  packet) and keeps it as a .bvh file.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch


def save_render_checkpoint(path, film, iteration, **meta):
    """Writes the running film sum (a tensor on any device, or an array)
    and the iteration counter, with meta as JSON."""
    if isinstance(film, torch.Tensor):
        film = film.detach().cpu().numpy()
    np.savez_compressed(path, film=np.asarray(film, np.float32),
                        iteration=np.int64(iteration),
                        meta=json.dumps(meta))


def load_render_checkpoint(path):
    """Returns (film (N, 3) float32 numpy, iteration int, meta dict)."""
    with np.load(path, allow_pickle=False) as z:
        film = z["film"]
        iteration = int(z["iteration"])
        meta = json.loads(str(z["meta"]))
    return film, iteration, meta


def _mesh_key(vertices, indices, arity, packet):
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(vertices, np.float32).tobytes())
    h.update(np.ascontiguousarray(indices, np.int32).tobytes())
    h.update(f"a{arity}p{packet}v1".encode())
    return h.hexdigest()[:24]


def build_bvh_cached(vertices, indices, arity=8, packet=4,
                     cache_dir=".rodent_cache"):
    """accel.build_bvh (the port's native builder) behind an on-disk cache
    keyed on the geometry's bytes (the bvh.stamp idea). A cache entry that
    does not read back is rebuilt."""
    from ..accel import WideBvh, build_bvh
    from ..io import formats

    key = _mesh_key(vertices, indices, arity, packet)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"bvh_{key}.bvh")
    btype = {(2, 1): formats.BVH2_TRI1, (4, 4): formats.BVH4_TRI4,
             (8, 4): formats.BVH8_TRI4}[(arity, packet)]
    if os.path.exists(path):
        try:
            return WideBvh.from_block(formats.read_bvh(path, btype))
        except (ValueError, KeyError, OSError):
            pass  # a corrupt entry: build anew
    bvh = build_bvh(vertices, indices, arity=arity, packet=packet)
    tmp = path + ".tmp"
    formats.write_bvh(tmp, bvh.to_block())
    os.replace(tmp, path)
    return bvh
