"""Cost accounting of a sharded render: per-shard work, padding waste and
collective volume (torch port of rodent_tpu/parallel/accounting.py).

- per-shard *step counts*: the persistent wavefront loop's trip count is
  the whole per-device cost (each step is one traverse + shade + retire
  over the fixed pool), so imbalance across pixel strips is load
  imbalance. measure_shard_steps measures them by running each shard's
  exact call;
- *padding waste*: an uneven W*H pads the film to ceil(total/n_px)*n_px
  rows across the px axis, and the padded rows trace wasted rays;
- *collective bytes*: the render path's one reduction is the sum of the
  (local, 3) float32 partial film over the sp ranks (parallel.mesh); a
  ring all-reduce moves 2*(n_sp-1)/n_sp of its bytes per rank and
  iteration. The strips' all-gather and the traversal's hit gather are
  the port's way of returning the whole result to every rank (JAX leaves
  its output sharded) and are not counted here.

The JAX module's third function, hlo_cross_device_collectives, reads the
compiled XLA program's text; the port compiles no XLA program and has no
counterpart of it.
"""
from __future__ import annotations

import numpy as np
import torch


def shard_plan(width, height, spp, n_px, n_sp=1):
    """Per-rank samples, padding waste and collective traffic (bytes per
    rank and iteration) of an (n_sp, n_px) mesh render iteration
    (accounting.py:28-51)."""
    total = width * height
    local = -(-total // n_px)
    total_pad = local * n_px
    assert spp % n_sp == 0, "spp must divide the sp axis"
    spp_local = spp // n_sp
    film_local_bytes = local * 3 * 4
    return {
        "n_px": n_px,
        "n_sp": n_sp,
        "pixels_local": local,
        "samples_local": local * spp_local,
        "padded_pixels": total_pad - total,
        "padded_fraction": (total_pad - total) / total,
        # the sum of the partial film over sp: ring all-reduce
        "collective_bytes_per_device": (
            0 if n_sp == 1
            else int(2 * (n_sp - 1) / n_sp * film_local_bytes)),
        "film_local_bytes": film_local_bytes,
    }


def measure_shard_steps(scene, camera, width, height, spp, n_px, n_sp=1,
                        pool=None, packet=True, sort=False, retire_every=1):
    """Measured per-shard wavefront step counts (accounting.py:90-120):
    each (sp, px) rank's persistent iteration run in turn on the scene's
    device, with the exact pixel_lo / n_pixels / sample_lo / spp_weight of
    parallel.mesh.render_iteration_persistent_sharded. Returns an
    (n_sp, n_px) int64 array; its max over its mean is the load-imbalance
    factor of the sharded iteration, whose slowest strip sets its time.
    packet defaults to True (K1), as the port's renderers do."""
    from ..render.integrator import render_iteration_persistent

    plan = shard_plan(width, height, spp, n_px, n_sp)
    local = plan["pixels_local"]
    spp_local = spp // n_sp
    device = scene["bvh"]["nodes"].device
    steps = np.zeros((n_sp, n_px), np.int64)
    for sp in range(n_sp):
        for px in range(n_px):
            film = torch.zeros((local, 3), dtype=torch.float32,
                               device=device)
            _, st = render_iteration_persistent(
                scene, camera, film, width, height, spp_local, 0,
                pool=pool, packet=packet, sort=sort,
                retire_every=retire_every, pixel_lo=px * local,
                n_pixels=local, sample_lo=sp * spp_local,
                spp_weight=1.0 / spp, return_steps=True)
            steps[sp, px] = int(st)
    return steps
