"""Film accumulation and tonemapping (torch port of
rodent_tpu/render/film.py; driver.cpp update_texture/save_image:118-162).

The film is a flat (H*W, 3) float32 tensor of per-iteration means; the
tonemapper divides by the iteration count and applies gamma 1/2.2.
"""
from __future__ import annotations

import numpy as np
import torch


def new_film(width, height, device):
    return torch.zeros((width * height, 3), dtype=torch.float32,
                       device=device)


def splat(film, pixel_ids, color, mask=None):
    """film with color (n, 3) added at the rows pixel_ids (n,), as a new
    tensor; rows where mask (n,) is False add nothing. As the JAX film's
    scatter-add (mode="drop"): an id in [-rows, -1] counts from the end,
    any other id out of range is dropped. Ids that repeat add in an
    unspecified order."""
    if mask is not None:
        color = torch.where(mask[:, None], color, torch.zeros_like(color))
    rows = film.shape[0]
    ids = pixel_ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + rows, ids)
    keep = (ids >= 0) & (ids < rows)
    return film.index_add(0, ids[keep], color[keep].to(film.dtype))


def tonemap(film, width, height, iters):
    """Running sum -> gamma-2.2 u8 image (H, W, 3), like save_image."""
    if isinstance(film, torch.Tensor):
        film = film.detach().cpu().numpy()
    img = np.asarray(film, np.float32).reshape(height, width, 3)
    img = np.power(np.clip(img / float(iters), 0.0, None), 1.0 / 2.2)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def mse_u8(a, b):
    """Mean squared error over u8 images, the CTest pass metric
    (cmake/test/run_rodent.cmake uses ImageMagick MSE)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))
