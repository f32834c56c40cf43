"""Images and textures (torch port of rodent_tpu/render/texture.py;
image.impala): border handling, nearest and bilinear filtering, and the
padded texture bank that the integrator samples per ray.

Host side (numpy): image_from_u8, load_texture (PNG or JPEG by signature,
gamma 2.2 to linear as image.cpp:10-18) and build_bank. Sampling runs on
torch tensors on the device of `uv`: uv is (..., 2), the result (..., 3).
Texel indices are int64 (torch indexes with them), where the JAX package
computes them in int32; the values are the same.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

BORDER_CLAMP = "clamp"
BORDER_REPEAT = "repeat"
FILTER_NEAREST = "nearest"
FILTER_BILINEAR = "bilinear"


def image_from_u8(rgba, gamma=2.2):
    """u8 (H, W, C) -> linear f32 (H, W, 3) (image.cpp:10-18 applies
    gamma on load). Gray / gray+alpha inputs broadcast luma to RGB."""
    img = np.asarray(rgba, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] < 3:  # gray or gray+alpha PNG (color_type 0/4)
        img = np.repeat(img[..., :1], 3, axis=-1)
    img = img[..., :3] / 255.0
    return np.power(img, gamma).astype(np.float32)


def _apply_border(u, v, mode):
    """image.impala:40-54. Under repeat, u - floor(u) can round to 1.0
    for tiny negative u; the texel clamp to w - 1 takes care of it."""
    if mode == BORDER_CLAMP:
        return torch.clamp(u, 0.0, 1.0), torch.clamp(v, 0.0, 1.0)
    if mode == BORDER_REPEAT:
        return u - torch.floor(u), v - torch.floor(v)
    raise ValueError(mode)


def _cap(x, hi):
    """min(x, hi) for an int or a tensor hi."""
    if isinstance(hi, torch.Tensor):
        return torch.minimum(x, hi)
    return torch.clamp(x, max=hi)


def _bilinear(fetch, u, v, w, h):
    """The reference's corner convention (image.impala:65-84): x0 =
    trunc(u*w) clamped to the image, weight frac(u*w), no half-texel
    shift. w, h: ints or int tensors broadcasting against u."""
    x = u * w
    y = v * h
    x0 = _cap(x.to(torch.int64), w - 1)
    y0 = _cap(y.to(torch.int64), h - 1)
    x1 = _cap(x0 + 1, w - 1)
    y1 = _cap(y0 + 1, h - 1)
    fx = (x - torch.floor(x))[..., None]
    fy = (y - torch.floor(y))[..., None]
    c00 = fetch(x0, y0)
    c01 = fetch(x1, y0)
    c10 = fetch(x0, y1)
    c11 = fetch(x1, y1)
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def _nearest(fetch, u, v, w, h):
    """image.impala:58-63: floor to the texel."""
    x = torch.clamp((u * w).to(torch.int64), min=0)
    y = torch.clamp((v * h).to(torch.int64), min=0)
    return fetch(_cap(x, w - 1), _cap(y, h - 1))


def sample_texture(image, uv, border=BORDER_REPEAT, filter=FILTER_BILINEAR):
    """Samples a linear (H, W, 3) image at uv (..., 2) -> (..., 3), on
    the device of uv."""
    image = torch.as_tensor(image, dtype=torch.float32, device=uv.device)
    h, w = image.shape[0], image.shape[1]
    u, v = _apply_border(uv[..., 0], uv[..., 1], border)

    def fetch(x, y):
        return image[y, x]

    if filter == FILTER_NEAREST:
        return _nearest(fetch, u, v, w, h)
    return _bilinear(fetch, u, v, w, h)


def make_texture(image, border=BORDER_REPEAT, filter=FILTER_BILINEAR):
    """Returns a uv -> color closure (make_texture, image.impala:86-92)."""
    return partial(sample_texture, image, border=border, filter=filter)


def load_texture(path, gamma=2.2):
    """Image path -> linear (H, W, 3) f32; PNG or JPEG by signature
    (device.load_png / device.load_jpg, image.cpp, interface.cpp:584-596)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\xff\xd8":
        from ..io import jpg
        return image_from_u8(jpg.read_jpg(path), gamma)
    from ..io import png
    return image_from_u8(png.read_png(path), gamma)


def build_bank(images):
    """Stacks differently-sized textures into one zero-padded bank for
    per-ray lookup (the Interface image registry, interface.cpp:456-492).

    Returns (bank (T, Hmax, Wmax, 3) f32, hw (T, 2) i32), numpy."""
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    bank = np.zeros((len(images), hmax, wmax, 3), np.float32)
    hw = np.zeros((len(images), 2), np.int32)
    for i, im in enumerate(images):
        bank[i, :im.shape[0], :im.shape[1]] = im[..., :3]
        hw[i] = (im.shape[0], im.shape[1])
    return bank, hw


def sample_bank(bank, hw, tex_id, uv, border=BORDER_REPEAT,
                filter=FILTER_BILINEAR):
    """Nearest or bilinear sample with a per-ray texture id.

    bank: (T, Hmax, Wmax, 3) and hw: (T, 2) tensors on uv's device;
    tex_id: (B,) integer tensor (negative ids read texture 0: mask the
    result); uv: (B, 2). Returns (B, 3)."""
    T, HM, WM, _ = bank.shape
    flat = bank.reshape(T * HM * WM, 3)
    tid = torch.clamp(tex_id.long(), min=0)
    h = hw[tid, 0].long()
    w = hw[tid, 1].long()
    u, v = _apply_border(uv[..., 0], uv[..., 1], border)

    def fetch(x, y):
        return flat[tid * (HM * WM) + y * WM + x]

    if filter == FILTER_NEAREST:
        return _nearest(fetch, u, v, w, h)
    return _bilinear(fetch, u, v, w, h)
