"""xorshift32 + FNV random numbers, bit-exact with rodent_tpu/core/rng.py
(random.impala; per-path seeding of renderer.impala:26-40).

A uint32 state is held in an int64 tensor with values in [0, 2^32): torch's
`>>` on int32 is arithmetic and its uint32 coverage is partial, so every
step is done in int64 and masked back to 32 bits.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
FNV_INIT = 0x811C9DC5
FNV_PRIME = 16777619
BERNSTEIN_INIT = 5381


def to_int32(x):
    """int64 holding a uint32 value -> int32 with the same bit pattern
    (explicit two's-complement wrap)."""
    x = x & MASK32
    return torch.where(x >= 0x80000000, x - 0x100000000, x).to(torch.int32)


def xorshift(state):
    """32-bit xorshift (random.impala:22-30). Returns the new state."""
    x = torch.where(state == 0, torch.ones_like(state), state)
    x = x ^ ((x << 13) & MASK32)
    x = x ^ (x >> 17)
    x = x ^ ((x << 5) & MASK32)
    return x


def randi(state):
    """Random int32 (bit pattern of the new state). Returns (value, state)."""
    s = xorshift(state)
    return to_int32(s), s


def randf(state):
    """Uniform float in [0, 1) via the mantissa trick (random.impala:7-11).
    Returns (value, state)."""
    s = xorshift(state)
    bits = (127 << 23) | (s & 0x7FFFFF)   # < 2^31: fits int32 as is
    return bits.to(torch.int32).view(torch.float32) - 1.0, s


def fnv_init():
    """The FNV hash's start value, a 0-d int64 tensor (random.impala)."""
    return torch.tensor(FNV_INIT, dtype=torch.int64)


def bernstein_init():
    """The Bernstein hash's start value, a 0-d int64 tensor."""
    return torch.tensor(BERNSTEIN_INIT, dtype=torch.int64)


def bernstein_hash(h, d):
    """Bernstein hash over the 4 bytes of d (random.impala:107-112).
    h, d: int64 tensors holding uint32 values (d may hold an int32's
    negative value: its two's-complement bytes are hashed)."""
    d = d & MASK32
    for shift in (0, 8, 16, 24):
        h = ((h * 33) & MASK32) ^ ((d >> shift) & 0xFF)
    return h


def fnv_hash(h, d):
    """FNV-1a-style hash over the 4 bytes of d (random.impala:116-122).
    h, d: int64 tensors holding uint32 values."""
    d = d & MASK32
    for shift in (0, 8, 16, 24):
        h = ((h * FNV_PRIME) & MASK32) ^ ((d >> shift) & 0xFF)
    return h


def seed_camera_rays(sample, iteration, x, y):
    """Per-pixel/sample seed of make_camera_emitter (renderer.impala:27-33):
    FNV over (sample, iter, x, y). x, y: int64 tensors; sample and
    iteration: ints or int64 tensors broadcastable to x."""
    sample = torch.as_tensor(sample, dtype=torch.int64, device=x.device)
    iteration = torch.as_tensor(iteration, dtype=torch.int64,
                                device=x.device)
    h = torch.full_like(x, FNV_INIT)
    h = fnv_hash(h, sample)
    h = fnv_hash(h, iteration)
    h = fnv_hash(h, x)
    return fnv_hash(h, y)
