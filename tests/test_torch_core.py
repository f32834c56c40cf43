"""rodent_tpu_torch.core against rodent_tpu.core on the CPU.

Inputs are made with numpy from a seed and go through both packages. The
RNG, safe_rcp and prodsign are held bit for bit; the Vec3 helpers too,
since JAX evaluates each eager op on its own (no fused multiply-add across
ops), except where a square root enters: torch's AVX-512 CPU sqrt is one
float32 ULP off on about 0.6% of inputs, so normalize is held to 2 ULPs
(rtol 2.4e-7). Samplers that call sin/cos/pow are held to 2 float32 ULPs
(rtol 2.4e-7, atol 1e-7): XLA and torch use different polynomial
approximations of those functions. The cosine-power lobe's
s = sqrt(1 - c^2) amplifies a one-ULP pow difference where c is near 1
(measured: 4 of 8192 components, at most 7.2e-7 absolute), so its unit
direction is held to atol 1e-6.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rodent_tpu.core import math as jmath
from rodent_tpu.core import rng as jrng
from rodent_tpu.core import sampling as jsamp
from rodent_tpu.core import vmath as jvm
from rodent_tpu.render import light as jlight
from rodent_tpu_torch.core import math as tmath
from rodent_tpu_torch.core import rng as trng
from rodent_tpu_torch.core import sampling as tsamp
from rodent_tpu_torch.core import vmath as tvm
from rodent_tpu_torch.render import light as tlight

SIN_RTOL, SIN_ATOL = 2.4e-7, 1e-7

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)


def _bits(x):
    return np.asarray(x).view(np.int32)


def _states(n=50_000, seed=0):
    s = np.random.RandomState(seed).randint(0, 2 ** 32, n, dtype=np.uint64)
    s = s.astype(np.uint32)
    s[:3] = (0, 1, 0xFFFFFFFF)
    return s


def test_xorshift_randf_randi_bit_exact():
    s = _states()
    js, ts = jnp.asarray(s), torch.from_numpy(s.astype(np.int64))
    for _ in range(4):   # a few steps of the same streams
        jv, js = jrng.randf(js)
        tv, ts = trng.randf(ts)
        assert np.array_equal(_bits(jv), _bits(tv.numpy()))
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                      ts.numpy())
        ji, js = jrng.randi(js)
        ti, ts = trng.randi(ts)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_seed_camera_rays_bit_exact():
    r = np.random.RandomState(1)
    x = r.randint(0, 4096, 20_000).astype(np.uint32)
    y = r.randint(0, 4096, 20_000).astype(np.uint32)
    for sample, iteration in ((0, 0), (3, 17), (1023, 65535)):
        want = jrng.seed_camera_rays(jnp.uint32(sample),
                                     jnp.uint32(iteration),
                                     jnp.asarray(x), jnp.asarray(y))
        got = trng.seed_camera_rays(sample, iteration,
                                    torch.from_numpy(x.astype(np.int64)),
                                    torch.from_numpy(y.astype(np.int64)))
        np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                      got.numpy())


@pytest.mark.parametrize("n_lights", [1, 2, 3, 7, 1000])
def test_pick_uniform_matches(n_lights):
    s = _states(seed=2)
    ji, js = jlight.pick_uniform(n_lights, jnp.asarray(s))
    ti, ts = tlight.pick_uniform(n_lights,
                                 torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                  ts.numpy())
    assert ti.min() >= 0 and ti.max() < n_lights


def test_safe_rcp_prodsign_bit_exact():
    r = np.random.RandomState(3)
    x = np.concatenate([
        r.randn(20_000).astype(np.float32),
        (r.randn(2000) * 1e-8).astype(np.float32),
        np.float32([0.0, -0.0, 1e-8, -1e-8, 9.9e-9, -9.9e-9, 1e30, -1e30,
                    np.inf, -np.inf])])
    # XLA's CPU backend flushes subnormal results to zero and torch does
    # not, so inputs whose reciprocal is subnormal (|x| > 8.5e37) are
    # left out of the bit-exact check
    got = tmath.safe_rcp(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(jmath.safe_rcp(x)), _bits(got))
    y = r.randn(len(x)).astype(np.float32)
    got = tmath.prodsign(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.array_equal(_bits(jmath.prodsign(x, y)), _bits(got))


FLT_MIN = np.float32(1.1754944e-38)    # the least normal float32


def _subnormal(x):
    return (x != 0) & (np.abs(x) < FLT_MIN)


def _ulps(a, b):
    """The float32 ULPs between a and b of one sign."""
    return np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))


def test_safe_rcp_keeps_the_subnormals_xla_flushes():
    """ROADMAP C6: XLA's CPU backend (like the TPU) flushes subnormal
    results to zero; torch on the CPU and the card's kernels (built
    without -ftz) keep them. safe_rcp over |x| > 8.5e37, whose reciprocals
    are subnormal, and over normal inputs: the port equals the JAX package
    bit for bit wherever JAX's result is not a flushed zero; where it is,
    the port's result is a subnormal of x's sign, and flushing it to a
    zero of that sign gives JAX's bits."""
    r = np.random.RandomState(7)
    big = np.exp(r.uniform(np.log(8.6e37), np.log(3.4e38), 4096))
    big = (big * np.where(r.rand(4096) < 0.5, -1, 1)).astype(np.float32)
    x = np.concatenate([big, r.randn(4096).astype(np.float32)])
    want = np.asarray(jmath.safe_rcp(x))
    got = tmath.safe_rcp(torch.from_numpy(x)).numpy()
    flushed = want == 0
    assert flushed.sum() == len(big)
    assert np.array_equal(_bits(got[~flushed]), _bits(want[~flushed]))
    assert _subnormal(got[flushed]).all()
    assert np.array_equal(np.signbit(got[flushed]), np.signbit(x[flushed]))
    flush = np.where(_subnormal(got), np.copysign(np.float32(0), got), got)
    assert np.array_equal(_bits(flush), _bits(want))


def test_cosine_power_pdf_keeps_the_subnormals_xla_flushes():
    """C6 on the cosine-power pdf at c < 0.3, where c^k underflows. XLA
    flushes pow's subnormal results; the port keeps them and scales them
    by (k + 1) / 2pi, which lifts some into the normal range (the
    difference shows on about a third of JAX's zeros). Where JAX's pdf is
    not zero: bit for bit wherever the two pows agree (XLA's and torch's
    approximations differ by one ULP on about 2% of inputs, at most 3
    ULPs after the two products). Where it is a flushed zero: the port's
    pow is subnormal or zero, and the port run with torch's flush on (the
    FTZ/DAZ modes of XLA's CPU code) gives JAX's bits."""
    r = np.random.RandomState(8)
    c = (0.3 * r.rand(8192)).astype(np.float32)
    k = (r.rand(8192) * 64 + 1).astype(np.float32)
    tc, tk = torch.from_numpy(c), torch.from_numpy(k)
    want = np.asarray(jsamp.cosine_power_hemisphere_pdf(jnp.asarray(c),
                                                        jnp.asarray(k)))
    got = tsamp.cosine_power_hemisphere_pdf(tc, tk).numpy()
    jpow = np.asarray(jnp.power(jnp.maximum(jnp.asarray(c), 0.0),
                                jnp.asarray(k)))
    tpow = torch.pow(torch.clamp(tc, min=0.0), tk).numpy()
    flushed = want == 0
    same_pow = _bits(jpow) == _bits(tpow)
    assert np.array_equal(_bits(got[~flushed & same_pow]),
                          _bits(want[~flushed & same_pow]))
    assert _ulps(got[~flushed], want[~flushed]).max() <= 3
    assert (tpow[flushed] < FLT_MIN).all() and (got[flushed] >= 0).all()
    assert (got[flushed] != 0).sum() > flushed.sum() // 5
    assert torch.set_flush_denormal(True)
    try:
        ftz = tsamp.cosine_power_hemisphere_pdf(tc, tk).numpy()
    finally:
        torch.set_flush_denormal(False)
    assert np.array_equal(_bits(ftz[flushed]), _bits(want[flushed]))


def _vec(r, n=4096):
    return tuple(r.randn(n).astype(np.float32) for _ in range(3))


def _t(v):
    return tuple(torch.from_numpy(c.copy()) for c in v)


def _j(v):
    return tuple(jnp.asarray(c) for c in v)


def _same(jv, tv):
    for a, b in zip(jv, tv):
        assert np.array_equal(_bits(a), _bits(b.numpy()))


def test_vmath_bit_exact():
    r = np.random.RandomState(4)
    a, b = _vec(r), _vec(r)
    k = r.rand(4096).astype(np.float32)
    n = tuple(np.asarray(c) for c in jvm.normalize(_j(a)))
    for x, y in zip(jvm.normalize(_j(a)), tvm.normalize(_t(a))):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=2.4e-7,
                                   atol=0)
    _same(jvm.cross(_j(a), _j(b)), tvm.cross(_t(a), _t(b)))
    _same(jvm.reflect(_j(a), _j(n)), tvm.reflect(_t(a), _t(n)))
    _same(jvm.lerp(_j(a), _j(b), jnp.asarray(k)),
          tvm.lerp(_t(a), _t(b), torch.from_numpy(k)))
    _same(jvm.lerp2(_j(a), _j(b), _j(n), jnp.asarray(k), jnp.asarray(k)),
          tvm.lerp2(_t(a), _t(b), _t(n), torch.from_numpy(k),
                    torch.from_numpy(k)))
    for jx, tx in zip(jvm.onb(_j(n)), tvm.onb(_t(n))):
        _same(jx, tx)
    _same(jvm.basis_mul(_j(a), _j(b), _j(n), _j(a)),
          tvm.basis_mul(_t(a), _t(b), _t(n), _t(a)))
    assert np.array_equal(_bits(jvm.luminance(_j(a))),
                          _bits(tvm.luminance(_t(a)).numpy()))
    rows = np.stack(a, axis=-1)
    assert np.array_equal(_bits(jmath.luminance(rows)),
                          _bits(tmath.luminance(torch.from_numpy(rows))))


def _close(jv, tv):
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=SIN_RTOL,
                                   atol=SIN_ATOL)


def test_sampling_matches():
    r = np.random.RandomState(5)
    u, v = (r.rand(8192).astype(np.float32) for _ in range(2))
    ju, jv, tu, tv = jnp.asarray(u), jnp.asarray(v), torch.from_numpy(u), \
        torch.from_numpy(v)
    jd, jp = jsamp.sample_cosine_hemisphere_c(ju, jv)
    td, tp = tsamp.sample_cosine_hemisphere_c(tu, tv)
    _close(jd + (jp,), td + (tp,))
    k = (r.rand(8192) * 64 + 1).astype(np.float32)
    jd, jp = jsamp.sample_cosine_power_hemisphere_c(jnp.asarray(k), ju, jv)
    td, tp = tsamp.sample_cosine_power_hemisphere_c(torch.from_numpy(k), tu,
                                                    tv)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    _close((jp,), (tp,))
    # c >= 0.3 keeps c^k normal: XLA's CPU backend flushes subnormals
    c = (0.3 + 0.7 * r.rand(8192)).astype(np.float32)
    _close((jsamp.cosine_power_hemisphere_pdf(jnp.asarray(c),
                                              jnp.asarray(k)),),
           (tsamp.cosine_power_hemisphere_pdf(torch.from_numpy(c),
                                              torch.from_numpy(k)),))
    tri = [_vec(r, 8192) for _ in range(3)]
    _same(jsamp.sample_triangle_c(ju, jv, *map(_j, tri)),
          tsamp.sample_triangle_c(tu, tv, *map(_t, tri)))
