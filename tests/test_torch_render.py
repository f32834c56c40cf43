"""rodent_tpu_torch.render against rodent_tpu.render on the CPU.

The scene compiler must reproduce the JAX package's tables byte for byte.
The slice (camera -> traversal -> shading -> film) is held against the
JAX renderer on the same tables: XLA fuses multiply-adds and evaluates
sqrt/sin/cos/pow its own way, and a one-ULP difference can flip a Russian
roulette draw, so films agree pixel by pixel only up to those flips
(tolerance below). The hall and crown golden-image gates of
test_golden_scenes.py hold the port's films on their own.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodent_tpu.io import obj as obj_io
from rodent_tpu.io import png
from rodent_tpu.render import bsdf as jbsdf
from rodent_tpu.render.camera import Camera as JCamera
from rodent_tpu.render.compiler import compile_mesh as jcompile
from rodent_tpu.render.integrator import render_iteration as jrender
from rodent_tpu.utils import testscenes
from rodent_tpu_torch.render import bsdf as tbsdf
from rodent_tpu_torch.render import film as film_mod
from rodent_tpu_torch.render.camera import Camera
from rodent_tpu_torch.render.compiler import compile_mesh, from_jax_device
from rodent_tpu_torch.render.integrator import (
    render_iteration, render_iteration_persistent)
from rodent_tpu_torch.traversal import packet

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
HALL_CAM = ((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0)
W, H = 32, 24

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hall():
    verts, idx = testscenes.make_hall(20_000)
    return verts, idx, jcompile(verts, idx, max_path_len=4,
                                emitter="inside")


def _assert_same_tree(want, got, path="device"):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _assert_same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        a, b = np.asarray(want), got.numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    elif path.endswith("meta"):
        assert (got.shared_stack, got.node_stack) == (
            want.shared_stack, want.node_stack)
    elif path.endswith("mat_kinds"):
        assert got == tuple(want.kinds)
    else:
        assert got == want, path


def test_compile_mesh_matches_jax(hall):
    verts, idx, jscene = hall
    scene = compile_mesh(verts, idx, "cpu", max_path_len=4,
                         emitter="inside")
    want = jax.tree_util.tree_map(np.asarray, jscene.device)
    _assert_same_tree(want, scene.device)
    _assert_same_tree(want, from_jax_device(want, "cpu"))
    assert scene.num_lights == jscene.num_lights == 2
    assert scene.materials == jscene.materials


def test_render_iteration_matches_jax(hall):
    """hall-20K, 32x24, spp 1, mpl 4, both packages on the JAX package's
    tables. Tolerance: rtol 1e-4 and atol 1e-5 on >= 99% of pixels, mean
    radiance within 0.5%. Measured: 762 of 768 pixels (99.2%) within, 352
    bit-identical, mean radiance 4.8e-6 apart."""
    _, _, jscene = hall
    want = np.asarray(jrender(jscene.device, JCamera.make(*HALL_CAM, W, H),
                              jnp.zeros((W * H, 3), jnp.float32), W, H, 1,
                              0, packet=False))
    scene = from_jax_device(jax.tree_util.tree_map(np.asarray,
                                                   jscene.device), "cpu")
    stats = {}
    packet.reset_launches()
    got = render_iteration(scene, Camera.make(*HALL_CAM, W, H),
                           film_mod.new_film(W, H, "cpu"), W, H, 1, 0,
                           stats=stats).numpy()
    assert packet.launches["bvh_traverse"] == 0   # CPU: plain traversal
    assert 1 <= stats["bounces"] <= 5             # mpl 4: depths 0..4
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() / want.mean() - 1.0) < 5e-3
    assert np.isfinite(got).all() and got.min() >= 0.0


def test_film_independent_of_gather_path_and_sort(hall):
    """The 4-gather surface element and the sorted traversal give the
    film of the tri_shade / unsorted path bit for bit."""
    verts, idx, _ = hall
    scene = compile_mesh(verts, idx, "cpu", max_path_len=4,
                         emitter="inside")
    cam = Camera.make(*HALL_CAM, 24, 16)

    def run(dev, sort):
        return render_iteration(dev, cam, film_mod.new_film(24, 16, "cpu"),
                                24, 16, 2, 3, sort=sort).numpy()

    base = run(scene.device, False)
    lean = {k: v for k, v in scene.device.items() if k != "tri_shade"}
    np.testing.assert_array_equal(run(lean, False), base)
    np.testing.assert_array_equal(run(scene.device, True), base)
    assert base.mean() > 0.0


def test_hall_golden_gate():
    """The gate of test_golden_scenes.py (mse_u8 <= 3 x calib + 1, image
    mean within 50%) through the port on the CPU."""
    with open(os.path.join(GOLDEN, "golden_meta.json")) as f:
        m = json.load(f)["hall"]
    verts, idx = testscenes.make_hall(m["tris"])
    scene = compile_mesh(verts, idx, "cpu", max_path_len=8,
                         emitter="inside")
    w, h = m["w"], m["h"]
    cam = Camera.make(*HALL_CAM, w, h)
    film = film_mod.new_film(w, h, "cpu")
    for it in range(m["test_iters"]):
        film = render_iteration(scene.device, cam, film, w, h, m["spp"], it)
    img = film_mod.tonemap(film, w, h, m["test_iters"])
    golden = png.read_png(os.path.join(GOLDEN, "hall.png"))[..., :3]
    mse = film_mod.mse_u8(golden, img)
    assert mse <= 3.0 * m["calib_mse_u8"] + 1.0, mse
    assert abs(float(img.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"]


def test_crown_golden_gate():
    """Crown's gate of test_golden_scenes.py (mse_u8 <= 3 x calib + 1,
    image mean within 50%) through the port on the CPU, in the
    configuration of experiments/make_goldens.py (crown-60K, emitter above,
    160x90, spp 2, 2 iterations). The golden was rendered with the
    dual-queue engine (packet=False, compact=5), which the port does not
    carry; the port's persistent renderer with packet=True is held to the
    same 40-iteration golden."""
    with open(os.path.join(GOLDEN, "golden_meta.json")) as f:
        m = json.load(f)["crown"]
    verts, idx = testscenes.make_crown(m["tris"])
    scene = compile_mesh(verts, idx, "cpu", max_path_len=8,
                         emitter="above")
    w, h = m["w"], m["h"]
    cam = Camera.make((4.2, 1.8, 1.2), (-4.2, -1.4, -1.2), (0, 1, 0), 42.0,
                      w, h)
    film = film_mod.new_film(w, h, "cpu")
    for it in range(m["test_iters"]):
        film = render_iteration_persistent(scene.device, cam, film, w, h,
                                           m["spp"], it, packet=True)
    img = film_mod.tonemap(film, w, h, m["test_iters"])
    golden = png.read_png(os.path.join(GOLDEN, "crown.png"))[..., :3]
    mse = film_mod.mse_u8(golden, img)
    assert mse <= 3.0 * m["calib_mse_u8"] + 1.0, mse
    assert abs(float(img.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"]


def test_textured_scene_not_ported():
    verts, idx = testscenes.make_hall(2_000)
    mats = [obj_io.Material(name=f"m{i}", kd=(1.0, 1.0, 1.0),
                            map_kd="checker") for i in range(4)]
    with pytest.raises(NotImplementedError):
        compile_mesh(verts, idx, "cpu", materials=mats)


def _rand_surface(r, n):
    def unit():
        v = r.randn(3, n).astype(np.float32)
        return v / np.linalg.norm(v, axis=0)
    nrm = unit()
    sign = np.where(nrm[2] >= 0, 1.0, -1.0).astype(np.float32)
    a = -1.0 / (sign + nrm[2])
    b = nrm[0] * nrm[1] * a
    t = np.stack([1 + sign * nrm[0] ** 2 * a, sign * b, -sign * nrm[0]])
    bt = np.stack([b, sign + nrm[1] ** 2 * a, -nrm[1]])
    face = unit()
    return {"n": nrm, "t": t.astype(np.float32), "b": bt.astype(np.float32),
            "face_normal": face, "is_entering": r.rand(n) < 0.5}, unit()


def test_bsdf_matches_jax():
    """eval_pdf and sample over every BSDF kind, random materials and
    frames. Tolerance rtol 1e-4 / atol 1e-5: pow, sin and cos differ by
    ULPs between XLA and torch and the Phong lobe's pow(cos, ns) with ns
    up to 64 scales that by ns."""
    r = np.random.RandomState(7)
    n = 6000
    surf, out_dir = _rand_surface(r, n)
    _, in_dir = _rand_surface(r, n)
    mat = {"kind": r.randint(0, 6, n).astype(np.int32),
           "kd": r.rand(3, n).astype(np.float32),
           "ks": r.rand(3, n).astype(np.float32),
           "ns": (r.rand(n) * 63 + 1).astype(np.float32),
           "ni": (1.0 + r.rand(n)).astype(np.float32),
           "tf": r.rand(3, n).astype(np.float32),
           "mix_k": r.rand(n).astype(np.float32)}
    rnd = r.randint(1, 2 ** 31, n).astype(np.uint32)

    def to_j(d):
        return {k: tuple(jnp.asarray(c) for c in v)
                if np.ndim(v) == 2 else jnp.asarray(v) for k, v in d.items()}

    def to_t(d):
        return {k: tuple(torch.from_numpy(c.copy()) for c in v)
                if np.ndim(v) == 2 else torch.from_numpy(np.asarray(v))
                for k, v in d.items()}

    def close(a, b):
        for x, y in zip(np.broadcast_arrays(*a), np.broadcast_arrays(*b)):
            np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-5)

    jm, js, tm, ts = to_j(mat), to_j(surf), to_t(mat), to_t(surf)
    jin, jout = tuple(map(jnp.asarray, in_dir)), tuple(map(jnp.asarray,
                                                           out_dir))
    tin = tuple(torch.from_numpy(c.copy()) for c in in_dir)
    tout = tuple(torch.from_numpy(c.copy()) for c in out_dir)
    jc, jp = jbsdf.eval_pdf(jm, js, jin, jout)
    tc, tp = tbsdf.eval_pdf(tm, ts, tin, tout)
    close([*map(np.asarray, jc), np.asarray(jp)],
          [*(c.numpy() for c in tc), tp.numpy()])
    jd, jp, jcos, jcol, jr = jbsdf.sample(jm, js, jnp.asarray(rnd), jout)
    td, tp, tcos, tcol, tr = tbsdf.sample(
        tm, ts, torch.from_numpy(rnd.astype(np.int64)), tout)
    np.testing.assert_array_equal(np.asarray(jr).astype(np.int64),
                                  tr.numpy())
    close([*map(np.asarray, jd + jcol), np.asarray(jp), np.asarray(jcos)],
          [*(c.numpy() for c in td + tcol), tp.numpy(), tcos.numpy()])


def test_camera_matches_jax():
    """Camera.make's basis and the camera helpers equal the JAX package's
    to 2 float32 ULPs (rtol 2.4e-7; torch's CPU sqrt is one ULP off on a
    few inputs)."""
    jcam = JCamera.make(*HALL_CAM, 160, 90)
    cam = Camera.make(*HALL_CAM, 160, 90)
    assert (cam.eye, cam.dir, cam.right, cam.up, cam.w, cam.h) == (
        jcam.eye, jcam.dir, jcam.right, jcam.up, jcam.w, jcam.h)
    r = np.random.RandomState(9)
    kx, ky = (r.uniform(-1, 1, 500).astype(np.float32) for _ in range(2))
    tkx, tky = torch.from_numpy(kx), torch.from_numpy(ky)
    jo, jd = jcam.generate_rays(jnp.asarray(kx), jnp.asarray(ky))
    to, td = cam.generate_rays(tkx, tky)
    p = np.array(jo + 3.0 * jd)
    pairs = [(jo, to), (jd, td),
             (jcam.project(jnp.asarray(p)), cam.project(torch.from_numpy(p))),
             (jcam.unproject(jnp.zeros((5, 3))),
              cam.unproject(torch.zeros(5, 3)))]
    jg, tg = jcam.geometry(jnp.asarray(kx), jnp.asarray(ky)), \
        cam.geometry(tkx, tky)
    pairs += [(jg[k], tg[k]) for k in ("cos_dir", "dist", "area")]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2.4e-7,
                                   atol=1e-7)


def test_lights_match_jax():
    """sample_direct and emission over a table of triangle lights and a
    point light, per-ray light picks from pick_uniform."""
    from rodent_tpu.render import light as jlight
    from rodent_tpu_torch.render import light as tlight
    r = np.random.RandomState(11)
    n_tri = 5
    v = r.randn(n_tri, 3, 3).astype(np.float32)
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = np.linalg.norm(nrm, axis=1)
    table = {"kind": np.asarray([1] * n_tri + [0], np.int32),
             "v0": np.concatenate([v[:, 0], [[0.5, 4.0, 0.5]]]),
             "v1": np.concatenate([v[:, 1], [[0, 0, 0]]]),
             "v2": np.concatenate([v[:, 2], [[0, 0, 0]]]),
             "n": np.concatenate([nrm / ln[:, None], [[0, 0, 1]]]),
             "inv_area": np.concatenate([2.0 / ln, [1.0]]),
             "color": r.rand(n_tri + 1, 3)}
    table = {k: np.asarray(x, np.float32 if k != "kind" else np.int32)
             for k, x in table.items()}
    rnd = r.randint(1, 2 ** 31, 4000).astype(np.uint32)
    pts = (r.randn(3, 4000) * 3).astype(np.float32)
    jt = {k: jnp.asarray(x) for k, x in table.items()}
    tt = {k: torch.from_numpy(x) for k, x in table.items()}
    jidx, jr = jlight.pick_uniform(n_tri + 1, jnp.asarray(rnd))
    tidx, tr = tlight.pick_uniform(n_tri + 1,
                                   torch.from_numpy(rnd.astype(np.int64)))
    js, _ = jlight.sample_direct(jt, jidx, jr, tuple(map(jnp.asarray, pts)))
    ts, _ = tlight.sample_direct(tt, tidx, tr,
                                 tuple(torch.from_numpy(c) for c in pts))
    out = tuple(torch.from_numpy(c) for c in pts)
    je = jlight.emission(jt, jidx, tuple(map(jnp.asarray, pts)))
    te = tlight.emission(tt, tidx, out)
    for want, got in ((js, ts), (je, te)):
        assert set(want) == set(got)
        for k in want:
            a = want[k] if isinstance(want[k], tuple) else (want[k],)
            b = got[k] if isinstance(got[k], tuple) else (got[k],)
            for x, y in zip(a, b):
                np.testing.assert_allclose(y.numpy(), np.asarray(x),
                                           rtol=1e-6, atol=1e-6)
