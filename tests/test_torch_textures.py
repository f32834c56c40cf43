"""The port's textures, textured lights, OBJ scenes and mathall against the
JAX package on the CPU.

The same seeded numpy inputs go through both packages:
- io.jpg decodes PIL-written JPEGs (baseline, progressive, grayscale,
  restart intervals) to the same bytes as the JAX package's decoder;
- render.texture: image_from_u8 and build_bank bit for bit, sample_texture
  and sample_bank within atol 1e-6 / rtol 1e-6 (XLA on the CPU may
  contract the blend's multiply-adds, C2);
- the light table with ke_tex byte for byte, and the sample_direct /
  emission rows that textured emission reads;
- compile_obj (map_Kd and map_Ke scenes the tests write) and mathall's
  compile_mesh(materials=, tex_images=) through _assert_same_tree;
- a textured film with the rule of test_render_iteration_matches_jax
  (rtol 1e-4 / atol 1e-5 on >= 99% of pixels, mean within 0.5%), and
  mathall's golden gate through both renderers.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodent_tpu.io import jpg as jjpg
from rodent_tpu.render import light as jlight
from rodent_tpu.render import texture as jtex
from rodent_tpu.render.camera import Camera as JCamera
from rodent_tpu.render.compiler import compile_mesh as jcompile_mesh
from rodent_tpu.render.compiler import compile_obj as jcompile_obj
from rodent_tpu.render.integrator import render_iteration as jrender
from rodent_tpu.utils import testscenes as jscenes
from rodent_tpu_torch.io import jpg
from rodent_tpu_torch.io import png
from rodent_tpu_torch.render import film as film_mod
from rodent_tpu_torch.render import light
from rodent_tpu_torch.render import texture
from rodent_tpu_torch.render.camera import Camera
from rodent_tpu_torch.render.compiler import (compile_mesh, compile_obj,
                                              from_jax_device)
from rodent_tpu_torch.render.integrator import (
    render_iteration, render_iteration_persistent)
from rodent_tpu_torch.utils import testscenes
from test_textured_render import make_emissive_tex_scene, make_textured_scene
from test_torch_render import _assert_same_tree

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
HALL_CAM = ((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0)

torch.set_num_threads(1)


def _tree(jscene):
    return jax.tree_util.tree_map(np.asarray, jscene.device)


# ---- io/jpg ----

JPEG_CASES = {
    "baseline-444": dict(quality=90, subsampling=0),
    "baseline-422": dict(quality=90, subsampling=1),
    "baseline-420": dict(quality=90, subsampling=2),
    "restarts": dict(quality=85, subsampling=0, restart_marker_blocks=2),
    "progressive-420": dict(quality=90, subsampling=2, progressive=True),
    "progressive-restarts": dict(quality=85, subsampling=0,
                                 progressive=True,
                                 restart_marker_blocks=2),
    "gray": dict(quality=95, mode="L"),
    "progressive-gray": dict(quality=95, progressive=True, mode="L"),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpg_decodes_as_jax(tmp_path, case):
    image = pytest.importorskip("PIL.Image")
    kw = dict(JPEG_CASES[case])
    mode = kw.pop("mode", "RGB")
    r = np.random.RandomState(len(case))
    arr = r.randint(0, 256, (33, 47, 3), np.uint8)
    if mode == "L":
        arr = arr[..., 0]
    path = tmp_path / "t.jpg"
    image.fromarray(arr, mode).save(path, "JPEG", **kw)
    want = jjpg.read_jpg(str(path))
    got = jpg.read_jpg(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape == (33, 47, 3)
    assert got.tobytes() == want.tobytes()
    # and the texture loader's PNG/JPEG dispatch reaches the same bytes
    np.testing.assert_array_equal(texture.load_texture(str(path)),
                                  jtex.load_texture(str(path)))


# ---- render/texture ----

def test_image_from_u8_and_build_bank_bit_for_bit(tmp_path):
    r = np.random.RandomState(3)
    imgs = [r.randint(0, 256, s, np.uint8)
            for s in ((5, 7, 3), (9, 4, 4), (6, 6), (3, 8, 2))]
    lin = [texture.image_from_u8(i) for i in imgs]
    for a, i in zip(lin, imgs):
        b = jtex.image_from_u8(i)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    bank, hw = texture.build_bank(lin)
    jbank, jhw = jtex.build_bank(lin)
    assert bank.tobytes() == jbank.tobytes() and hw.tobytes() == jhw.tobytes()
    png.write_png(tmp_path / "a.png", imgs[1])
    assert texture.load_texture(str(tmp_path / "a.png")).tobytes() == \
        jtex.load_texture(str(tmp_path / "a.png")).tobytes()


@pytest.mark.parametrize("flt", [texture.FILTER_NEAREST,
                                 texture.FILTER_BILINEAR])
@pytest.mark.parametrize("border", [texture.BORDER_CLAMP,
                                    texture.BORDER_REPEAT])
def test_sampling_matches_jax(border, flt):
    """sample_texture, make_texture and sample_bank on uv in [-3, 3] (and
    tiny negative uvs, where u - floor(u) rounds to 1.0), three textures
    of different sizes in one bank, negative ids reading texture 0."""
    r = np.random.RandomState(5)
    imgs = [r.rand(*s, 3).astype(np.float32)
            for s in ((7, 5), (16, 16), (3, 11))]
    uv = r.uniform(-3, 3, (4000, 2)).astype(np.float32)
    uv[:8] = -1e-9
    tid = r.randint(-1, 3, 4000).astype(np.int32)
    tuv = torch.from_numpy(uv)
    want = np.asarray(jtex.sample_texture(imgs[1], jnp.asarray(uv),
                                          border, flt))
    got = texture.sample_texture(imgs[1], tuv, border, flt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    closure = texture.make_texture(torch.from_numpy(imgs[1]), border, flt)
    np.testing.assert_array_equal(closure(tuv).numpy(), got)
    bank, hw = texture.build_bank(imgs)
    want = np.asarray(jtex.sample_bank(jnp.asarray(bank), jnp.asarray(hw),
                                       jnp.asarray(tid), jnp.asarray(uv),
                                       border, flt))
    got = texture.sample_bank(torch.from_numpy(bank), torch.from_numpy(hw),
                              torch.from_numpy(tid), tuv, border, flt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---- textured lights ----

@pytest.fixture(scope="module")
def ke_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("ke")
    return make_emissive_tex_scene(d, textured=True)


def test_light_table_with_ke_tex_byte_for_byte(ke_scene):
    from rodent_tpu.io import obj as jobj
    f = jobj.load_obj(ke_scene)
    mesh = jobj.compute_tri_mesh(f)
    ke = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
    emissive = mesh.tri_materials == 1
    for ke_tex in (None, [-1, -1], [-1, 0]):
        want = jlight.build_light_table(mesh, ke, emissive, ke_tex=ke_tex)
        got = light.build_light_table(mesh, ke, emissive, ke_tex=ke_tex)
        assert set(want[0]) == set(got[0])
        assert ("ke_tex" in got[0]) == (ke_tex == [-1, 0])
        for k in want[0]:
            assert want[0][k].dtype == got[0][k].dtype, k
            assert want[0][k].tobytes() == got[0][k].tobytes(), k
        assert want[1].tobytes() == got[1].tobytes()


def test_textured_light_rows_match_jax():
    """sample_direct's uv and ke_tex rows and emission's ke_tex row over a
    textured table of five triangle lights (two of them constant)."""
    r = np.random.RandomState(13)
    n_tri, n = 5, 4000
    v = r.randn(n_tri, 3, 3).astype(np.float32)
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = np.linalg.norm(nrm, axis=1)
    table = {"kind": np.ones(n_tri, np.int32),
             "v0": v[:, 0], "v1": v[:, 1], "v2": v[:, 2],
             "n": (nrm / ln[:, None]).astype(np.float32),
             "inv_area": (2.0 / ln).astype(np.float32),
             "color": r.rand(n_tri, 3).astype(np.float32),
             "uv0": r.rand(n_tri, 2).astype(np.float32),
             "uv1": r.rand(n_tri, 2).astype(np.float32),
             "uv2": r.rand(n_tri, 2).astype(np.float32),
             "ke_tex": np.asarray([0, -1, 1, -1, 0], np.int32)}
    rnd = r.randint(1, 2 ** 31, n).astype(np.uint32)
    pts = (r.randn(3, n) * 3).astype(np.float32)
    jt = {k: jnp.asarray(x) for k, x in table.items()}
    tt = {k: torch.from_numpy(x) for k, x in table.items()}
    jidx, jr = jlight.pick_uniform(n_tri, jnp.asarray(rnd))
    tidx, tr = light.pick_uniform(n_tri, torch.from_numpy(rnd.astype(np.int64)))
    js, _ = jlight.sample_direct(jt, jidx, jr, tuple(map(jnp.asarray, pts)))
    ts, _ = light.sample_direct(tt, tidx, tr,
                                tuple(torch.from_numpy(c) for c in pts))
    je = jlight.emission(jt, jidx, tuple(map(jnp.asarray, pts)))
    te = light.emission(tt, tidx, tuple(torch.from_numpy(c) for c in pts))
    assert set(js) == set(ts) and set(je) == set(te)
    np.testing.assert_array_equal(ts["ke_tex"].numpy(), np.asarray(js["ke_tex"]))
    np.testing.assert_array_equal(te["ke_tex"].numpy(), np.asarray(je["ke_tex"]))
    for a, b in zip(js["uv"], ts["uv"]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


# ---- compile_obj, compile_mesh with textures ----

@pytest.fixture(scope="module")
def kd_scene(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp("kd"))


@pytest.mark.parametrize("which", ["map_Kd", "map_Ke"])
def test_compile_obj_matches_jax(which, kd_scene, ke_scene):
    path = kd_scene if which == "map_Kd" else ke_scene
    want = jcompile_obj(path, max_path_len=3)
    got = compile_obj(path, "cpu", max_path_len=3)
    _assert_same_tree(_tree(want), got.device)
    assert got.tex_files == want.tex_files and len(got.tex_files) == 1
    assert got.materials == want.materials
    assert got.mat_params == want.mat_params
    assert got.num_lights == want.num_lights
    assert ("ke_tex" in got.device["lights"]) == (which == "map_Ke")
    _assert_same_tree(_tree(want), from_jax_device(_tree(want), "cpu"))


def test_compile_obj_cleanup_and_missing_texture(tmp_path):
    """cleanup_obj: an undefined material becomes the cyan dummy, two
    equal materials merge, an unused one goes; a map_Kd naming a file that
    does not exist is dropped from the bank (the material keeps kd)."""
    (tmp_path / "c.obj").write_text(
        "mtllib c.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nv 0 0 1\n"
        "usemtl a\nf 1 2 3\nusemtl b\nf 2 4 3\nusemtl nosuch\nf 1 3 5\n"
        "usemtl lamp\nf 1 5 2\n")
    (tmp_path / "c.mtl").write_text(
        "newmtl a\nKd 0.5 0.5 0.5\nmap_Kd gone.png\n"
        "newmtl b\nKd 0.5 0.5 0.5\nmap_Kd gone.png\n"
        "newmtl unused\nKd 1 0 0\nnewmtl lamp\nKe 3 3 3\n")
    path = str(tmp_path / "c.obj")
    want = jcompile_obj(path)
    got = compile_obj(path, "cpu")
    _assert_same_tree(_tree(want), got.device)
    assert got.materials == want.materials == ["", "a", "lamp"]
    assert got.tex_files == [] and "textures" not in got.device
    assert got.mat_params[0]["kd"] == (0.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def mathall():
    verts, idx = testscenes.make_hall(6000, rich_mats=True)
    mats, texs = testscenes.mat_hall_materials()
    jmats, jtexs = jscenes.mat_hall_materials()
    want = jcompile_mesh(verts, idx, max_path_len=4, emitter="inside",
                         materials=jmats, tex_images=jtexs)
    got = compile_mesh(verts, idx, "cpu", max_path_len=4, emitter="inside",
                       materials=mats, tex_images=texs)
    return want, got


def test_mathall_compile_mesh_matches_jax(mathall):
    want, got = mathall
    _assert_same_tree(_tree(want), got.device)
    _assert_same_tree(_tree(want), from_jax_device(_tree(want), "cpu"))
    assert got.tex_files == want.tex_files == ["checker", "plaster"]
    assert got.mat_params == want.mat_params
    assert float(got.device["texcoords"].abs().max()) > 0.5   # triplanar


def test_mathall_film_matches_jax(mathall):
    """mathall-6K (every BSDF kind, two textured materials), 32x24, spp 1,
    mpl 4, both packages on the JAX package's tables, with the rule of
    test_render_iteration_matches_jax. The JAX renderer runs op by op
    (jax.disable_jit), where XLA does not contract multiply-adds (ROADMAP
    C2): under jit 755 of 768 pixels (98.3%) agree, op by op 767 (99.9%),
    the mean within 1.2e-6, 739 pixels bit for bit."""
    want_scene, _ = mathall
    w, h = 32, 24
    with jax.disable_jit():
        want = np.asarray(jrender(
            want_scene.device, JCamera.make(*HALL_CAM, w, h),
            jnp.zeros((w * h, 3), jnp.float32), w, h, 1, 0, packet=False))
    scene = from_jax_device(_tree(want_scene), "cpu")
    got = render_iteration(scene, Camera.make(*HALL_CAM, w, h),
                           film_mod.new_film(w, h, "cpu"), w, h, 1, 0).numpy()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() / want.mean() - 1.0) < 5e-3
    assert np.isfinite(got).all() and got.min() >= 0.0
    # the 4-gather surface element gives the same film
    lean = {k: v for k, v in scene.items() if k != "tri_shade"}
    np.testing.assert_array_equal(
        render_iteration(lean, Camera.make(*HALL_CAM, w, h),
                         film_mod.new_film(w, h, "cpu"), w, h, 1, 0).numpy(),
        got)


def test_checker_shows_and_textured_emission_equals_constant(tmp_path,
                                                             kd_scene):
    """test_textured_render.py's two scenes through the port: the checker
    wall shows its pattern, and a solid white map_Ke renders as Ke 1 1 1
    (255 decodes to exactly 1.0) in both renderers."""
    w = h = 48
    cam = Camera.make((0, 0, 2.0), (0, 0, -1), (0, 1, 0), 60.0, w, h)
    scene = compile_obj(kd_scene, "cpu", max_path_len=2)
    film = film_mod.new_film(w, h, "cpu")
    for i in range(2):
        film = render_iteration(scene.device, cam, film, w, h, 2, i)
    img = film_mod.tonemap(film, w, h, 2)
    mid = img[h // 2, :, 0].astype(np.int32)
    assert np.abs(np.diff((mid > mid.mean()).astype(np.int32))).sum() >= 1
    assert img.std() > 8
    for render in (render_iteration, render_iteration_persistent):
        imgs = []
        for textured in (False, True):
            d = tmp_path / f"{render.__name__}-{textured}"
            d.mkdir()
            sc = compile_obj(make_emissive_tex_scene(d, textured), "cpu",
                             max_path_len=3)
            assert ("ke_tex" in sc.device["lights"]) == textured
            film = film_mod.new_film(w, h, "cpu")
            for i in range(2):
                film = render(sc.device, cam, film, w, h, 2, i)
            imgs.append(film.numpy())
        np.testing.assert_array_equal(imgs[0], imgs[1])
        assert film_mod.tonemap(imgs[1], w, h, 2).max() >= 10


@pytest.mark.parametrize("renderer", ["progressive", "persistent"])
def test_mathall_golden_gate(renderer):
    """mathall's gate of test_golden_scenes.py (mse_u8 <= 3 x calib + 1,
    image mean within 50%) through the port on the CPU, in the
    configuration of experiments/make_goldens.py (mathall-40K, emitter
    inside, 160x90, spp 2, 2 iterations, mpl 8). The golden was rendered
    with the dual-queue engine, which the port does not carry; both of
    the port's renderers run with packet=True."""
    with open(os.path.join(GOLDEN, "golden_meta.json")) as f:
        m = json.load(f)["mathall"]
    verts, idx = testscenes.make_hall(m["tris"], rich_mats=True)
    mats, texs = testscenes.mat_hall_materials()
    scene = compile_mesh(verts, idx, "cpu", max_path_len=8,
                         emitter="inside", materials=mats, tex_images=texs)
    w, h = m["w"], m["h"]
    cam = Camera.make(*HALL_CAM, w, h)
    render = (render_iteration if renderer == "progressive"
              else render_iteration_persistent)
    film = film_mod.new_film(w, h, "cpu")
    for it in range(m["test_iters"]):
        film = render(scene.device, cam, film, w, h, m["spp"], it,
                      packet=True)
    img = film_mod.tonemap(film, w, h, m["test_iters"])
    golden = png.read_png(os.path.join(GOLDEN, "mathall.png"))[..., :3]
    mse = film_mod.mse_u8(golden, img)
    assert mse <= 3.0 * m["calib_mse_u8"] + 1.0, mse
    assert abs(float(img.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"]
