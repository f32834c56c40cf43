"""The port's scene tools against the JAX package's on the CPU: the
converter's data/ files byte for byte and load_data_dir back to
compile_obj's tables, the traversal file pipeline (ray_gen ->
bvh_extractor -> bench_traversal -> fbuf2png, the reference's ctest
traversal flow, cmake/test/run_traversal.cmake) on a closed box the test
writes (the cornell box is not mounted), and tools.render on an OBJ.
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

from rodent_tpu.render.compiler import load_data_dir as jload_data_dir
from rodent_tpu.tools import bvh_extractor as jbvh_extractor
from rodent_tpu.tools import converter as jconverter
from rodent_tpu.tools import fbuf2png as jfbuf2png
from rodent_tpu.tools import ray_gen as jray_gen
from rodent_tpu_torch.accel import WideBvh
from rodent_tpu_torch.io import formats, png
from rodent_tpu_torch.render import integrator
from rodent_tpu_torch.render.compiler import compile_obj, load_data_dir
from rodent_tpu_torch.tools import (bench_traversal, bvh_extractor,
                                    converter, fbuf2png, ray_gen, render)
from rodent_tpu_torch.traversal import api, packet
from test_textured_render import make_emissive_tex_scene, make_textured_scene
from test_torch_render import _assert_same_tree

torch.set_num_threads(1)

BOX = """mtllib box.mtl
v -1 0 -1
v  1 0 -1
v  1 2 -1
v -1 2 -1
v -1 0  1
v  1 0  1
v  1 2  1
v -1 2  1
v -0.3 1.99 -0.3
v  0.3 1.99 -0.3
v  0.3 1.99  0.3
v -0.3 1.99  0.3
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl wall
f 1/1 2/2 3/3 4/4
f 5/1 8/4 7/3 6/2
f 1/1 5/2 6/3 2/4
f 4/1 3/2 7/3 8/4
usemtl red
f 1/1 4/2 8/3 5/4
usemtl green
f 2/1 6/2 7/3 3/4
usemtl lamp
f 9 10 11 12
"""
BOX_MTL = """newmtl wall
Kd 1 1 1
map_Kd checker.png
newmtl red
Kd 0.6 0.1 0.1
newmtl green
Kd 0.1 0.6 0.1
Ks 0.2 0.2 0.2
Ns 20
newmtl lamp
Ke 6 6 6
"""


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """A closed, textured box with a ceiling lamp (12 + 2 triangles)."""
    d = tmp_path_factory.mktemp("box")
    img = np.zeros((8, 8, 3), np.uint8)
    img[:4, :4] = img[4:, 4:] = 200
    png.write_png(d / "checker.png", img)
    (d / "box.obj").write_text(BOX)
    (d / "box.mtl").write_text(BOX_MTL)
    return str(d / "box.obj")


def _same_tensors(want, got, path="device"):
    """Two of the port's device trees hold equal keys, equal tensors byte
    for byte and equal static values."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _same_tensors(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        assert (want.dtype, want.shape) == (got.dtype, got.shape), path
        assert want.numpy().tobytes() == got.numpy().tobytes(), path
    else:
        assert want == got, path


def _same_files(a, b):
    names = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


@pytest.mark.parametrize("scene,kw", [
    ("box", dict()), ("box", dict(pad=True, arity=4, max_path_len=7)),
    ("map_Ke", dict())])
def test_converter_files_byte_for_byte(tmp_path, box, scene, kw):
    """write_scene_data of both packages on the same OBJ: every file of
    data/ (LZ4 buffers, bvh.bin, scene.json, the stamp, the textures)
    equal byte for byte."""
    path = box if scene == "box" else make_emissive_tex_scene(tmp_path, True)
    want = jconverter.write_scene_data(path, str(tmp_path / "jax"), **kw)
    got = converter.write_scene_data(path, str(tmp_path / "port"), **kw)
    assert got == want
    names = _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert "bvh.bin" in names and "scene.json" in names
    assert any(n.startswith("textures") for n in names)


@pytest.mark.parametrize("scene", ["box", "map_Kd", "map_Ke"])
def test_load_data_dir(tmp_path, box, scene):
    """converter -> load_data_dir equals the JAX package's load_data_dir
    byte for byte, and compile_obj's tables where the OBJ's lights are
    untextured (the converter writes no emission-texture columns, so a
    map_Ke scene reloads with constant Ke in both packages)."""
    path = {"box": lambda: box,
            "map_Kd": lambda: make_textured_scene(tmp_path),
            "map_Ke": lambda: make_emissive_tex_scene(tmp_path, True)}[scene]()
    data = str(tmp_path / "data")
    converter.main([path, "-d", data, "--max-path-len", "7"])
    got = load_data_dir(data, "cpu")
    want = jload_data_dir(data)
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, want.device),
                      got.device)
    assert (got.materials, got.tex_files, got.num_lights) == (
        want.materials, want.tex_files, want.num_lights)
    direct = compile_obj(path, "cpu", max_path_len=7)
    assert got.tex_files == direct.tex_files and len(got.tex_files) == 1
    if scene == "map_Ke":
        assert "ke_tex" in direct.device["lights"]
        assert "ke_tex" not in got.device["lights"]
        return
    _same_tensors(direct.device, got.device)


def test_traversal_file_pipeline(tmp_path, box, capsys):
    """ray_gen, bvh_extractor and fbuf2png write the JAX tools' bytes on
    the closed box; bench_traversal's count and hit distances equal the
    port's traversal of the rays and BVH read back from those files, and
    every primary ray hits inside the box."""
    def both(tool, jtool, args):
        """Runs the port's and the JAX tool, "{}" in an argument standing
        for "port" or "jax"."""
        for t, tag in ((tool, "port"), (jtool, "jax")):
            assert t.main([str(x).replace("{}", tag) for x in args]) == 0
        capsys.readouterr()

    both(ray_gen, jray_gen, ["primary", 0, 1, 0.8, 0.4, -0.3, -1, 0, 1, 0, 60,
                             64, 48, tmp_path / "{}.rays"])
    both(ray_gen, jray_gen, ["random", box, 500, 3,
                             tmp_path / "{}-random.rays"])
    both(bvh_extractor, jbvh_extractor, [box, tmp_path / "{}.bvh",
                                         "--width", 8, "--width", 2])
    for name in ("{}.rays", "{}-random.rays", "{}.bvh"):
        assert (tmp_path / name.format("port")).read_bytes() == \
            (tmp_path / name.format("jax")).read_bytes(), name

    fbuf_f = tmp_path / "t.fbuf"
    assert bench_traversal.main([
        "-bvh", str(tmp_path / "port.bvh"), "-ray",
        str(tmp_path / "port.rays"), "--tmin",
        "0.001", "--tmax", "100", "--bench", "2", "-o", str(fbuf_f),
        "--cpu"]) == 0
    text = capsys.readouterr().out
    bvh = formats.read_bvh(str(tmp_path / "port.bvh"), formats.BVH8_TRI4)
    dev = api.bvh_to_device(WideBvh.from_block(bvh), "cpu")
    r = formats.read_rays(str(tmp_path / "port.rays"), tmin=0.001,
                          tmax=100.0)
    hit = packet.traverse_packet(dev, api.make_rays(
        r["org"], r["dir"], r["tmin"], r["tmax"]))
    n_hit = int((hit["prim_id"] >= 0).sum())
    assert n_hit == 64 * 48
    assert re.search(rf"^{n_hit} intersection\(s\)$", text, re.M)
    np.testing.assert_array_equal(formats.read_fbuf(str(fbuf_f)),
                                  hit["t"].numpy())
    both(fbuf2png, jfbuf2png, ["-n", "-sx", 64, "-sy", 48, fbuf_f,
                               tmp_path / "{}.png"])
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    img = png.read_png(str(tmp_path / "port.png"))
    assert img.shape == (48, 64, 4) and img[..., 0].std() > 5


def test_render_tool(tmp_path, box, capsys, monkeypatch):
    """tools.render --cpu at 16x12 prints the driver's Msamples line,
    writes a lit PNG and, with --profile, the stage report; every
    renderer and engine it offers runs, the dual-queue engine (--traversal
    tiled, --no-packet) and the dense engine (--traversal dense) among
    them, with their own engines and no kernel launch, and each gives the
    policy's film up to the tolerance of ROADMAP's film rule; without
    --cpu it needs a card."""
    out = tmp_path / "o.png"
    common = [box, "--cpu", "--width", "16", "--height", "12", "--eye", "0",
              "1", "0.9", "--dir", "0", "0", "-1", "--spp", "1",
              "--max-path-len", "4"]
    film = render.run(common + ["--bench", "2", "-o", str(out),
                                "--profile"])
    text = capsys.readouterr().out
    assert re.search(r"^# [\d.]+/[\d.]+/[\d.]+ \(min/med/max Msamples/s\)$",
                     text, re.M)
    assert "compile+render" in text and "tonemap" in text
    assert "Msamples/s" in text.splitlines()[-1]
    assert film.shape == (16 * 12, 3) and bool(torch.isfinite(film).all())
    img = png.read_png(str(out))
    assert img.shape == (12, 16, 3) and img.mean() > 5
    for extra in (["--progressive", "--sort", "on"], ["--debug"],
                  ["--traversal", "hybrid-hbm"], ["--traversal", "packet",
                                                  "--sort", "pool"]):
        assert render.main(common + extra) == 0
    assert capsys.readouterr().out.count("Msamples/s") == 4
    packet.reset_launches()
    for extra, engine in ((["--traversal", "tiled"], "traverse_components"),
                          (["--traversal", "dense"],
                           "traverse_dense_components"),
                          (["--no-packet"], "traverse_components")):
        calls = []
        fn = getattr(integrator, engine)
        monkeypatch.setattr(integrator, engine,
                            lambda *a, fn=fn, **k: calls.append(1) or fn(
                                *a, **k))
        got = render.run(common + ["--bench", "2"] + extra)
        monkeypatch.undo()
        assert calls, extra
        np.testing.assert_allclose(got.numpy(), film.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert capsys.readouterr().out.count("Msamples/s") == 3
    assert set(packet.launches.values()) == {0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        render.main([box])
