"""The cornell programs of the port (rodent_tpu_torch.experiments.
ab_cornell_engine and measure_splat) on the CPU, and their stand-in scene.

The reference's cornell box is not in the repository, so both programs
run experiments.common's open box where --reference is absent; the tests
write a reference directory of their own (the stand-in as
testing/cornell_box.obj and a small ref-cornell.png) for the other branch.
The stand-in at the reference camera is held against the JAX renderer's
dense route op by op, under the film rule of tests/test_torch_dense.py
(at least 99% of pixels within rtol 1e-4 / atol 1e-5, the mean within
0.5%), and the port's films are equal bit for bit across the engines.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodent_tpu.render.camera import Camera as JCamera
from rodent_tpu.render.compiler import compile_obj as jcompile_obj
from rodent_tpu.render.integrator import (
    render_iteration_persistent as jpersistent)
from rodent_tpu_torch.experiments import (ab_cornell_engine, common,
                                          measure_splat)
from rodent_tpu_torch.io import png
from rodent_tpu_torch.render import compiler as tcomp
from rodent_tpu_torch.render import film as film_mod
from rodent_tpu_torch.render import integrator
from rodent_tpu_torch.render.camera import Camera
from rodent_tpu_torch.traversal import dense, packet
from test_torch_dense import assert_film_rule

torch.set_num_threads(1)

TINY = ["--cpu", "--wh", "24x16", "--spp", "1", "--iters", "2"]
ROW = (r"^{name} +[\d.]+ ms/iter \( *[\d.]+ Msamples/s\) steps \d+ K1 "
       r"launches 0 \[(?:ref|bit-identical)\]")

# chip_smoke.py's phase 16 boxes as its parent commit wrote them (the
# closed box, then the same box without its front wall), kept here so
# that moving them into experiments.common changes no byte
CLOSED = """mtllib box.mtl
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
usemtl wall
f 1 2 3 4
f 5 8 7 6
f 1 5 6 2
f 4 3 7 8
usemtl red
f 1 4 8 5
usemtl green
f 2 6 7 3
usemtl lamp
f 9 10 11 12
"""
OPEN = CLOSED.replace("f 5 8 7 6\n", "")
MTL = """newmtl wall
Kd 0.8 0.8 0.8
newmtl red
Kd 0.6 0.1 0.1
newmtl green
Kd 0.1 0.6 0.1
Ks 0.2 0.2 0.2
Ns 20
newmtl lamp
Ke 6 6 6
"""


def reference_dir(tmp_path, w=20, h=12, png_file=True):
    """A reference checkout: the stand-in as testing/cornell_box.obj (with
    its box.mtl) and, with png_file, a w x h testing/ref-cornell.png."""
    testing = tmp_path / "ref" / "testing"
    _, open_box = common.write_boxes(testing)
    (testing / "open.obj").rename(testing / "cornell_box.obj")
    (testing / "box.obj").unlink()
    if png_file:
        img = np.random.RandomState(18).randint(0, 256, (h, w, 3))
        png.write_png(str(testing / "ref-cornell.png"), img.astype(np.uint8))
    return str(tmp_path / "ref")


def test_write_boxes_bytes_and_dense_tier(tmp_path):
    """common.write_boxes writes phase 16's closed and open boxes byte for
    byte; the open box, the programs' stand-in, compiles to 12 triangles
    in the dense tier, where select_render_policy is one of the
    programs' variants."""
    box, open_box = common.write_boxes(tmp_path)
    assert (box, open_box) == (str(tmp_path / "box.obj"),
                               str(tmp_path / "open.obj"))
    assert (tmp_path / "box.obj").read_bytes() == CLOSED.encode()
    assert (tmp_path / "open.obj").read_bytes() == OPEN.encode()
    assert (tmp_path / "box.mtl").read_bytes() == MTL.encode()
    scene, ref, size, line = ab_cornell_engine.load_scene(None, "cpu", 64)
    assert scene.mesh.num_tris == 12 and ref is None
    assert size == ab_cornell_engine.STANDIN_WH == (1080, 720)
    assert "stand-in" in line and "no reference directory given" in line
    assert scene.device["bvh"]["tris"].shape[0] <= dense.DENSE_MAX_PACKETS
    assert tcomp.packet_mode(scene.device) == "dense"
    assert ab_cornell_engine.policy_variant(scene) == (
        {"packet": True, "retire_every": 2}, "packet+retire2")


def test_ab_cornell_engine_stand_in(tmp_path, capsys):
    """--cpu on the stand-in at 24x16 spp 1, 2 iterations: the scene line
    first, the policy, and the eight variants' rows, every film bit for
    bit the first's, no kernel launched."""
    absent = str(tmp_path / "absent")
    packet.reset_launches()
    assert ab_cornell_engine.main(TINY + ["--reference", absent]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("scene: the stand-in") and absent in lines[0]
    assert "cpu: the plain torch version" in lines[1]
    assert re.search(r"^cornell 24x16 spp1 mpl64 iters 2: packet_mode "
                     r"dense, select_render_policy \{'packet': True, "
                     r"'retire_every': 2\} = packet\+retire2$", out, re.M)
    for name in ab_cornell_engine.VARIANTS:
        assert re.search(ROW.format(name=re.escape(name)), out, re.M), name
    assert len(re.findall(r"\[bit-identical\]", out)) == 7
    assert re.search(r"^packet\+retire2 .*<- select_render_policy$", out,
                     re.M)
    assert set(packet.launches.values()) == {0}


def test_ab_cornell_engine_reference(tmp_path, capsys):
    """With a reference directory the program renders its
    cornell_box.obj at its ref-cornell.png's size."""
    ref = reference_dir(tmp_path)
    assert ab_cornell_engine.main(["--cpu", "--spp", "1", "--iters", "2",
                                   "--reference", ref]) == 0
    out = capsys.readouterr().out
    assert re.match(r"scene: the reference's .*cornell_box\.obj \(12 "
                    r"triangles\), .*ref-cornell\.png 20x12\n", out)
    assert "cornell 20x12 spp1" in out
    assert len(re.findall(r"\[bit-identical\]", out)) == 7


@pytest.mark.parametrize("prog", [ab_cornell_engine, measure_splat],
                         ids=["ab_cornell_engine", "measure_splat"])
def test_reference_without_a_file_raises(tmp_path, prog):
    """A reference directory that lacks ref-cornell.png raises
    FileNotFoundError, naming it."""
    ref = reference_dir(tmp_path, png_file=False)
    with pytest.raises(FileNotFoundError, match="ref-cornell.png"):
        prog.main(TINY + ["--reference", ref])


@pytest.mark.parametrize("with_ref", [True, False],
                         ids=["reference", "stand-in"])
def test_measure_splat(tmp_path, capsys, with_ref):
    """The rate line, then the MSE against ref-cornell.png where the
    reference exists, else the tonemapped film's mean and no MSE line."""
    if with_ref:
        argv = ["--reference", reference_dir(tmp_path)]
    else:
        argv = ["--reference", str(tmp_path / "absent"), "--wh", "24x16"]
    assert measure_splat.main(["--cpu", "--spp", "1", "--iters", "2"]
                              + argv) == 0
    out = capsys.readouterr().out
    size = "20x12" if with_ref else "24x16"
    assert re.search(rf"^cornell {size} spp1 packet=True: [\d.]+ ms/iter "
                     r"\([\d.]+ Msamples/s\) over 1 iters$", out, re.M)
    assert bool(re.search(r"^MSE vs ref at 2 iters: [\d.]+$", out, re.M)) \
        == with_ref
    assert ("no reference image: the tonemapped film's mean" in out) \
        != with_ref


def test_measure_splat_refuses_another_size(tmp_path):
    """The MSE needs the reference image's size: --wh may not differ."""
    with pytest.raises(SystemExit, match="not the reference image's size "
                       "20x12"):
        measure_splat.main(TINY + ["--reference", reference_dir(tmp_path)])


@pytest.mark.parametrize("prog", [ab_cornell_engine, measure_splat],
                         ids=["ab_cornell_engine", "measure_splat"])
def test_no_card_exits(tmp_path, monkeypatch, prog):
    """Without --cpu and without a card the programs exit with an error,
    not a CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        prog.main(["--reference", str(tmp_path / "absent")])


def test_ab_cornell_engine_raises_on_film_difference(monkeypatch):
    """A spy that perturbs the retire_every=2 film by one part in a
    million: the program raises, naming both variants."""
    real = integrator.render_iteration_persistent

    def spy(*args, **kw):
        film, steps = real(*args, **kw)
        if kw.get("retire_every") == 2:
            film = film * (1.0 + 1e-6)
        return film, steps

    monkeypatch.setattr(integrator, "render_iteration_persistent", spy)
    with pytest.raises(RuntimeError, match="the film of packet\\+retire2 "
                       "differs from dense's"):
        ab_cornell_engine.main(TINY + ["--variants",
                                       "dense,packet+retire2"])


def test_stand_in_film_matches_jax(tmp_path):
    """The stand-in at the reference camera, 16x12 spp 2 mpl 4: the port's
    dense route (the program's scene, compiled by the port) against the
    JAX renderer's dense route op by op under the film rule, and the
    port's packet+retire2 film (the dense tier's policy) equal to its
    dense film bit for bit."""
    w, h, spp = 16, 12, 2
    _, open_box = common.write_boxes(tmp_path)
    jscene = jcompile_obj(open_box, max_path_len=4)
    with jax.disable_jit():
        want = np.asarray(jpersistent(
            jscene.device, JCamera.make(*ab_cornell_engine.CORNELL_VIEW, w,
                                        h),
            jnp.zeros((w * h, 3), jnp.float32), w, h, spp, 0,
            packet="dense"))
    scene, _, _, _ = ab_cornell_engine.load_scene(None, "cpu", 4)
    cam = Camera.make(*ab_cornell_engine.CORNELL_VIEW, w, h)
    films = {name: integrator.render_iteration_persistent(
        scene.device, cam, film_mod.new_film(w, h, "cpu"), w, h, spp, 0,
        **ab_cornell_engine.VARIANTS[name]).numpy()
        for name in ("dense", "packet+retire2")}
    assert_film_rule(films["dense"], want)
    np.testing.assert_array_equal(films["packet+retire2"], films["dense"])
