"""rodent_tpu_torch.tools.quality_gate and .view against the JAX package's
tools on the CPU, and crown's golden gate through the dual-queue engine.

view: the camera rig's states after every key, apply_key's results and
ansi_frame's bytes equal the JAX tool's exactly, and a scripted session on
a closed box writes the JAX session's PNG. quality_gate: on the box,
open at the front, and a reference PNG, the port's MSE is within 1% of
the JAX tool's; its default reference, when absent, is an error that
names the missing file.
The JAX tools take the dense engine on the CPU (their
select_render_policy's CPU branch), the port K1's plain version (its
policy); the two engines find the same hits, so the films differ only by
XLA's contracted multiply-adds (ROADMAP C2).
"""
import json
import os

import numpy as np
import pytest
import torch

from rodent_tpu.tools import quality_gate as jquality_gate
from rodent_tpu.tools import view as jview
from rodent_tpu_torch.io import png
from rodent_tpu_torch.render import film as film_mod
from rodent_tpu_torch.render.camera import Camera
from rodent_tpu_torch.render.compiler import compile_mesh, compile_obj
from rodent_tpu_torch.render.integrator import render_iteration_persistent
from rodent_tpu_torch.tools import quality_gate, view
from rodent_tpu_torch.traversal import packet
from rodent_tpu_torch.utils import testscenes
from test_torch_scene_tools import BOX, BOX_MTL

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """The box of test_torch_scene_tools.py with its texture, and the same
    box open at z = +1 (cornell-like: the gate's fixed camera looks in
    from z = 2.7). Returns (directory, closed OBJ, open OBJ)."""
    d = tmp_path_factory.mktemp("box")
    img = np.zeros((8, 8, 3), np.uint8)
    img[:4, :4] = img[4:, 4:] = 200
    png.write_png(str(d / "checker.png"), img)
    (d / "box.obj").write_text(BOX)
    front = "f 5/1 8/4 7/3 6/2\n"
    assert front in BOX
    (d / "open.obj").write_text(BOX.replace(front, ""))
    (d / "box.mtl").write_text(BOX_MTL)
    return d, str(d / "box.obj"), str(d / "open.obj")


def test_view_rig_and_keys_match_jax():
    """Every key, in a sequence that moves, turns, changes the speed,
    saves and quits: the same return values and the same rig, bit for
    bit."""
    rig = view.CameraRig((0.3, 1.0, 2.7), (0.1, -0.2, -1.0), (0, 1, 0))
    jrig = jview.CameraRig((0.3, 1.0, 2.7), (0.1, -0.2, -1.0), (0, 1, 0))
    speed = jspeed = 0.1
    for key in "UDLRwsad+-UwpqX\x1bLd":
        *flags, speed = view.apply_key(rig, key, speed)
        *jflags, jspeed = jview.apply_key(jrig, key, jspeed)
        assert flags == jflags and speed == jspeed, key
        for attr in ("eye", "dir", "right", "up"):
            a, b = getattr(rig, attr), getattr(jrig, attr)
            assert a.tobytes() == b.tobytes(), (key, attr)
    np.testing.assert_array_equal(
        view.rotate_about((1.0, 2.0, 3.0), (0.0, 0.6, 0.8), 0.3),
        jview.rotate_about((1.0, 2.0, 3.0), (0.0, 0.6, 0.8), 0.3))
    assert view.ROT_STEP == jview.ROT_STEP


def test_ansi_frame_matches_jax():
    """The same image gives the same ANSI string, odd heights rounded
    down."""
    img = np.random.RandomState(3).randint(0, 256, (7, 5, 3)).astype(
        np.uint8)
    assert view.ansi_frame(img) == jview.ansi_frame(img)
    assert view.ansi_frame(img).count("\n") == 2


def test_view_scripted_matches_jax(box, tmp_path):
    """A scripted session (render, move, save with 'p', quit with 'q') on
    the box writes a lit PNG equal to the JAX session's up to a u8 step
    on at most 1% of its values, without a tty and without the frames.
    Measured: the two PNGs equal."""
    args = [box[1], "--eye", "0", "1", "0.9", "--dir", "0", "0", "-1",
            "--width", "16", "--height", "12", "--spp", "1",
            "--max-path-len", "3", "--iters", "4", "--keys", "Upq",
            "--quiet", "--cpu", "-o"]
    packet.reset_launches()
    assert view.main(args + [str(tmp_path / "port.png")]) == 0
    assert set(packet.launches.values()) == {0}
    assert jview.main(args + [str(tmp_path / "jax.png")]) == 0
    got = png.read_png(str(tmp_path / "port.png")).astype(int)
    want = png.read_png(str(tmp_path / "jax.png")).astype(int)
    assert got.shape == (12, 16, 3) and got.mean() > 1
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_quality_gate_matches_jax(box, capsys):
    """The gate on the open box at 32x24, 2 iterations x 4 spp, against a
    reference PNG rendered by the port at 8 iterations: the port's MSE
    within 1% of the JAX tool's, PASS under the default threshold and FAIL
    (exit code 1) under a threshold of 0; --fast and --checkpoints print
    their lines. Measured: MSE 75.22 from both tools."""
    d, _, obj = box
    w, h = 32, 24
    scene = compile_obj(obj, "cpu", max_path_len=64)
    film = film_mod.new_film(w, h, "cpu")
    cam = Camera.make(*quality_gate.CAMERA, w, h)
    for it in range(8):
        film = render_iteration_persistent(scene.device, cam, film, w, h, 4,
                                           it)
    ref = str(d / "ref.png")
    png.write_png(ref, film_mod.tonemap(film, w, h, 8))
    args = ["--cpu", "--scene", obj, "--ref", ref, "--iters", "2"]

    def mse(text):
        line = [x for x in text.splitlines() if x.startswith("cornell")]
        return float(line[0].split("MSE=")[1].split()[0])

    assert quality_gate.main(args) == 0
    text = capsys.readouterr().out
    assert text.strip().splitlines()[-1] == "PASS"
    got = mse(text)
    assert jquality_gate.main(args) == 0
    want = mse(capsys.readouterr().out)
    assert abs(got / want - 1.0) < 0.01, (got, want)
    assert got > 1.0
    assert quality_gate.main(args + ["--threshold", "0"]) == 1
    assert "FAIL: MSE" in capsys.readouterr().out
    assert quality_gate.main(args + ["--fast", "--checkpoints", "1,2",
                                     "--threshold", "1e9"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [x.split(":")[0] for x in lines[:2]] == [
        "checkpoint     1 iters (4 spp)", "checkpoint     2 iters (8 spp)"]
    assert lines[2].startswith("cornell 4x3, 2 iters x 4 spp: MSE=")


def test_quality_gate_names_missing_reference(tmp_path, monkeypatch):
    """Without --scene and --ref the gate reads the reference checkout
    named by RODENT_REFERENCE; where its file is missing, the gate exits
    with an error naming that file (a gate that cannot run is not a
    pass). Without --cpu it needs a card."""
    monkeypatch.setenv(quality_gate.REFERENCE_ENV, str(tmp_path / "ref"))
    missing = str(tmp_path / "ref" / "testing" / "cornell_box.obj")
    with pytest.raises(SystemExit, match=f"{missing} does not exist"):
        quality_gate.main(["--cpu"])
    (tmp_path / "ref" / "testing").mkdir(parents=True)
    (tmp_path / "ref" / "testing" / "cornell_box.obj").write_text(BOX)
    with pytest.raises(SystemExit, match="ref-cornell.png does not exist"):
        quality_gate.main(["--cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        quality_gate.main([])
    with pytest.raises(SystemExit, match="no CUDA card"):
        view.main(["scene.obj"])


def test_crown_golden_gate_tiled():
    """Crown's golden gate in the golden's own configuration
    (experiments/make_goldens.py: render_iteration_persistent with
    packet=False, compact=5; crown-60K, 160x90, spp 2, 2 iterations):
    mse_u8 <= 3 x calib + 1 and the image mean within half the golden's,
    on the dual-queue engine alone. Measured: MSE 338.98 <= 1017.88,
    image mean 40.63 (golden 45.08), as on K1."""
    with open(os.path.join(GOLDEN, "golden_meta.json")) as f:
        m = json.load(f)["crown"]
    verts, idx = testscenes.make_crown(m["tris"])
    scene = compile_mesh(verts, idx, "cpu", max_path_len=8, emitter="above")
    w, h = m["w"], m["h"]
    cam = Camera.make((4.2, 1.8, 1.2), (-4.2, -1.4, -1.2), (0, 1, 0), 42.0,
                      w, h)
    film = film_mod.new_film(w, h, "cpu")
    packet.reset_launches()
    for it in range(m["test_iters"]):
        film = render_iteration_persistent(scene.device, cam, film, w, h,
                                           m["spp"], it, packet=False,
                                           compact=5)
    assert set(packet.launches.values()) == {0}
    img = film_mod.tonemap(film, w, h, m["test_iters"])
    golden = png.read_png(os.path.join(GOLDEN, "crown.png"))[..., :3]
    mse = film_mod.mse_u8(golden, img)
    assert mse <= 3.0 * m["calib_mse_u8"] + 1.0, mse
    assert abs(float(img.mean()) - m["mean_u8"]) < 0.5 * m["mean_u8"]
