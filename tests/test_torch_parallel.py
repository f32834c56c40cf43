"""The port's sharded renderers, ray-sharded traversal and shard accounting
(rodent_tpu_torch.parallel) on the CPU, against the port's single-device
renderers and the JAX package's parallel module.

One group of 4 gloo ranks (run_group, spawned once for the module) runs
every sharded call: the progressive and persistent films at (n_px, n_sp) =
(4, 1), (2, 2), (1, 4) and on an uneven image, traverse_sharded on both
engines, and tools.render / tools.bench_traversal with --sharded. The JAX
side runs on the 8 virtual CPU devices of tests/conftest.py, its sharded
persistent program compiled once.

Tolerances: films against the port's single-device film rtol/atol 1e-5
(the bound of tests/test_parallel.py), bit for bit where each pixel's sum
has at most two terms; against the JAX sharded film, ROADMAP's film rule
(98.5% of pixels within rtol 1e-4 / atol 1e-5, the mean within 0.5%: XLA
contracts multiply-adds, ROADMAP C2); hits prim_id exact, t within atol
1e-5 / rtol 1e-6.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rodent_tpu.parallel import accounting as jacc
from rodent_tpu.parallel import mesh as jmesh
from rodent_tpu.render import compiler as jcomp
from rodent_tpu.render.camera import Camera as JCamera
from rodent_tpu.traversal.api import make_rays as jmake_rays
from rodent_tpu.utils import testscenes
from rodent_tpu_torch.accel import build_bvh
from rodent_tpu_torch.io import formats, png
from rodent_tpu_torch.parallel import accounting, mesh
from rodent_tpu_torch.render import compiler as tcomp
from rodent_tpu_torch.render import film as film_mod
from rodent_tpu_torch.render import integrator
from rodent_tpu_torch.render.camera import Camera
from rodent_tpu_torch.tools import bench_traversal, bvh_extractor, ray_gen
from rodent_tpu_torch.tools import render as render_tool
from rodent_tpu_torch.traversal import api, packet, pair
from test_torch_scene_tools import BOX, BOX_MTL

torch.set_num_threads(1)

HALL_CAM = ((2.5, 5.0, 5.0), (1.0, -0.12, 0.02), (0, 1, 0), 60.0)
W, H = 32, 24
UW, UH = 31, 9                  # 279 pixels: not a multiple of n_px 4
SHAPES = ((4, 1), (2, 2), (1, 4))
N_RAYS = 8 * 37 + 3             # uneven: dead padding rays in the split
BOX_ARGS = ["--cpu", "--width", "16", "--height", "12", "--eye", "0", "1",
            "0.9", "--dir", "0", "0", "-1", "--spp", "2",
            "--max-path-len", "4"]


def _spp(n_sp):
    return 4 if n_sp == 4 else 2


def _new_film(w=W, h=H):
    return film_mod.new_film(w, h, "cpu")


@pytest.fixture(scope="module")
def hall():
    """hall-20K compiled by the JAX package, and the port's copy of its
    tables (test_torch_render.py holds the two byte for byte)."""
    verts, idx = testscenes.make_hall(20_000)
    jscene = jcomp.compile_mesh(verts, idx, max_path_len=4,
                                emitter="inside")
    scene = tcomp.from_jax_device(
        jax.tree_util.tree_map(np.asarray, jscene.device), "cpu")
    return jscene, scene


def _rays():
    r = np.random.RandomState(11)
    org = np.tile(np.asarray([[2.5, 5.0, 5.0]], np.float32), (N_RAYS, 1))
    d = r.randn(N_RAYS, 3).astype(np.float32)
    return org, d, np.zeros(N_RAYS, np.float32), np.full(N_RAYS, 1e30,
                                                          np.float32)


@pytest.fixture(scope="module")
def box_files(tmp_path_factory):
    """The closed box of test_torch_scene_tools.py as OBJ, its BVH8 and
    64x48 primary rays as .bvh and .rays files."""
    d = tmp_path_factory.mktemp("box")
    img = np.zeros((8, 8, 3), np.uint8)
    img[:4, :4] = img[4:, 4:] = 200
    png.write_png(d / "checker.png", img)
    (d / "box.obj").write_text(BOX)
    (d / "box.mtl").write_text(BOX_MTL)
    assert ray_gen.main(["primary", "0", "1", "0.8", "0.4", "-0.3", "-1",
                         "0", "1", "0", "60", "64", "48",
                         str(d / "cam.rays")]) == 0
    assert bvh_extractor.main([str(d / "box.obj"), str(d / "box.bvh"),
                               "--width", "8"]) == 0
    return d


def _bench_args(d, out, *extra):
    return ["-bvh", str(d / "box.bvh"), "-ray", str(d / "cam.rays"),
            "--tmin", "0.001", "--tmax", "100", "--bench", "1",
            "--warmup", "1", "-o", str(out), *extra]


@pytest.fixture(scope="module")
def group(hall, box_files):
    """Every sharded call of the module on one group of 4 gloo ranks.
    Returns {name: per-rank list of run_calls results}."""
    _, scene = hall
    cam = Camera.make(*HALL_CAM, W, H)
    ucam = Camera.make(*HALL_CAM, UW, UH)
    calls, names = [], []

    def add(name, fn, shape, args, kwargs=None):
        names.append(name)
        calls.append((fn, shape, args, kwargs or {}))

    for npx, nsp in SHAPES:
        args = (scene, cam, _new_film(), W, H, _spp(nsp), 0)
        add(("progressive", npx, nsp), mesh.render_iteration_sharded,
            (npx, nsp), args)
        add(("persistent", npx, nsp),
            mesh.render_iteration_persistent_sharded, (npx, nsp), args,
            {"return_steps": True})
    uargs = (scene, ucam, _new_film(UW, UH), UW, UH, 2, 0)
    add("uneven progressive", mesh.render_iteration_sharded, (4, 1), uargs)
    add("uneven persistent", mesh.render_iteration_persistent_sharded,
        (4, 1), uargs)
    add("persistent tiled", mesh.render_iteration_persistent_sharded, (2, 2),
        (scene, cam, _new_film(), W, H, 2, 0), {"packet": False})
    rays = api.make_rays(*_rays())
    for engine in ("tiled", "packet"):
        add(("traverse", engine), mesh.traverse_sharded, (4, 1),
            (scene["bvh"], rays), {"engine": engine})
    # the big-scene engine with the carry-top body: K7-PF on a card
    add(("traverse", "packet-hbm"), mesh.traverse_sharded, (4, 1),
        (scene["bvh"], rays), {"engine": "packet-hbm", "carry_top": True})
    add("tools.render", render_tool.run, None,
        ([str(box_files / "box.obj"), "--sharded", *BOX_ARGS],))
    add("tools.bench_traversal", bench_traversal.main, None,
        (_bench_args(box_files, box_files / "sharded.fbuf", "--sharded",
                     "--cpu"),))
    ranks = mesh.run_group(mesh.run_calls, 4, "gloo", calls, "cpu",
                           timeout=300)
    return {name: [r[i] for r in ranks] for i, name in enumerate(names)}


def _single(scene, renderer, spp, w=W, h=H, **kw):
    fn = (integrator.render_iteration if renderer == "progressive"
          else integrator.render_iteration_persistent)
    return fn(scene, Camera.make(*HALL_CAM, w, h), _new_film(w, h), w, h,
              spp, 0, **kw).numpy()


def _film(res):
    out = res["out"]
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("renderer", ["progressive", "persistent"])
@pytest.mark.parametrize("npx,nsp", SHAPES)
def test_sharded_film_matches_single(hall, group, renderer, npx, nsp):
    """hall-20K, 32x24, mpl 4, K1's plain version: the sharded film on
    every rank equals the single-device film within 1e-5; at spp 2 ((4, 1)
    and (2, 2)) bit for bit, since each pixel's sum has two terms; at
    (1, 4), spp 4, the sp sum of four partials rounds otherwise than the
    single film's running sum (measured: max |difference| 6e-8)."""
    res = group[(renderer, npx, nsp)]
    want = _single(hall[1], renderer, _spp(nsp))
    got = _film(res[0])
    assert got.shape == (W * H, 3)
    for r in res[1:]:
        np.testing.assert_array_equal(_film(r), got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if nsp < 4:
        np.testing.assert_array_equal(got, want)


def test_render_sample_pixel_ids(hall):
    """render_sample with pixel_ids: on a strip film (one row per id) the
    rows of the whole-image pass at those ids, on a whole-image film the
    same rows scattered to the ids and nothing else."""
    _, scene = hall
    cam = Camera.make(*HALL_CAM, W, H)
    full = integrator.render_sample(scene, cam, _new_film(), W, H, 1, 0)
    ids = torch.arange(5, W * H, 7)
    strip = integrator.render_sample(scene, cam, torch.zeros(len(ids), 3),
                                     W, H, 1, 0, pixel_ids=ids)
    torch.testing.assert_close(strip, full[ids], rtol=0, atol=0)
    scattered = integrator.render_sample(scene, cam, _new_film(), W, H, 1, 0,
                                         pixel_ids=ids)
    want = torch.zeros_like(full)
    want[ids] = full[ids]
    torch.testing.assert_close(scattered, want, rtol=0, atol=0)


def test_sharded_uneven_image(hall, group):
    """31x9 = 279 pixels over 4 px ranks: the padded strip's extra rows
    are traced and dropped, the image is the single-device one."""
    for renderer in ("progressive", "persistent"):
        got = _film(group[f"uneven {renderer}"][0])
        want = _single(hall[1], renderer, 2, UW, UH)
        assert got.shape == want.shape == (UW * UH, 3)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_films(hall):
    """The JAX sharded persistent film (dual-queue engine, its default) on
    make_mesh(n_px=2, n_sp=2) of the 8 virtual devices, and its measured
    shard steps."""
    jscene, _ = hall
    cam = JCamera.make(*HALL_CAM, W, H)
    film = np.asarray(jmesh.render_iteration_persistent_sharded(
        jscene.device, cam, jnp.zeros((W * H, 3), jnp.float32), W, H, 2, 0,
        jmesh.make_mesh(n_px=2, n_sp=2)))
    steps = jacc.measure_shard_steps(jscene.device, cam, W, H, 2, n_px=2,
                                     n_sp=2)
    return film, steps


def test_persistent_sharded_matches_jax(group, jax_films):
    """The port's sharded persistent film on 4 ranks (dual-queue engine,
    packet=False, as the JAX default) against the JAX sharded film, by
    ROADMAP's film rule (C2)."""
    want, _ = jax_films
    got = _film(group["persistent tiled"][0])
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.985, close.mean()
    assert abs(got.mean() / want.mean() - 1.0) < 5e-3
    np.testing.assert_array_equal(got, _film(group[("persistent", 2, 2)][0]))


@pytest.mark.parametrize("engine", ["tiled", "packet", "packet-hbm"])
def test_traverse_sharded_matches_jax(hall, group, engine):
    """299 rays over 4 ranks (dead padding rays in the last share) against
    the JAX traverse_sharded over 8 devices: its dual-queue engine, and for
    engine="packet-hbm" with carry_top=True (the carry-top body with the
    next-pop prefetch, K7-PF on a card) its own packet-hbm engine with
    carry_top=True (_kernel_ct with tris_hbm and the prefetch, in interpret
    mode, in tiles of 4 rows)."""
    jscene, _ = hall
    kw = ({"engine": "packet-hbm", "carry_top": True, "tile_rows": 4}
          if engine == "packet-hbm" else {})
    want = jmesh.traverse_sharded(jscene.device["bvh"],
                                  jmake_rays(*map(jnp.asarray, _rays())),
                                  **kw)
    for res in group[("traverse", engine)]:
        got = res["out"]
        assert got["t"].shape == (N_RAYS,)
        np.testing.assert_array_equal(got["prim_id"],
                                      np.asarray(want["prim_id"]))
        np.testing.assert_allclose(got["t"], np.asarray(want["t"]),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("w,h,spp,npx,nsp", [
    (50, 34, 2, 8, 1), (50, 34, 2, 4, 2), (1920, 1088, 4, 2, 2),
    (31, 9, 4, 4, 4), (7, 3, 1, 32, 1)])
def test_shard_plan_matches_jax(w, h, spp, npx, nsp):
    assert accounting.shard_plan(w, h, spp, npx, nsp) == jacc.shard_plan(
        w, h, spp, npx, nsp)


def test_measure_shard_steps(hall, group, jax_films):
    """measure_shard_steps at (n_px, n_sp) = (2, 2), 32x24, spp 2: the
    port's (K1's plain version), the JAX package's (its dual-queue engine)
    and the steps the ranks of the port's sharded run report are equal."""
    _, scene = hall
    steps = accounting.measure_shard_steps(
        scene, Camera.make(*HALL_CAM, W, H), W, H, 2, n_px=2, n_sp=2)
    assert steps.shape == (2, 2) and steps.dtype == np.int64
    np.testing.assert_array_equal(steps, jax_films[1])
    for res in group[("persistent", 2, 2)]:
        np.testing.assert_array_equal(res["out"][1], steps)


def test_tools_sharded(box_files, group, capsys):
    """tools.render --sharded and bench_traversal --sharded --cpu on the 4
    ranks give the film and the .fbuf of the unsharded tools; run alone,
    each starts a group of one rank, says so and ends it."""
    d = box_files
    want = render_tool.run([str(d / "box.obj"), *BOX_ARGS]).numpy()
    for res in group["tools.render"]:
        np.testing.assert_array_equal(res["out"], want)
    assert bench_traversal.main(_bench_args(d, d / "one.fbuf", "--cpu")) == 0
    assert [r["out"] for r in group["tools.bench_traversal"]] == [0] * 4
    np.testing.assert_array_equal(formats.read_fbuf(str(d / "sharded.fbuf")),
                                  formats.read_fbuf(str(d / "one.fbuf")))
    capsys.readouterr()
    film = render_tool.run([str(d / "box.obj"), "--sharded", *BOX_ARGS])
    np.testing.assert_array_equal(film.numpy(), want)
    assert bench_traversal.main(_bench_args(d, d / "g1.fbuf", "--sharded",
                                            "--cpu")) == 0
    text = capsys.readouterr().out
    assert len(re.findall(r"^# sharded over 1 rank\(s\) \(gloo\)", text,
                          re.M)) == 2
    assert not dist.is_initialized()


def test_make_mesh_needs_a_matching_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(n_px=1, device="cpu")
    assert mesh.init_group(cpu=True)
    try:
        with pytest.raises(ValueError, match="ranks"):
            mesh.make_mesh(n_px=2, device="cpu")
        m = mesh.make_mesh(device="cpu")
        assert (m.n_sp, m.n_px, m.sp, m.px, m.rank) == (1, 1, 0, 0, 0)
        assert not mesh.init_group(cpu=True)
    finally:
        dist.destroy_process_group()


def test_make_mesh_makes_the_rank_card_current(monkeypatch):
    """A rank's card becomes its process's current CUDA device, so that
    what the rank's libraries launch on the current device runs on its own
    card (a spy stands in for torch.cuda.set_device); a CPU mesh sets
    none."""
    chosen = []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    assert mesh.init_group(cpu=True)
    try:
        mesh.make_mesh(device="cpu")
        assert chosen == []
        m = mesh.make_mesh(device="cuda:3")
        assert m.device == torch.device("cuda:3")
        assert chosen == [torch.device("cuda:3")]
    finally:
        dist.destroy_process_group()


class _Card:
    """Spies for a card: torch.cuda.device as a context that records the
    device it makes current, torch.cuda.current_stream, and a library whose
    C entries record the current device when they are called."""

    def __init__(self):
        self.current, self.calls = [None], []

    def device(self, dev):
        card = self

        class Guard:
            def __enter__(self):
                card.current.append(torch.device(dev))

            def __exit__(self, *exc):
                card.current.pop()
        return Guard()

    def current_stream(self, dev=None):
        return type("Stream", (), {"cuda_stream": 0})()

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, self.current[-1]))
            return 0
        return call


@pytest.mark.parametrize("kernel", ["bvh_traverse", "bvh_traverse_prefetch",
                                    "bvh_traverse_tile", "bvh_traverse_pair"])
def test_kernel_wrappers_launch_on_their_tensors_card(monkeypatch, kernel):
    """The C entries launch on the current CUDA device, which in a rank of
    a multi-card group need not be the card its tensors lie on: each
    wrapper (K1, K2, K5, K6) calls its entry with its tensors' device made
    current around the call, and only there. Spies stand in for the card
    (_Card); the tensors lie on the CPU, whose device the guard must name."""
    card = _Card()
    monkeypatch.setattr(torch.cuda, "device", card.device)
    monkeypatch.setattr(torch.cuda, "current_stream", card.current_stream)
    for mod in (packet, pair):
        monkeypatch.setattr(mod, "load_library", lambda kind: card)
    monkeypatch.setitem(packet.launches, kernel, packet.launches[kernel])
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                       np.float32)
    idx = np.asarray([[0, 1, 2], [0, 1, 3], [0, 2, 3]], np.int32)
    dev = api.bvh_to_device(build_bvh(verts, idx, arity=8, packet=8), "cpu")
    rays = api.make_rays(*[x[:8] for x in _rays()], device="cpu")
    comps = [x.contiguous() for x in (
        *rays["inv_dir"].unbind(-1), *rays["org"].unbind(-1),
        *rays["dir"].unbind(-1), rays["tmin"], rays["tmax"])]
    if kernel == "bvh_traverse_tile":
        packet._launch_tile(dev, comps, False, 1, "plain")
    elif kernel == "bvh_traverse_pair":
        pair._launch(dev, comps, False, pair.TILE_RAYS, ())
    else:
        packet._launch(dev, comps, False, kernel)
    entry = {"bvh_traverse_tile": "rt_bvh_traverse_tile",
             "bvh_traverse_pair": "rt_bvh_traverse_pair"}.get(
                 kernel, packet._ENTRY.get(kernel))
    assert card.calls == [(entry, torch.device("cpu"))]
    assert card.current == [None]
