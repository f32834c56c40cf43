"""rodent_tpu_torch.traversal.dense (every Tri packet against every ray)
against rodent_tpu.traversal.dense on the CPU, and both renderers on it
against the JAX renderer's dense route.

Traversal: the JAX test's soup (tests/test_traversal.py:182-207: 100
triangles, 300 rays with every fifth dead) and BVH8 builds with Tri4/8/16
rows: prim_id/geom_id exact, t/u/v within rtol 1e-5 / atol 1e-6 (the JAX
test's tolerance), any-hit hit/miss exact, and the same hits as the port's
BVH traversal. Films: a closed box with a ceiling lamp (the dense tier),
the JAX films op by op (ROADMAP C2), under the North star's rule: at least
99% of pixels within rtol 1e-4 / atol 1e-5 and the mean within 0.5%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodent_tpu.accel import build_bvh
from rodent_tpu.io import png as jpng
from rodent_tpu.render.camera import Camera as JCamera
from rodent_tpu.render.compiler import compile_obj as jcompile_obj
from rodent_tpu.render.integrator import render_iteration as jprogressive
from rodent_tpu.render.integrator import (
    render_iteration_persistent as jpersistent)
from rodent_tpu.traversal import api as japi
from rodent_tpu.traversal.dense import traverse_dense as jdense
from rodent_tpu_torch.render import compiler as tcomp
from rodent_tpu_torch.render import film as film_mod
from rodent_tpu_torch.render import integrator
from rodent_tpu_torch.render.camera import Camera
from rodent_tpu_torch.traversal import api as tapi
from rodent_tpu_torch.traversal import dense, packet
from test_torch_scene_tools import BOX, BOX_MTL
from test_traversal import random_rays, random_tri_soup

BOX_CAM = ((0.0, 1.0, 0.9), (0.0, 0.0, -1.0), (0, 1, 0), 60.0)
W, H, SPP = 16, 12, 2

# Small shapes, run beside other pytest-xdist workers: one intra-op
# thread keeps torch's thread pool from contending with them.
torch.set_num_threads(1)


def _to_torch(rays):
    return {k: torch.from_numpy(np.array(v)) for k, v in rays.items()}


@pytest.mark.parametrize("m", [4, 8, 16])
def test_dense_matches_jax(m):
    """Closest-hit against the JAX dense engine and the port's BVH
    traversal, dead slots included; any-hit against the JAX engine's."""
    verts, idx = random_tri_soup(100, seed=61)
    bvh = build_bvh(verts, idx, arity=8, packet=m)
    jdev = japi.bvh_to_device(bvh)
    tdev = tapi.bvh_to_device(bvh, "cpu")
    rays = random_rays(300, seed=67)
    rays["tmax"] = rays["tmax"].at[::5].set(-1.0)
    want = jdense(jdev, rays)
    got = dense.traverse_dense(tdev, _to_torch(rays))
    for k in ("prim_id", "geom_id"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    dead = np.asarray(rays["tmax"]) < 0
    assert (got["prim_id"].numpy()[dead] == -1).all()
    np.testing.assert_array_equal(got["t"].numpy()[dead], -1.0)
    bvh_hit = tapi.traverse(tdev, _to_torch(rays))
    for k in ("t", "u", "v", "prim_id", "geom_id"):
        assert torch.equal(got[k], bvh_hit[k]), k
    assert (got["prim_id"] >= 0).sum() > 0

    short = random_rays(256, seed=71, tmax=2.0)
    blocked = dense.traverse_dense(tdev, _to_torch(short), any_hit=True)
    want = np.asarray(jdense(jdev, short, any_hit=True)["prim_id"]) >= 0
    np.testing.assert_array_equal(blocked["prim_id"].numpy() >= 0, want)
    np.testing.assert_array_equal(
        want, np.asarray(japi.occluded(jdev, short)))
    assert 0 < want.mean() < 1


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """The closed box of test_torch_scene_tools.py (12 + 2 triangles, a
    textured wall), compiled by the JAX package, and the port's copy of
    its tables."""
    d = tmp_path_factory.mktemp("box")
    img = np.zeros((8, 8, 3), np.uint8)
    img[:4, :4] = img[4:, 4:] = 200
    jpng.write_png(str(d / "checker.png"), img)
    (d / "box.obj").write_text(BOX)
    (d / "box.mtl").write_text(BOX_MTL)
    jscene = jcompile_obj(str(d / "box.obj"), max_path_len=4)
    return jscene, tcomp.from_jax_device(
        jax.tree_util.tree_map(np.asarray, jscene.device), "cpu")


def test_box_is_dense_tier(box):
    """The box is the dense tier, by the constant dense.py exports; the
    port's policy keeps K1 for it, where the JAX CPU branch takes the
    dense engine."""
    scene = box[1]
    assert scene["bvh"]["tris"].shape[0] <= dense.DENSE_MAX_PACKETS
    assert tcomp.DENSE_MAX_PACKETS is dense.DENSE_MAX_PACKETS
    assert tcomp.packet_mode(scene) == "dense"
    assert tcomp.select_packet(scene) is True
    assert tcomp.select_render_policy(scene) == {"packet": True,
                                                 "retire_every": 2}


def assert_film_rule(got, want):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() / want.mean() - 1.0) < 5e-3
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.mean() > 0.0


@pytest.mark.parametrize("render,jrender", [
    (integrator.render_iteration_persistent, jpersistent),
    (integrator.render_iteration, jprogressive)],
    ids=["persistent", "progressive"])
def test_dense_film_matches_jax(box, render, jrender):
    """Both renderers on the dense engine (packet="dense") against the JAX
    renderer's dense route, op by op, at 16x12, spp 2, mpl 4, launching
    no kernel; the port's dense film equals its K1 film bit for bit."""
    jscene, scene = box
    with jax.disable_jit():
        want = np.asarray(jrender(
            jscene.device, JCamera.make(*BOX_CAM, W, H),
            jnp.zeros((W * H, 3), jnp.float32), W, H, SPP, 0,
            packet="dense"))
    packet.reset_launches()
    cam = Camera.make(*BOX_CAM, W, H)
    got = render(scene, cam, film_mod.new_film(W, H, "cpu"), W, H, SPP, 0,
                 packet="dense").numpy()
    assert set(packet.launches.values()) == {0}
    assert_film_rule(got, want)
    np.testing.assert_array_equal(got, render(
        scene, cam, film_mod.new_film(W, H, "cpu"), W, H, SPP, 0).numpy())
