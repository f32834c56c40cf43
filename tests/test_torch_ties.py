"""The tie rule, pinned: of two hits at the same t, the traversal keeps the
first one found.

Two coincident triangles (the same vertices, prim ids 5 then 3) are laid
out twice (rodent_tpu_torch.experiments.ab_body.tie_bvh): both in one
Tri8 row, where lane order decides, and one in each of two leaves with the
same box, where the visit order decides. The same numpy rays go through
the JAX package's Pallas traversal in interpret mode
(pallas_packet.traverse_packet, in both of its per-ray bodies: with the
package's defaults, MULTI 2 and CARRY_TOP False, it runs _kernel_multi;
with carry_top=True and multi=1, _kernel_ct) and through the port's
traverse_components (the plain version of K1-K3) and its carry-top body
(traverse_ct_components, K7's plain version, against _kernel_ct with the
same select): prim_id equal, t/u/v within the North star's atol 1e-5 /
rtol 1e-6, any-hit hit/miss equal.
Both keep the first hit (`tv < t_cur`, pallas_packet.py:384). The JAX
package's api.traverse keeps the later of two leaves' hits (`t <= abs_det
* t_cur`, api.py:237) and the lower lane of one row (its min-select tree,
api.py:352-361); one test records both. chip_smoke.py holds
both CUDA bodies against the plain version on the same scenes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rodent_tpu.accel.layout import WideBvh as JWideBvh
from rodent_tpu.traversal import api as japi
from rodent_tpu.traversal.pallas_packet import traverse_packet as jpacket
from rodent_tpu_torch.experiments.ab_body import (TIE_LAYOUTS, TIE_PRIMS,
                                                  tie_bvh, tie_rays)
from rodent_tpu_torch.traversal import api as tapi

torch.set_num_threads(1)

# traverse_packet's arguments for each Pallas body the tie goes through
JAX_BODIES = {"_kernel_multi": {}, "_kernel_ct": {"carry_top": True,
                                                  "multi": 1}}


def _both(layout):
    bvh = tie_bvh(layout)
    jdev = japi.bvh_to_device(JWideBvh(**dataclasses.asdict(bvh)))
    return jdev, tapi.bvh_to_device(bvh, "cpu")


def _rays(n):
    org, d = tie_rays(n)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    return (japi.make_rays(org, d, tmin, tmax),
            tapi.make_rays(org, d, 0.0, 1e30))


@pytest.mark.parametrize("body", JAX_BODIES)
@pytest.mark.parametrize("layout", TIE_LAYOUTS)
def test_first_of_two_equal_hits(layout, body):
    """The Pallas traversal and the port keep the same triangle of each
    tie, the first one found (prim 5)."""
    jdev, tdev = _both(layout)
    jr, tr = _rays(256)
    kw = JAX_BODIES[body]
    want = {k: np.asarray(v) for k, v in jpacket(
        jdev, jr, tile_rows=4, interpret=True, **kw).items()}
    got = {k: v.numpy() for k, v in tapi.traverse(tdev, tr).items()}
    hit = got["prim_id"] >= 0
    assert 100 < hit.sum() < 256             # ties, and rays past the edge
    assert (got["prim_id"][hit] == TIE_PRIMS[0]).all()
    np.testing.assert_array_equal(got["prim_id"], want["prim_id"])
    np.testing.assert_array_equal(got["geom_id"], want["geom_id"])
    for key in ("t", "u", "v"):
        np.testing.assert_allclose(got[key][hit], want[key][hit],
                                   atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(got["t"][~hit], want["t"][~hit])
    jany = np.asarray(jpacket(jdev, jr, any_hit=True, tile_rows=4,
                              interpret=True, **kw)["prim_id"]) >= 0
    tany = tapi.traverse(tdev, tr, any_hit=True)["prim_id"].numpy()
    np.testing.assert_array_equal(tany >= 0, jany)
    assert (tany[tany >= 0] == TIE_PRIMS[0]).all()


@pytest.mark.parametrize("select", tapi.SELECTS)
@pytest.mark.parametrize("layout", TIE_LAYOUTS)
def test_carry_top_keeps_the_first_hit(layout, select):
    """The port's plain carry-top body (api.traverse_ct_components, K7's
    plain version) against _kernel_ct with the same select, fused slab:
    the same triangle of each tie (prim 5: the fold's strict < keeps the
    first of two equal keys, as the lane order and the sort do), the same
    t/u/v, and any-hit hit/miss equal."""
    jdev, tdev = _both(layout)
    jr, tr = _rays(256)
    kw = dict(JAX_BODIES["_kernel_ct"], select=select)
    want = {k: np.asarray(v) for k, v in jpacket(
        jdev, jr, tile_rows=4, interpret=True, **kw).items()}
    got = {k: v.numpy() for k, v in tapi.traverse(
        tdev, tr, carry_top=True, select=select).items()}
    hit = got["prim_id"] >= 0
    assert 100 < hit.sum() < 256
    assert (got["prim_id"][hit] == TIE_PRIMS[0]).all()
    np.testing.assert_array_equal(got["prim_id"], want["prim_id"])
    np.testing.assert_array_equal(got["geom_id"], want["geom_id"])
    for key in ("t", "u", "v"):
        np.testing.assert_allclose(got[key][hit], want[key][hit],
                                   atol=1e-5, rtol=1e-6)
    jany = np.asarray(jpacket(jdev, jr, any_hit=True, tile_rows=4,
                              interpret=True, **kw)["prim_id"]) >= 0
    tany = tapi.traverse(tdev, tr, any_hit=True, carry_top=True,
                         select=select)["prim_id"].numpy()
    np.testing.assert_array_equal(tany >= 0, jany)
    assert (tany[tany >= 0] == TIE_PRIMS[0]).all()


def test_jax_api_traverse_keeps_the_later_hit():
    """api.traverse of the JAX package accepts a lane at t <= t_cur, so of
    two leaves it keeps the later one's hit (prim 3), which the port's
    traversal does not; inside one row its min-select tree keeps the lower
    lane on a tie, as the port does (prim 5)."""
    for layout, kept in (("leaves", TIE_PRIMS[1]), ("row", TIE_PRIMS[0])):
        jdev, tdev = _both(layout)
        jr, tr = _rays(256)
        jax_api = np.asarray(japi.traverse(jdev, jr)["prim_id"])
        first = tapi.traverse(tdev, tr)["prim_id"].numpy()
        hit = first >= 0
        np.testing.assert_array_equal(jax_api >= 0, hit)
        assert (jax_api[hit] == kept).all(), layout
