"""Pallas tiled closest-triangle kernel vs the scan oracle (the reference's
brute-force differential-test pattern, MeshingUnitTests.cpp:110-138). Runs
the SAME kernel code in the Pallas interpreter, asked for explicitly; the
compiled kernel is tested on the card by the ``gpu``-marked tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from hpsdf_tpu import mesh as M
from hpsdf_tpu.mesh import pallas_sdf
from hpsdf_tpu.mesh import sdf as S
from hpsdf_tpu.mesh.core import build_mesh

from .util import cube_mesh, icosphere_mesh, uniform_pts


@pytest.fixture(scope="module", params=["cube", "ico"])
def bvh(request):
    if request.param == "cube":
        v, f = cube_mesh(half=0.2)
    else:
        v, f = icosphere_mesh(radius=0.3, subdivisions=3)
    return M.build_bvh(build_mesh(v, f))


def test_tiles_match_brute_oracle(bvh):
    pts = uniform_pts(300, seed=11)
    ref = np.asarray(S.signed_distance_brute(bvh.tri_rows, pts))
    got = np.asarray(S.signed_distance_tiles(bvh.tri_rows, pts,
                                             interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_tiles_match_bvh(bvh):
    pts = uniform_pts(300, seed=12)
    ref = np.asarray(S.signed_distance(bvh, pts))
    got = np.asarray(S.signed_distance_tiles(bvh.tri_rows, pts,
                                             interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_closest_idx_and_d2(bvh):
    """d2/idx contract: idx indexes tri_rows, d2 is its squared distance."""
    pts = jnp.asarray(uniform_pts(128, seed=13), jnp.float32)
    d2, idx = pallas_sdf.closest_tri_tiles(bvh.tri_rows, pts,
                                         interpret=True)
    assert idx.dtype == jnp.int32 and d2.shape == (128,)
    rows = bvh.tri_rows[idx]
    from hpsdf_tpu.mesh import tri as T
    a = rows[:, 0:3]
    b = rows[:, 3:6]
    c = rows[:, 6:9]
    closest, _ = T.closest_point_triangle(pts, a, b, c)
    d2_check = jnp.sum((pts - closest) ** 2, axis=-1)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d2_check),
                               atol=1e-7)


def test_mesh_sdf_tiles_method(monkeypatch):
    kernel = pallas_sdf.closest_tri_tiles
    monkeypatch.setattr(pallas_sdf, "closest_tri_tiles",
                        lambda t, p, interpret=False: kernel(
                            t, p, interpret=True))
    v, f = icosphere_mesh(radius=0.3, subdivisions=2)
    m = build_mesh(v, f)
    F = M.mesh_sdf(m, method="tiles")
    pts = uniform_pts(200, seed=14)
    vals = np.asarray(F(jnp.asarray(pts, jnp.float32)))
    r = np.linalg.norm(pts, axis=-1)
    # icosphere at subdiv 2 is within ~2% of the analytic sphere
    np.testing.assert_allclose(vals, r - 0.3, atol=0.02)


def test_ragged_sizes():
    """Point/triangle counts that do not divide the tile sizes."""
    v, f = cube_mesh(half=0.2)
    bvh = M.build_bvh(build_mesh(v, f))   # 12 tris -> T2=16 rows
    for n in (1, 7, 130):
        pts = uniform_pts(n, seed=n)
        ref = np.asarray(S.signed_distance_brute(bvh.tri_rows, pts))
        got = np.asarray(S.signed_distance_tiles(bvh.tri_rows, pts,
                                                 interpret=True))
        np.testing.assert_allclose(got, ref, atol=1e-6)
