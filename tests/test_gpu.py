"""Tests that need the card: the compiled tile kernel, f64 query and CG on
the device, row_meta's precision, and df64 against f64. Run them with

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu

Elsewhere each skips inside the ``gpu`` fixture."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import hpsdf_tpu as hp
from hpsdf_tpu import accel, continuity, df64, oracle
from hpsdf_tpu import mesh as M
from hpsdf_tpu.mesh import gen, pallas_sdf
from hpsdf_tpu.mesh import sdf as S

pytestmark = pytest.mark.gpu


def test_tiles_kernel_compiled(gpu):
    v, f = gen.icosphere(0.3, 4)
    bvh = M.build_bvh(M.build_mesh(v, f))
    pts = jnp.asarray(np.random.default_rng(0).uniform(-0.5, 0.5, (3000, 3)),
                      jnp.float32)
    d2, idx = pallas_sdf.closest_tri_tiles(bvh.tri_rows, pts)
    d2i, idxi = pallas_sdf.closest_tri_tiles(bvh.tri_rows, pts,
                                             interpret=True)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(idxi))
    np.testing.assert_array_equal(np.asarray(d2), np.asarray(d2i))
    got = np.asarray(S.signed_distance_tiles(bvh.tri_rows, pts))
    ref = np.asarray(S.signed_distance_brute(bvh.tri_rows, pts))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_f64_query_on_device(gpu):
    cfg = hp.Config(target_error=1e-7, continuity=False, max_depth=5,
                    max_degree=6)
    tree = hp.build_octree(cfg, df64.Sphere(0.3))
    assert tree.coeffs.devices() == {gpu}
    assert tree.coeffs.dtype == jnp.float64
    P = np.random.default_rng(1).uniform(-0.5, 0.5, (100_000, 3))
    v = hp.query(tree, jnp.asarray(P))
    assert v.devices() == {gpu} and v.dtype == jnp.float64
    want = np.linalg.norm(P, axis=1) - 0.3
    # the reference oracle tolerance (HPUnitTests.cpp:46-77)
    assert np.max(np.abs(np.asarray(v) - want)) <= 0.01


def test_f64_cg_on_device(gpu):
    cfg = hp.Config(target_error=1e-6, continuity=False,
                    continuity_strength=8.0, max_depth=4, max_degree=4)
    tree = hp.build_octree(cfg, df64.Sphere(0.3))
    ours = continuity.enforce_continuity(tree, cg="f64")
    assert ours.coeffs.devices() == {gpu}
    ref = oracle.scipy_continuity(tree, 8.0)
    P = jnp.asarray(np.random.default_rng(2).uniform(-0.5, 0.5,
                                                     (100_000, 3)))
    d = np.abs(np.asarray(hp.query(ours, P)) - np.asarray(hp.query(ref, P)))
    assert d.max() <= 1e-5, d.max()


def test_row_meta_precision_depth_10(gpu):
    """Depth-10 centres are odd multiples of 2**-12: a TF32 matmul would
    round them (the default-precision product is measured off by 2.4e-4
    on the H100); row_meta must return them exactly."""
    rng = np.random.default_rng(3)
    n, W = 1 << 16, 24
    rows = np.zeros((n, W), np.float32)
    rows[:, 1] = 2.0 ** 11
    rows[:, 2:5] = (rng.integers(-2048, 2048, (n, 3)) * 2 + 1) * 2.0 ** -12
    rows[:, 8:] = rng.standard_normal((n, W - 8))
    got = np.asarray(jax.jit(accel.row_meta)(jnp.asarray(rows)))
    np.testing.assert_array_equal(got, rows[:, 1:5])


def test_df64_against_f64(gpu):
    rng = np.random.default_rng(4)
    n = 1 << 20
    a = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))
         ).astype(np.float32)
    b = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))
         ).astype(np.float32)
    s, e = jax.jit(df64.two_sum)(a, b)
    exact = a.astype(np.float64) + b.astype(np.float64)
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)
    p, e2 = jax.jit(df64.two_prod)(a, b)
    ex = a.astype(np.float64) * b.astype(np.float64)
    rel = (np.abs(np.asarray(p, np.float64) + np.asarray(e2, np.float64) - ex)
           / np.maximum(np.abs(ex), 1e-300))
    assert rel.max() < 2.0 ** -45
