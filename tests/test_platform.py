"""Where arrays live, which kernels may interpret, and the entry points'
compile cache and device table -- the parts of the GPU translation that the
CPU can check."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import hpsdf_tpu as hp
from hpsdf_tpu import accel, compile_cache, continuity
from hpsdf_tpu import mesh as M
from hpsdf_tpu.mesh import pallas_sdf
from hpsdf_tpu.mesh.core import build_mesh

from .util import cube_mesh, uniform_pts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_tree():
    cfg = hp.Config(target_error=1e-6, continuity=False, max_depth=4,
                    max_degree=4, continuity_strength=8.0)
    return hp.build_octree(cfg, hp.df64.Sphere(0.3))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_is_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_library_import_sets_no_cache():
    # conftest imports nothing that enables it; the library must not either
    assert compile_cache.DEFAULT_DIR != jax.config.jax_compilation_cache_dir


def test_tree_arrays_on_default_device(small_tree, tmp_path):
    dev = jax.devices()[0]
    path = str(tmp_path / "t.npz")
    hp.save(small_tree, path)
    for tree in (small_tree, hp.load(path)):
        assert tree.coeffs.dtype == jnp.float64
        for a in (tree.child_idx, tree.centre, tree.depth, tree.degree,
                  tree.coeffs):
            assert a.devices() == {dev}
    st = continuity.enforce_continuity(small_tree)
    assert st.coeffs.devices() == {dev}


def test_tiles_refuse_to_interpret_unless_asked():
    v, f = cube_mesh(half=0.2)
    bvh = M.build_bvh(build_mesh(v, f))
    pts = jnp.asarray(uniform_pts(16, seed=3), jnp.float32)
    if jax.default_backend() != "gpu":
        with pytest.raises(ValueError, match="interpret"):
            pallas_sdf.closest_tri_tiles(bvh.tri_rows, pts)
    d2, idx = pallas_sdf.closest_tri_tiles(bvh.tri_rows, pts, interpret=True)
    assert d2.shape == (16,) and idx.dtype == jnp.int32


def test_auto_method_off_gpu_is_hybrid():
    v, f = cube_mesh(half=0.2)
    m = build_mesh(v, f)
    F = M.mesh_sdf(m, method="auto")
    if jax.default_backend() != "gpu":
        assert F.__name__ == "F" and "hybrid" in F.__qualname__


def test_continuity_auto_is_f64(small_tree):
    a = continuity.enforce_continuity(small_tree, cg="auto")
    b = continuity.enforce_continuity(small_tree, cg="f64")
    assert np.array_equal(np.asarray(a.coeffs), np.asarray(b.coeffs))


def test_row_meta_exact_at_depth_10():
    rng = np.random.default_rng(0)
    n, W = 4096, 24
    rows = np.zeros((n, W), np.float32)
    rows[:, 1] = 2.0 ** 11
    rows[:, 2:5] = (rng.integers(-2048, 2048, (n, 3)) * 2 + 1) * 2.0 ** -12
    rows[:, 8:] = rng.standard_normal((n, W - 8))
    got = np.asarray(jax.jit(accel.row_meta)(jnp.asarray(rows)))
    np.testing.assert_array_equal(got, rows[:, 1:5])


def test_bench_peaks_table():
    import bench

    assert bench.peaks("NVIDIA H100 80GB HBM3")["hbm_gbps"] == 3350.0
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks("unknown accelerator")
