"""Pallas Triton kernel: dense points x triangles closest-distance scan.

The reference's exact signed-distance oracle is an O(T) scan per query point
(Mesh::SignedDistanceAtPt without a BVH, Source/Meshing/Mesh.cpp:42-51); its
fast path is a divergent best-first BVH walk (BVH.cpp:263-342). The dense
scan is branch-free elementwise work: per (point, triangle) pair the Ericson
closest-point cascade, then a running min/argmin over triangles.

One program per block of BP points; a loop inside the program walks the
triangles BT at a time and keeps the running best in registers, so nothing
carries between programs and blocks run in any order. Every intermediate of
the cascade is a (BT, BP) register tile. Ties break toward the lowest
triangle id (as jnp.argmin does). The kernel returns (best squared
distance, best triangle id); the sign + pseudo-normal selection then runs
on the single best triangle per point via the shared epilogue in sdf.py
(Baerentzen-Aanaes, Mesh.cpp:162-242).

Measured on an NVIDIA H100 80GB HBM3 (700 W), 1M points x 20,480
triangles: this kernel 0.205-0.210 s; the same contract as a plain XLA
``lax.scan`` over triangle chunks fused into a variadic min/argmin
reduction, 0.235-0.262 s (0.30 s with triangles on the major axis). As the
F of a depth-6 fit of that mesh: 0.835 s warm against 1.05 s. The plain
version was removed; see PERF.md.

The kernel has no compiled form off the GPU: ``interpret=True`` runs it in
the Pallas interpreter (the tests do), and it is never chosen implicitly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import bvh as _bvh

# BP points per program, BT triangles per loop step (swept on the H100:
# (128, 4, 4 warps), (64, 4|8, 2 warps) and (256, 2, 4 warps) tie within
# 2%; (128, 1|2|16, 4 warps) and (256, 4, 8 warps) are 5-10% slower).
BP = 128
BT = 4
NUM_WARPS = 4
_EPS = 1e-30


def _closest_d2(px, py, pz, ax, ay, az, bx, by, bz, cx, cy, cz):
    """Squared distance from points to triangles, fully componentized.

    Point and triangle components broadcast against each other (points
    along one axis, triangles along the other) to a tile of pair
    distances. Same region cascade as tri.closest_point_triangle (Ericson
    RTCD 5.1.5; reference Source/Meshing/Utility.cpp:5-97), minus the
    feature code. All constants are explicit f32, so the tile stays f32
    under jax_enable_x64."""
    zero = jnp.float32(0.0)
    eps = jnp.float32(_EPS)
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az

    apx, apy, apz = px - ax, py - ay, pz - az
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz

    bpx, bpy, bpz = px - bx, py - by, pz - bz
    d3 = abx * bpx + aby * bpy + abz * bpz
    d4 = acx * bpx + acy * bpy + acz * bpz

    cpx, cpy, cpz = px - cx, py - cy, pz - cz
    d5 = abx * cpx + aby * cpy + abz * cpz
    d6 = acx * cpx + acy * cpy + acz * cpz

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    in_a = (d1 <= zero) & (d2 <= zero)
    in_b = (d3 >= zero) & (d4 <= d3)
    in_c = (d6 >= zero) & (d5 <= d6)
    in_ab = (vc <= zero) & (d1 >= zero) & (d3 <= zero)
    in_ca = (vb <= zero) & (d2 >= zero) & (d6 <= zero)
    in_bc = (va <= zero) & (d4 - d3 >= zero) & (d5 - d6 >= zero)

    t_ab = d1 / jnp.where(jnp.abs(d1 - d3) > eps, d1 - d3, eps)
    t_ca = d2 / jnp.where(jnp.abs(d2 - d6) > eps, d2 - d6, eps)
    den_bc = (d4 - d3) + (d5 - d6)
    t_bc = (d4 - d3) / jnp.where(jnp.abs(den_bc) > eps, den_bc, eps)

    denom = va + vb + vc
    denom = jnp.where(jnp.abs(denom) > eps, denom, eps)
    v = vb / denom
    w = vc / denom

    # closest-point components via the same first-true-wins cascade
    def pick(face, on_bc, on_ca, on_ab, vc_, vb_, va_):
        out = face
        out = jnp.where(in_bc, on_bc, out)
        out = jnp.where(in_ca, on_ca, out)
        out = jnp.where(in_ab, on_ab, out)
        out = jnp.where(in_c, vc_, out)
        out = jnp.where(in_b, vb_, out)
        out = jnp.where(in_a, va_, out)
        return out

    qx = pick(ax + abx * v + acx * w, bx + (cx - bx) * t_bc,
              ax + acx * t_ca, ax + abx * t_ab, cx, bx, ax)
    qy = pick(ay + aby * v + acy * w, by + (cy - by) * t_bc,
              ay + acy * t_ca, ay + aby * t_ab, cy, by, ay)
    qz = pick(az + abz * v + acz * w, bz + (cz - bz) * t_bc,
              az + acz * t_ca, az + abz * t_ab, cz, bz, az)

    dx, dy, dz = px - qx, py - qy, pz - qz
    return dx * dx + dy * dy + dz * dz


def _padded_verts(tri_rows, multiple: int):
    """(9, Tp) f32 vertex components, padded with BIG-coordinate rows
    (never selected) to a multiple of ``multiple`` triangles."""
    T = tri_rows.shape[0]
    Tp = -(-T // multiple) * multiple
    verts = jnp.full((9, Tp), _bvh.BIG, jnp.float32)
    return verts.at[:, :T].set(tri_rows[:, :9].astype(jnp.float32).T)


# --------------------------------------------------------------------------
# Pallas kernel, Triton route
# --------------------------------------------------------------------------

def _kernel(px_ref, py_ref, pz_ref, tri_ref, d2_ref, idx_ref):
    px = px_ref[...][None, :]                             # (1, BP)
    py = py_ref[...][None, :]
    pz = pz_ref[...][None, :]
    n_tiles = tri_ref.shape[1] // BT

    def body(j, carry):
        best, bidx = carry
        sl = pl.ds(j * BT, BT)
        comps = [tri_ref[k, sl][:, None] for k in range(9)]   # (BT, 1)
        d2 = _closest_d2(px, py, pz, *comps)                 # (BT, BP)
        loc = jnp.min(d2, axis=0)
        ii = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 0)
        arg = jnp.min(jnp.where(d2 <= loc[None, :], ii, jnp.int32(BT)),
                      axis=0) + j * BT
        take = loc < best
        return jnp.where(take, loc, best), jnp.where(take, arg, bidx)

    init = (jnp.full((BP,), jnp.inf, jnp.float32),
            jnp.zeros((BP,), jnp.int32))
    best, bidx = jax.lax.fori_loop(0, n_tiles, body, init)
    d2_ref[...] = best
    idx_ref[...] = bidx


@functools.partial(jax.jit, static_argnames=("interpret",))
def closest_tri_tiles(tri_rows: jax.Array, pts: jax.Array,
                      interpret: bool = False):
    """Exact closest triangle per point by the dense tiled scan.

    tri_rows: (T, >=9) packed triangle rows (bvh.TRI_W layout; padding rows
    of coordinate BIG are never selected). pts: (B, 3) f32.
    Returns (best_d2 (B,) f32, best_idx (B,) i32 into tri_rows).
    ``interpret=True`` runs the kernel in the Pallas interpreter, the only
    way it runs without a GPU."""
    p = jnp.asarray(pts, jnp.float32)
    B = p.shape[0]
    T = tri_rows.shape[0]
    Bp = -(-B // BP) * BP
    pp = jnp.zeros((3, Bp), jnp.float32).at[:, :B].set(p.T)
    verts = _padded_verts(tri_rows, BT)
    Tp = verts.shape[1]
    # 32-bit tracing: under jax_enable_x64 the index arithmetic would be i64
    with jax.enable_x64(False):
        pblk = pl.BlockSpec((BP,), lambda i: (i,))
        d2, idx = pl.pallas_call(
            _kernel,
            grid=(Bp // BP,),
            in_specs=[pblk, pblk, pblk,
                      pl.BlockSpec((9, Tp), lambda i: (0, 0))],
            out_specs=[pblk, pblk],
            out_shape=[jax.ShapeDtypeStruct((Bp,), jnp.float32),
                       jax.ShapeDtypeStruct((Bp,), jnp.int32)],
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
            interpret=interpret,
            name="closest_tri_tiles",
        )(pp[0], pp[1], pp[2], verts)
    return d2[:B], jnp.clip(idx[:B], 0, T - 1)
