"""Gather-optimized read path: packed node rows + dense leaf-row grid.

Why this exists: a gather's cost is set by the number of rows it fetches
far more than by their width, and narrow (scalar) gathers are the most
expensive per byte. The generic query path (query.py) descends with ~11
narrow gathers per point, which is too slow for sphere tracing at 200
steps per ray.

This module re-lays the octree for reading:

  * **Packed node row** ``f32[W]`` per node, W a multiple of 8:
      lane 0      : child_idx + 1 bitcast i32->f32 (0.0 for leaves; the +1
                    keeps every lane finite -- a raw -1 bitcasts to NaN and
                    would poison the full-row dot products below)
      lane 1      : scale = 2**(depth+1) (precomputed, replaces exp2+depth)
      lanes 2..4  : cell centre (internal unit-cube coords)
      lanes 8..   : coefficients with the (depth, basis) normalizers
                    pre-multiplied in (linear re-scaling, so VJPs pull back
                    through a constant diagonal)
    One W-wide gather fetches everything a descent step or a leaf
    evaluation needs.

  * **Whole-row consumption.** XLA can propagate slices INTO a gather: a
    gathered row consumed as ``row[..., 2:5]``/``row[..., 8:]`` may compile
    to several NARROW gathers. Every read therefore consumes the full row:
    descent/eval metadata is extracted with a one-hot (W, 4) matmul at
    HIGHEST precision (see ``row_meta``) and the coefficient contraction
    zero-pads the basis products to width W and reduces
    ``sum(row * prod_full)``.

  * **Dense leaf-row grid** at depth Dg = min(depth_used, GRID_DEPTH_CAP):
    grid[cell] is the full packed row of the unique node at depth <= Dg
    covering that cell (a leaf, or the depth-Dg internal node above deeper
    structure). Point location then costs ONE wide gather plus
    (depth_used - Dg) masked packed-descent rounds -- instead of
    depth_used rounds of narrow gathers.

The packed layout is read-only: it is derived from a fitted Octree once
(``pack_tree``) and reused across queries/traces. The reference's analogue
is the pointer-free child-offset descent (Source/HP/Octree.cpp:674-699);
this is that idea re-shaped around wide-row gathers.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import basis
from .tree import Octree

# Dense grid depth cap. Random row gathers stay cheap only while the TABLE
# fits the device's fast cache level; past it every row is a miss. So the
# grid is capped at 32^3 cells and the byte budget guards wide-row trees.
GRID_DEPTH_CAP = 5
GRID_BYTE_BUDGET = 20 << 20
COEFF_LANE = 8


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackedTree:
    rows: jax.Array        # f32[Np, W] packed node rows
    grid: jax.Array        # f32[G**3, W] packed row per depth-Dg cell
    # static metadata
    deg_used: int = dataclasses.field(metadata=dict(static=True))
    grid_depth: int = dataclasses.field(metadata=dict(static=True))
    extra_rounds: int = dataclasses.field(metadata=dict(static=True))
    root_centre: tuple = dataclasses.field(metadata=dict(static=True))
    root_sizes: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def width(self) -> int:
        return self.rows.shape[1]


def _pack_rows(tree: Octree) -> np.ndarray:
    n = tree.capacity
    cw = tree.coeff_width
    W = COEFF_LANE + cw
    W = -(-W // 8) * 8
    rows = np.zeros((n, W), np.float32)
    child = np.asarray(tree.child_idx, np.int32) + 1    # 0 = leaf, finite
    rows[:, 0] = child.view(np.float32)
    depth = np.asarray(tree.depth, np.float64)
    rows[:, 1] = np.exp2(depth + 1.0).astype(np.float32)
    rows[:, 2:5] = np.asarray(tree.centre, np.float32)
    # fold the per-(depth, basis) normalizers into the coefficients
    norms = basis.coeff_norms(tree.deg_used)          # (D+1, cw)
    dep_i = np.asarray(tree.depth, np.int64)
    rows[:, COEFF_LANE:COEFF_LANE + cw] = (
        np.asarray(tree.coeffs, np.float64) * norms[dep_i]).astype(np.float32)
    return rows


def _grid_sources(tree: Octree, gd: int) -> np.ndarray:
    """Node index of the unique depth<=gd node covering each grid cell
    (host-side vectorized descent over all cells at once)."""
    g = 1 << gd
    ax = (np.arange(g, dtype=np.float64) + 0.5) / g - 0.5   # cell centres
    px, py, pz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([px, py, pz], axis=-1).reshape(-1, 3)

    child = np.asarray(tree.child_idx, np.int64)
    centre = np.asarray(tree.centre, np.float64)
    cur = np.zeros(pts.shape[0], np.int64)
    for _ in range(gd):
        c0 = child[cur]
        live = c0 >= 0
        cc = centre[cur]
        oct_ = ((pts[:, 0] >= cc[:, 0]).astype(np.int64)
                + ((pts[:, 1] >= cc[:, 1]).astype(np.int64) << 1)
                + ((pts[:, 2] >= cc[:, 2]).astype(np.int64) << 2))
        cur = np.where(live, c0 + oct_, cur)
    return cur


def _default_grid_depth(tree: Octree) -> int:
    """Deepest grid within GRID_DEPTH_CAP whose row table fits the byte
    budget (wider rows at deg >= 9 pull the cap down one level)."""
    cw = tree.coeff_width
    W = -(-(COEFF_LANE + cw) // 8) * 8
    gd = min(tree.depth_used, GRID_DEPTH_CAP)
    while gd > 0 and (8 ** gd) * W * 4 > GRID_BYTE_BUDGET:
        gd -= 1
    return gd


def pack_tree(tree: Octree, grid_depth: int | None = None) -> PackedTree:
    """Derive the gather-optimized read layout from a fitted Octree."""
    if grid_depth is None:
        grid_depth = _default_grid_depth(tree)
    rows = _pack_rows(tree)
    grid = rows[_grid_sources(tree, grid_depth)]
    return PackedTree(
        rows=jnp.asarray(rows), grid=jnp.asarray(grid),
        deg_used=tree.deg_used, grid_depth=grid_depth,
        extra_rounds=max(0, tree.depth_used - grid_depth),
        root_centre=tuple(np.asarray(tree.config.root_centre, np.float64)),
        root_sizes=tuple(np.asarray(tree.config.root_sizes, np.float64)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackSupport:
    """Static structure needed to re-derive a PackedTree from NEW
    coefficients on device (the tree topology is fixed; only the
    coefficient lanes change). This is what makes gradient-based
    coefficient optimization (inverse rendering) jit-able end to end:
    ``repack`` is a pure device function of ``coeffs``."""
    meta_rows: jax.Array    # f32[Np, COEFF_LANE] lanes 0..7 of the rows
    fold: jax.Array         # f32[Np, cw] per-(depth, basis) normalizers
    grid_src: jax.Array     # i32[G**3] node index backing each grid cell


def pack_support(tree: Octree, grid_depth: int | None = None) -> PackSupport:
    if grid_depth is None:
        grid_depth = _default_grid_depth(tree)
    rows = _pack_rows(tree)
    norms = basis.coeff_norms(tree.deg_used)
    dep_i = np.asarray(tree.depth, np.int64)
    return PackSupport(
        meta_rows=jnp.asarray(rows[:, :COEFF_LANE]),
        fold=jnp.asarray(norms[dep_i].astype(np.float32)),
        grid_src=jnp.asarray(_grid_sources(tree, grid_depth), np.int32))


def repack(packed: PackedTree, support: PackSupport,
           coeffs: jax.Array) -> PackedTree:
    """Rebuild (rows, grid) for new coefficients, on device. ``coeffs``:
    (Np, cw) in any float dtype; the result matches ``pack_tree`` on a tree
    carrying those coefficients (up to f32 rounding of the fold product)."""
    return repack_folded(packed, support,
                         (coeffs * support.fold).astype(jnp.float32))


def repack_folded(packed: PackedTree, support: PackSupport,
                  folded: jax.Array) -> PackedTree:
    """Like :func:`repack` but takes the normalizer-premultiplied
    coefficient lanes directly (the coordinates inverse rendering optimizes
    in; see inverse.fit_to_depth ``param_space``)."""
    folded = folded.astype(jnp.float32)
    W = packed.rows.shape[1]
    pad = W - COEFF_LANE - folded.shape[1]
    parts = [support.meta_rows, folded]
    if pad:
        parts.append(jnp.zeros((folded.shape[0], pad), jnp.float32))
    rows = jnp.concatenate(parts, axis=1)
    return dataclasses.replace(packed, rows=rows, grid=rows[support.grid_src])


# --------------------------------------------------------------------------
# Device-side reading
# --------------------------------------------------------------------------

def _row_child(row: jax.Array) -> jax.Array:
    # lane 0 stores child_idx + 1 (see module docstring); < 0 means leaf
    return jax.lax.bitcast_convert_type(row[..., 0], jnp.int32) - 1


@functools.lru_cache(maxsize=None)
def _meta_matrix(width: int):
    """One-hot (W, 4) extractor: row @ M = [scale, cx, cy, cz]. Consuming
    the full row through one matmul keeps the producing gather WIDE."""
    m = np.zeros((width, 4), np.float32)
    m[1, 0] = m[2, 1] = m[3, 2] = m[4, 3] = 1.0
    return m          # numpy: a cached jnp array would leak trace-time tracers


def row_meta(row: jax.Array) -> jax.Array:
    """(B, 4) = [scale, centre xyz] extracted via full-row matmul.

    HIGHEST precision: at default precision a GPU may run an f32 matmul in
    TF32 (10-bit mantissa), which rounds the leaf centres and scales that
    point location compares against -- wrong leaves below depth ~8."""
    return jnp.matmul(row, _meta_matrix(row.shape[-1]),
                      precision=jax.lax.Precision.HIGHEST)


def to_unit(pt: PackedTree, pts: jax.Array) -> jax.Array:
    centre = jnp.asarray(pt.root_centre, pts.dtype)
    inv = jnp.asarray(1.0 / np.asarray(pt.root_sizes), pts.dtype)
    return (pts - centre) * inv


def locate_in(grid: jax.Array, rows: jax.Array, grid_depth: int,
              extra_rounds: int, unit: jax.Array) -> jax.Array:
    """Packed row of the leaf containing each unit-cube point (B, W), read
    from explicit (grid, rows) tables (the full-width tables of a
    PackedTree, or the 32-lane low-degree tables from :func:`lo_pack`).

    One grid gather + ``extra_rounds`` masked packed-descent rounds.
    """
    g = 1 << grid_depth
    cell = jnp.clip(((unit + 0.5) * g).astype(jnp.int32), 0, g - 1)
    flat = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
    row = grid[flat]                                      # (B, W) wide gather
    for _ in range(extra_rounds):
        child = _row_child(row)
        is_leaf = child < 0
        cc = row_meta(row)[..., 1:4]
        oct_ = ((unit[..., 0] >= cc[..., 0]).astype(jnp.int32)
                + ((unit[..., 1] >= cc[..., 1]).astype(jnp.int32) << 1)
                + ((unit[..., 2] >= cc[..., 2]).astype(jnp.int32) << 2))
        nxt = jnp.where(is_leaf, jnp.int32(0), child + oct_)
        new_row = rows[nxt]
        row = jnp.where(is_leaf[..., None], row, new_row)
    return row


def locate(pt: PackedTree, unit: jax.Array) -> jax.Array:
    """Packed row of the leaf containing each unit-cube point (B, W)."""
    return locate_in(pt.grid, pt.rows, pt.grid_depth, pt.extra_rounds, unit)


# --------------------------------------------------------------------------
# Low-degree (LOD) row tables for the far-field march phase
# --------------------------------------------------------------------------
#
# Far from the surface the march does not need the full polynomial: a
# 32-lane row with the deg<=2 coefficients plus an exact truncation bound
# supports CONSERVATIVE sphere-trace steps (march on v_lo - err <= f), with
# narrower gathers and ~5x cheaper evals than the full rows. render._march
# runs a first march phase on these tables and hands lanes off to the full
# rows near the surface. p-refinement concentrates degree near the surface, so far-field
# leaves usually have deg <= 2 exactly (err = 0): phase 1 marches them at
# full speed.

LO_W = 32
LO_COEFFS = 10                       # coeff_count(2)
LO_ERR_LANE = COEFF_LANE + LO_COEFFS


def lo_pack(rows: jax.Array) -> jax.Array:
    """Derive (N, 32) low-degree rows from (N, W) packed rows, on device:
    meta lanes 0..7 unchanged, lanes 8..17 = the deg<=2 folded coefficient
    lanes (basis indices are grouped by total degree, basis.basis_indices),
    lane 18 = 1.001 * sum|folded c_m, deg>2| -- a bound on |full - lo| eval
    anywhere in the leaf (|L_p| <= 1 on [-1, 1]; the 1.001 covers the
    LEAF_TOL overhang, |L_p(1+1e-5)| < 1.001 for p <= 12)."""
    c = rows[:, COEFF_LANE:]
    err = jnp.sum(jnp.abs(c[:, LO_COEFFS:]), axis=1,
                  keepdims=True) * jnp.float32(1.001)
    pad = jnp.zeros((rows.shape[0], LO_W - LO_ERR_LANE - 1), rows.dtype)
    return jnp.concatenate(
        [rows[:, :COEFF_LANE], c[:, :LO_COEFFS], err, pad], axis=1)


def pad_products(prod: jax.Array, width: int) -> jax.Array:
    """Zero-pad (B, C) basis products to (B, W) at the coefficient lanes so
    the contraction consumes the packed row whole."""
    b = prod.shape[:-1]
    cw = prod.shape[-1]
    return jnp.concatenate(
        [jnp.zeros(b + (COEFF_LANE,), prod.dtype), prod,
         jnp.zeros(b + (width - COEFF_LANE - cw,), prod.dtype)], axis=-1)


def eval_row(pt: PackedTree, row: jax.Array, unit: jax.Array,
             meta: jax.Array | None = None) -> jax.Array:
    """Evaluate a packed leaf row at unit-cube points. Normalizers are
    pre-folded, so this is the bare Legendre product sum. Pass ``meta``
    (``row_meta(row)``) when it is already at hand."""
    if meta is None:
        meta = row_meta(row)
    local = (unit - meta[..., 1:4]) * meta[..., 0:1]
    idx = basis.basis_indices(pt.deg_used)
    L = basis.legendre_all(local, pt.deg_used)           # (B, 3, P+1)
    prod = (L[..., 0, idx[:, 0]] * L[..., 1, idx[:, 1]]
            * L[..., 2, idx[:, 2]])                      # (B, C)
    return jnp.sum(row * pad_products(prod, row.shape[-1]), axis=-1)


def values_at(pt: PackedTree, pts: jax.Array) -> jax.Array:
    """f32 SDF values at world points, boundary-clamped."""
    unit = jnp.clip(to_unit(pt, pts), -0.5, 0.5)
    return eval_row(pt, locate(pt, unit), unit)


@jax.jit
def query_packed(pt: PackedTree, pts: jax.Array) -> jax.Array:
    """Batched f32 query on the packed layout (the serving-path equivalent
    of Octree::Query, Source/HP/Octree.cpp:662-702; outside points return
    f32 max as the reference does f64 max)."""
    unit = to_unit(pt, pts)
    inside = jnp.all(jnp.abs(unit) <= 0.5, axis=-1)
    v = eval_row(pt, locate(pt, jnp.clip(unit, -0.5, 0.5)),
                 jnp.clip(unit, -0.5, 0.5))
    return jnp.where(inside, v, jnp.finfo(jnp.float32).max)
