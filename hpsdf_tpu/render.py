"""Batched differentiable sphere tracing.

Batched generalization of the reference's scalar ``Octree::QueryRay``
(Source/HP/Octree.cpp:705-746, marked "Untested" at Include/HP/Octree.h:73)
and ``SDF::Ray`` slab intersection (Source/HP/Ray.cpp:17-65):

  * ``intersect_aabb``  <- Ray::IntersectAABB (slab method), vectorized.
  * ``trace``           <- QueryRay: the reference's step rule
    ``t += 0.95*v + 1e-4`` and hit test ``v < 1e-4`` over a whole ray batch,
    plus cost-sorted chunking (_march_key) and Keinert over-relaxation with
    safe rollback (OMEGA) -- identical hit guarantees, fewer steps.
  * ``render``          <- pinhole-camera ray grid + analytic-normal shading
    (the reference has no renderer; this is the framework's flagship
    forward pass).

March structure (gather economics, see accel.py): an outer while_loop
locates every ray's leaf with ONE wide gather (packed rows + dense grid),
then an inner unrolled loop takes up to INNER_STEPS sphere-trace steps
evaluating the *carried* leaf row -- pure elementwise work, no gathers. Lanes that
step out of their leaf freeze until the next outer relocation. This
amortizes the dominant cost (row gathers) over several march steps.

Differentiability: the march is a while_loop (not reverse-differentiable),
so ``trace`` carries a custom VJP w.r.t. the coefficient array using
implicit-function differentiation at the hit point:

    f(c, t) = 0  at the surface  =>  dt/dc = - (df/dc) / (df/dt),
    df/dt = grad_x f . dir.

Gradients flow through hit *positions*, not just the final distance eval
(SURVEY.md section 7, "custom VJP through the march"). The backward pass
evaluates on the original (un-packed) tree arrays, which is exact.

The whole path runs in f32 (render accuracy is bounded by hit_eps=1e-4).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from . import accel, basis
from .accel import PackedTree, pack_tree
from .query import descend
from .tree import Octree

# March constants (reference: Source/HP/Octree.cpp:725-743).
MAX_STEPS = 200          # per-ray step cap        (:725)
HIT_EPS = 1e-4           # |v| < eps  => surface   (:733)
STEP_SCALE = 0.95        # 5% SDF-error safety     (:739)
MIN_STEP = 1e-4          # minimum advance         (:739)
# Inner-step counts and the other march constants below come from sweeps
# on other hardware; their numbers do not carry over: re-derive on the card
# (ROADMAP speed item 5).
INNER_STEPS = 1          # gather-free steps per leaf relocation, for SHALLOW
                         # low-degree trees (width <= 32 lanes, no descent
                         # below the grid): over-relaxed lanes leave those
                         # big leaves almost every step, so extra inner evals
                         # only waste frozen-lane work
INNER_STEPS_DEEP = 3     # and for DEEP/high-degree trees (reference-default
                         # builds): near-surface leaves are tiny but so are
                         # the steps, lanes dwell several steps per leaf, and
                         # each avoided relocation saves 2+ wide-row gathers
INNER_STEPS_LO = 3       # far-field LOD phase inner count: LOD-phase steps
                         # far from the surface are SMALL relative to the
                         # big leaves (conservative v_lo-err stepping), so
                         # lanes dwell there too
LEAF_TOL = 1.0 + 1e-5    # |local| bound counting as "still in this leaf"


class TraceResult(NamedTuple):
    t: jax.Array        # (B,) ray parameter at hit (or last march position)
    hit: jax.Array      # (B,) bool
    steps: jax.Array    # () int32, outer relocation rounds executed


# --------------------------------------------------------------------------
# Ray / AABB intersection (slab method)
# --------------------------------------------------------------------------

def intersect_aabb(origins: jax.Array, dirs: jax.Array,
                   aabb_min, aabb_max):
    """Batched slab-method ray/AABB intersection.

    Equivalent of Ray::IntersectAABB (Source/HP/Ray.cpp:17-65) without the
    precomputed sign tables -- min/max over the reciprocal-direction slabs
    is branch-free and vectorizes directly.

    origins, dirs: (B, 3). Returns (t_near, t_far, hits); for rays starting
    inside the box t_near <= 0 <= t_far.
    """
    inv = 1.0 / dirs                       # inf on zero components is fine
    lo = (jnp.asarray(aabb_min, origins.dtype) - origins) * inv
    hi = (jnp.asarray(aabb_max, origins.dtype) - origins) * inv
    t_near = jnp.max(jnp.minimum(lo, hi), axis=-1)
    t_far = jnp.min(jnp.maximum(lo, hi), axis=-1)
    return t_near, t_far, (t_far >= jnp.maximum(t_near, 0.0))


# --------------------------------------------------------------------------
# Core march (packed layout)
# --------------------------------------------------------------------------

def _tree_f32(tree: Octree) -> Octree:
    return dataclasses.replace(
        tree,
        centre=tree.centre.astype(jnp.float32),
        coeffs=tree.coeffs.astype(jnp.float32))


def _values_at(tree: Octree, pts: jax.Array) -> jax.Array:
    """SDF values at world points via the generic (narrow-gather) path;
    boundary-clamped. Used by the backward pass, where it runs once."""
    centre = jnp.asarray(tree.config.root_centre, pts.dtype)
    inv = jnp.asarray(1.0 / tree.config.root_sizes, pts.dtype)
    unit = jnp.clip((pts - centre) * inv, -0.5, 0.5)
    leaf = descend(tree, unit)
    depth = tree.depth[leaf]
    scale = jnp.exp2((depth + 1).astype(pts.dtype))
    local = (unit - tree.centre[leaf]) * scale[..., None]
    return basis.eval_basis(tree.coeffs[leaf], local, depth, tree.deg_used)


def _eval_local(pt: PackedTree, row: jax.Array, local: jax.Array):
    """Basis eval against a loop-carried row. Unlike the one-shot read paths
    (accel.eval_row), the march's row crosses a while_loop boundary and is
    already materialized, so plain coefficient slices are the cheap form
    here (the full-row contraction measured ~40% slower in the march)."""
    idx = basis.basis_indices(pt.deg_used)
    L = basis.legendre_all(local, pt.deg_used)
    prod = (L[..., 0, idx[:, 0]] * L[..., 1, idx[:, 1]]
            * L[..., 2, idx[:, 2]])
    cw = idx.shape[0]
    return jnp.sum(row[..., accel.COEFF_LANE:accel.COEFF_LANE + cw] * prod,
                   axis=-1)


def _eval_lo(row: jax.Array, local: jax.Array):
    """Deg<=2 eval against a loop-carried 32-lane LOD row (accel.lo_pack).
    Returns (v_lo, err): anywhere in the leaf, v_lo - err <= f <= v_lo + err
    for the full-degree field f."""
    idx = basis.basis_indices(2)
    L = basis.legendre_all(local, 2)
    prod = (L[..., 0, idx[:, 0]] * L[..., 1, idx[:, 1]]
            * L[..., 2, idx[:, 2]])
    v = jnp.sum(row[..., accel.COEFF_LANE:accel.LO_ERR_LANE] * prod, axis=-1)
    return v, row[..., accel.LO_ERR_LANE]


def _lo_of(pt: PackedTree):
    """(lo_grid, lo_rows) LOD tables for the far-field march phase, or None
    when the tree is low-degree already (nothing to save)."""
    if pt.deg_used <= 2 or pt.width <= accel.LO_W:
        return None
    return accel.lo_pack(pt.grid), accel.lo_pack(pt.rows)


def _inner_steps_for(pt: PackedTree) -> int:
    """Gather-free steps per relocation in the FULL-row phase, chosen from
    the tree's (static) read-path shape: see INNER_STEPS/INNER_STEPS_DEEP.
    The far-field LOD phase always runs INNER_STEPS_LO."""
    if pt.width <= accel.LO_W and pt.extra_rounds == 0:
        return INNER_STEPS
    return INNER_STEPS_DEEP


# --------------------------------------------------------------------------
# Cone prepass (hierarchical sphere tracing)
# --------------------------------------------------------------------------
#
# One coarse ray per TxT pixel tile marches the CONSERVATIVE cone field
# f(p_c(t)) - (do + t*dd), where do/dd bound the origin/direction spread of
# the tile's rays around the coarse ray: while that margin stays above
# hit_eps, NO ray of the tile can be within hit_eps of the surface at
# parameter t, so every fine ray may START at the first contact parameter
# (or skip to its exit when the whole cone escapes the domain). Fine rays
# therefore skip the far-field entirely: background tiles cost 1/T^2 of
# their former march and surface tiles start the fine march at the
# surface. Guarantees rest on the same |grad f| <= ~1 trust the plain
# march's 0.95 step factor already assumes (reference: Octree.cpp:739);
# the t-Lipschitz constant of the margin is (1 + dd), which the cone step
# divides out.

# Pixel-tile edge for the cone prepass (T x T fine rays per coarse ray):
# smaller tiles make the prepass itself too big, larger tiles' wider cones
# stop too far from the surface.
CONE_TILE = 8
# Cone-march round cap: a cone GRAZING the surface creeps exactly like a
# grazing ray (margin ~ 2e-3 per step; ~150 rounds uncapped on the
# depth-5 sphere tree) -- but suspending the cone early is
# always safe (fine rays simply start at the capped parameter), so the
# prepass is bounded to this many rounds.
CONE_CAP = 24
# Contact once the margin is within this fraction of the cone radius (or
# hit_eps if larger): stopping EARLIER than strictly necessary is safe and
# prevents the margin-creep regime where steps shrink to ~hit_eps.
CONE_STOP_FRAC = 0.5


def _cone_march(pt: PackedTree, lo, oc, dc, do, dd, t_max, hit_eps,
                max_steps):
    """March coarse rays against the cone margin; all f32, plain
    (non-relaxed) stepping, one row gather per step, capped at CONE_CAP
    rounds. Returns t_stop (Bc,): the first sample with margin below
    max(hit_eps, CONE_STOP_FRAC * cone radius) or the cap (fine rays
    resume there), or t_max + 1 when the cone provably escapes."""
    half = 0.5 * jnp.asarray(pt.root_sizes, jnp.float32)
    rc = jnp.asarray(pt.root_centre, jnp.float32)
    t_near, t_far, hits_box = intersect_aabb(oc, dc, rc - half, rc + half)
    t = jnp.maximum(t_near, 0.0)
    t_end = jnp.minimum(t_far, t_max)
    escape = jnp.float32(t_max) + 1.0
    active = hits_box & (t <= t_end)
    t = jnp.where(active, t, escape)
    uo = accel.to_unit(pt, oc)
    udir = dc * jnp.asarray(1.0 / np.asarray(pt.root_sizes), jnp.float32)
    inv_lip = 1.0 / (1.0 + dd)            # t-Lipschitz of the margin

    def cond(s):
        return jnp.logical_and(jnp.any(s[1]),
                               s[2] < min(CONE_CAP, max_steps))

    def body(s):
        t, active, k = s
        unit = jnp.clip(uo + t[..., None] * udir, -0.5, 0.5)
        if lo is not None:
            row = accel.locate_in(lo[0], lo[1], pt.grid_depth,
                                  pt.extra_rounds, unit)
            local = (unit - row[..., 2:5]) * row[..., 1:2]
            v_lo, err = _eval_lo(row, local)
            v = v_lo - err                # conservative lower bound on f
        else:
            row = accel.locate(pt, unit)
            local = (unit - row[..., 2:5]) * row[..., 1:2]
            v = _eval_local(pt, row, local)
        radius = do + t * dd
        margin = v - radius
        contact = active & (margin < jnp.maximum(
            jnp.float32(hit_eps), jnp.float32(CONE_STOP_FRAC) * radius))
        adv = (STEP_SCALE * margin) * inv_lip + MIN_STEP
        escaped = active & ~contact & (t + adv > t_end)
        t_new = jnp.where(active & ~contact, t + adv, t)
        t_new = jnp.where(escaped, escape, t_new)
        return t_new, active & ~contact & ~escaped, k + 1

    t, _, k = jax.lax.while_loop(cond, body, (t, active, jnp.int32(0)))
    return t, k


def cone_start(pt: PackedTree, origins, dirs, t_max, hit_eps, tiles,
               lo=None, max_steps: int = MAX_STEPS,
               with_stats: bool = False):
    """Per-ray conservative march starting parameters from a TxT-tile cone
    prepass. ``tiles`` = (H, W, T) with H*W == len(origins) (row-major ray
    grid); rays of each tile must be spatially coherent for the prepass to
    pay off (it is CORRECT regardless -- an incoherent tile just gets a
    huge cone that stops immediately)."""
    H, W, T = tiles
    # one transpose to tile-contiguous (ntiles, T*T, 3) instead of a
    # direct 5-D strided max-reduction
    ot = origins.reshape(H // T, T, W // T, T, 3).transpose(0, 2, 1, 3, 4)
    dt_ = dirs.reshape(H // T, T, W // T, T, 3).transpose(0, 2, 1, 3, 4)
    ot = ot.reshape(-1, T * T, 3)
    dt_ = dt_.reshape(-1, T * T, 3)
    oc = ot[:, (T // 2) * T + T // 2]
    dc = dt_[:, (T // 2) * T + T // 2]
    # ||d_f - d_c|| >= the angle between them (chord >= ... for unit dirs
    # 2 sin(th/2) <= th); using the chord directly over-bounds the spatial
    # deviation ||p_f(t) - p_c(t)|| <= do + t*dd exactly (triangle ineq.)
    do = jnp.sqrt(jnp.max(jnp.sum((ot - oc[:, None]) ** 2, axis=-1),
                          axis=1))
    dd = jnp.sqrt(jnp.max(jnp.sum((dt_ - dc[:, None]) ** 2, axis=-1),
                          axis=1))
    t_stop, k = _cone_march(pt, lo, oc, dc, do, dd, t_max, hit_eps,
                            max_steps)
    t0 = jnp.broadcast_to(
        t_stop.reshape(H // T, 1, W // T, 1), (H // T, T, W // T, T))
    t0 = t0.reshape(-1)
    if with_stats:
        return t0, k, t_stop.shape[0]
    return t0


# Rays per independently-terminating chunk. One monolithic while_loop runs
# every lane until the WORST ray finishes; marching camera-coherent chunks
# through lax.map lets finished tiles stop early; smaller chunks
# under-fill the device, larger ones re-couple divergent rays.
MARCH_CHUNK = 8192


def _march_key(pt: PackedTree, origins, dirs, t_start=None):
    """March-cost proxy for ray sorting: |f| at the march starting point
    (the root-AABB entry, or the cone-prepass resume parameter).

    A chunk's while_loop runs until its SLOWEST lane finishes, so mixing a
    silhouette-grazing ray (hundreds of small steps) into a chunk of cheap
    rays wastes the whole chunk's remaining slots. |f| at the start
    predicts cost well: near-surface starts are the expensive rays. Rays
    missing the root AABB -- or whose cone provably escaped -- sort to the
    tail (+inf) where whole chunks terminate immediately.
    """
    half = 0.5 * jnp.asarray(pt.root_sizes, jnp.float32)
    rc = jnp.asarray(pt.root_centre, jnp.float32)
    t_near, t_far, hits_box = intersect_aabb(origins, dirs, rc - half,
                                             rc + half)
    t0 = jnp.maximum(t_near, 0.0)
    if t_start is not None:
        t0 = jnp.maximum(t0, t_start)
        hits_box = hits_box & (t0 <= t_far)
    p = origins + jnp.minimum(t0, t_far)[..., None] * dirs
    v = accel.values_at(pt, p)
    return jnp.where(hits_box, jnp.abs(v), jnp.inf)


# Rays per sort unit. Keys are evaluated once per block and blocks are
# permuted/unpermuted as packed 48/16-lane rows: one WIDE row gather instead
# of two narrow (B, 3) gathers each way, and the key eval + argsort shrink
# by the block factor. Camera-adjacent rays share march cost, so per-chunk
# cost uniformity -- the reason for sorting -- is preserved.
SORT_BLOCK = 8


def _sorted_blocks(pt: PackedTree, origins, dirs, t_start=None):
    """Cost-sort rays at SORT_BLOCK granularity. origins/dirs length must be
    a multiple of SORT_BLOCK (callers pad to MARCH_CHUNK first). Returns
    (origins_sorted, dirs_sorted, t_start_sorted_or_None, block_perm)."""
    nb = origins.shape[0] // SORT_BLOCK
    key = _march_key(pt, origins[::SORT_BLOCK], dirs[::SORT_BLOCK],
                     None if t_start is None else t_start[::SORT_BLOCK])
    perm = jnp.argsort(key)
    parts = [origins.reshape(nb, 3 * SORT_BLOCK),
             dirs.reshape(nb, 3 * SORT_BLOCK)]
    if t_start is not None:
        parts.append(t_start.reshape(nb, SORT_BLOCK))
    rows = jnp.concatenate(parts, axis=1)
    # the barrier keeps the permutation ONE wide row gather (XLA would push
    # the slices below into it, splitting it into narrow gathers; accel.py)
    rows = jax.lax.optimization_barrier(rows[perm])
    ts = (rows[:, 6 * SORT_BLOCK:].reshape(-1)
          if t_start is not None else None)
    return (rows[:, :3 * SORT_BLOCK].reshape(-1, 3),
            rows[:, 3 * SORT_BLOCK: 6 * SORT_BLOCK].reshape(-1, 3), ts,
            perm)


def _unsort_blocks(perm, t, hit):
    """Invert _sorted_blocks on per-ray (t, hit): pack each block's results
    into one row, gather rows through the inverse permutation (wide), unpack.

    The inverse permutation is a second sort, NOT a scatter
    (``zeros.at[perm].set(iota)``), which measured several times slower
    than an argsort of the same rows on other hardware; re-measure on the
    card."""
    nb = perm.shape[0]
    out_rows = jnp.concatenate(
        [t.reshape(nb, SORT_BLOCK),
         hit.reshape(nb, SORT_BLOCK).astype(jnp.float32)], axis=1)
    inv = jnp.argsort(perm)
    out = jax.lax.optimization_barrier(out_rows[inv])
    return (out[:, :SORT_BLOCK].reshape(-1),
            out[:, SORT_BLOCK:].reshape(-1) > jnp.float32(0.5))


# Pass-1 outer-round cap per chunk for the compaction schedule
# (_march_compacted): cost-sorted chunks march while_loops capped at this
# many relocation rounds per phase, then still-active SORT_BLOCK blocks are
# compacted to the front (stable sort preserves the cost order) and
# finished in uncapped tail chunks. The cap bounds the divergence waste of
# pass 1 (a chunk's cheap lanes freeze only until the cap, not until its
# slowest grazing ray terminates); the recompaction packs the few
# surviving silhouette lanes densely. The discriminator is PER-ROUND COST,
# not LOD: a tree with extra_rounds > 0 pays 2 gathers per relocation + 3
# inner evals, so a smaller round budget before compaction pays.
PASS1_CAP = 16
PASS1_CAP_DEEP = 8
_STATE_F = 14            # packed state lanes per ray: o3 d3 t hit p1 p2
#                          nsteps relax adv vp


def _pack_state(origins, dirs, t, hit, p1, p2, nsteps, relax, adv, vp, nb):
    S = SORT_BLOCK

    def b32(x):
        return x.astype(jnp.float32).reshape(nb, S)

    return jnp.concatenate(
        [origins.reshape(nb, 3 * S), dirs.reshape(nb, 3 * S),
         b32(t), b32(hit), b32(p1), b32(p2), b32(nsteps), b32(relax),
         b32(adv), b32(vp)], axis=1)               # (nb, _STATE_F * S)


def _unpack_state(r):
    S = SORT_BLOCK
    o = r[:, : 3 * S].reshape(-1, 3)
    d = r[:, 3 * S: 6 * S].reshape(-1, 3)
    c = [r[:, (6 + i) * S: (7 + i) * S].reshape(-1) for i in range(8)]
    init = (c[0], c[1] > 0.5, c[2] > 0.5, c[3] > 0.5,
            c[4].astype(jnp.int32), c[5] > 0.5, c[6], c[7])
    return o, d, init


def _march_compacted(pt: PackedTree, origins, dirs, t_max, hit_eps,
                     max_steps, step_cap, lo, t_start=None,
                     with_stats: bool = False):
    """Capped chunks + survivor compaction by MEASURED step rate.

    Chunks run to their SLOWEST lane, so in the plain chunked march about
    half of the gathered rows (measured active-lane occupancy 0.45 on the
    depth-5 tree at 1024^2) feed frozen lanes -- concentrated in the few
    chunks that own grazing silhouette rays (relocation rounds per chunk:
    p50 4 / p90 13 / max 178). This schedule bounds that waste:

      1. order ray blocks: with a cone prepass (``t_start``), actives pack
         to the front with a FREE binary liveness key (no field eval --
         the cone already classified the rays); without one, cost-sort by
         |f| at entry (_march_key);
      2. pass 1: chunked march capped at PASS1_CAP relocation rounds per
         phase -- cheap chunks terminate normally, expensive ones suspend
         with their full per-lane state (pending Keinert rollback data
         included, so the no-skipped-crossing guarantee survives);
      3. surviving blocks compact to the front ordered by MEASURED step
         rate (t advanced per executed step): any static cost proxy
         degenerates once every survivor sits near the surface (cone
         starts make |f|-at-start keys all ~theta*t, and the resulting
         mixed chunks collapsed to 8.9 Mrays/s, round-5 probe) -- grazing
         creepers march ~2e-3/step while soon-to-resolve lanes move 10x
         faster, so the realized rate separates them;
      4. uncapped tails; finished chunks exit at the first cond check;
      5. one composed unsort returns (t, hit) to ray order.

    origins/dirs must already be padded to a MARCH_CHUNK multiple."""
    B = origins.shape[0]
    S = SORT_BLOCK
    nb = B // S
    chunk_nb = MARCH_CHUNK // S
    half = 0.5 * jnp.asarray(pt.root_sizes, jnp.float32)
    rc = jnp.asarray(pt.root_centre, jnp.float32)
    if t_start is None:
        origins, dirs, t_start_s, perm1 = _sorted_blocks(pt, origins, dirs)
    else:
        # free liveness key: the cone already decided who marches
        t_near, t_far, hits_box = intersect_aabb(origins, dirs, rc - half,
                                                 rc + half)
        alive = hits_box & (jnp.maximum(jnp.maximum(t_near, 0.0), t_start)
                            <= jnp.minimum(t_far, t_max))
        blk = jnp.any(alive.reshape(nb, S), axis=1)
        key1 = jnp.where(blk, jnp.uint16(0), jnp.uint16(1))
        perm1 = jax.lax.sort_key_val(
            key1, jnp.arange(nb, dtype=jnp.int32))[1]
        rows1 = jnp.concatenate(
            [origins.reshape(nb, 3 * S), dirs.reshape(nb, 3 * S),
             t_start.reshape(nb, S)], axis=1)
        rows1 = jax.lax.optimization_barrier(rows1[perm1])
        origins = rows1[:, : 3 * S].reshape(-1, 3)
        dirs = rows1[:, 3 * S: 6 * S].reshape(-1, 3)
        t_start_s = rows1[:, 6 * S:].reshape(-1)

    cap_v = (PASS1_CAP_DEEP if (lo is not None and pt.extra_rounds > 0)
             else PASS1_CAP)
    cap = (cap_v, cap_v)

    def run1(od):
        ts = None if t_start_s is None else od[2]
        return _march_block(pt, od[0], od[1], t_max, hit_eps, max_steps,
                            step_cap, lo=lo, outer_cap=cap,
                            return_state=True, t_start=ts)

    args1 = (origins.reshape(-1, MARCH_CHUNK, 3),
             dirs.reshape(-1, MARCH_CHUNK, 3))
    if t_start_s is not None:
        args1 = args1 + (t_start_s.reshape(-1, MARCH_CHUNK),)
    _, _, kk1, st = jax.lax.map(run1, args1)   # t/hit travel in the state
    t, hit, p1, p2, nsteps, relax, adv, vp = (x.reshape(-1) for x in st)
    active = p1 | p2
    blk_active = jnp.any(active.reshape(nb, S), axis=1)
    # measured step rate as the tail cost key (docstring point 3)
    t_near, _, _ = intersect_aabb(origins, dirs, rc - half, rc + half)
    t0 = jnp.maximum(t_near, 0.0)
    if t_start_s is not None:
        t0 = jnp.maximum(t0, t_start_s)
    rate = (t - t0) / jnp.maximum(nsteps.astype(jnp.float32), 1.0)
    blk_rate = jnp.where(active, rate, jnp.inf).reshape(nb, S).min(axis=1)
    key = jnp.where(blk_active,
                    jnp.clip(blk_rate * 16384.0, 0.0,
                             65533.0).astype(jnp.uint16),
                    jnp.uint16(65535))
    perm2 = jax.lax.sort_key_val(key, jnp.arange(nb, dtype=jnp.int32))[1]
    rows = _pack_state(origins, dirs, t, hit, p1, p2, nsteps, relax, adv,
                       vp, nb)
    rows = jax.lax.optimization_barrier(rows[perm2])

    def run2(r):
        o, d, init = _unpack_state(r)
        return _march_block(pt, o, d, t_max, hit_eps, max_steps, step_cap,
                            lo=lo, init=init)

    t2, hit2, kk2 = jax.lax.map(run2, rows.reshape(-1, chunk_nb,
                                                   _STATE_F * S))
    # one composed unsort: original block b sits at position
    # inv2[inv1[b]] of the pass-2 output
    inv = jnp.argsort(perm1[perm2])
    out_rows = jnp.concatenate(
        [t2.reshape(nb, S), hit2.reshape(nb, S).astype(jnp.float32)],
        axis=1)
    out = jax.lax.optimization_barrier(out_rows[inv])
    t_f = out[:, :S].reshape(-1)
    hit_f = out[:, S:].reshape(-1) > jnp.float32(0.5)
    steps = (jnp.max(jnp.sum(kk1, axis=-1))
             + jnp.max(jnp.sum(kk2, axis=-1)))
    if with_stats:
        return t_f, hit_f, steps, (kk1, kk2, jnp.sum(blk_active))
    return t_f, hit_f, steps


def _march(pt: PackedTree, origins, dirs, t_max, hit_eps, max_steps,
           step_cap=None, sort_rays=None, cone_tiles=None,
           use_lod: bool = True):
    """Chunked two-level march over a ray batch; all f32.

    ``step_cap`` bounds the per-step advance. Sphere tracing assumes f is
    (nearly) a metric SDF; a partially-optimized field (inverse rendering)
    can report huge distances just outside a thin zero-crossing band and
    the uncapped march steps straight over the surface. A cap of the order
    of the crossing-band width restores robustness at bounded extra steps.

    ``cone_tiles`` = (H, W, T): run the conservative cone prepass
    (cone_start) over TxT pixel tiles and start every fine ray at its
    tile's cone contact (or skip it when the cone escapes). Requires the
    ray batch to be a row-major H x W grid.

    Schedule selection (``sort_rays=None``), from a sweep on other
    hardware that has not been repeated on the card: LOD trees -> compact
    without cone (the cone forces every
    surviving lane straight into the wide-row full phase, forfeiting the
    cheap LOD approach that the compact schedule exploits); no-LOD trees
    -> compact + cone when ``cone_tiles`` is available, legacy cost-sort
    otherwise. Explicit ``sort_rays`` (True / False / "compact")
    overrides. Per-ray results are identical across schedules (lanes only
    share termination, never arithmetic).
    """
    B = origins.shape[0]
    lo = _lo_of(pt) if use_lod else None
    if cone_tiles is not None and lo is not None and sort_rays is None:
        cone_tiles = None          # regression on LOD trees (above)
    t_start = None
    if cone_tiles is not None:
        t_start = cone_start(pt, origins, dirs, t_max, hit_eps, cone_tiles,
                             lo=lo, max_steps=max_steps)
    if B <= MARCH_CHUNK:
        t, hit, kk = _march_block(pt, origins, dirs, t_max, hit_eps,
                                  max_steps, step_cap, lo=lo,
                                  t_start=t_start)
        return t, hit, jnp.sum(kk)
    pad = (-B) % MARCH_CHUNK
    if pad:
        # padded rays point along +z from beyond the root AABB: never active
        far = jnp.asarray(pt.root_centre, jnp.float32) + jnp.asarray(
            pt.root_sizes, jnp.float32) * jnp.float32(10.0)
        origins = jnp.concatenate(
            [origins, jnp.broadcast_to(far, (pad, 3))], axis=0)
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0],
                                                jnp.float32), (pad, 3))],
            axis=0)
        if t_start is not None:
            t_start = jnp.concatenate(
                [t_start, jnp.zeros(pad, jnp.float32)])
    if sort_rays == "compact" or (sort_rays is None
                                  and (t_start is not None
                                       or lo is not None)):
        # the cone prepass composes with the compaction schedule: liveness
        # ordering is free and the capped pass + step-rate recompaction
        # bound the tail divergence the cone would otherwise expose
        t, hit, steps = _march_compacted(pt, origins, dirs, t_max, hit_eps,
                                         max_steps, step_cap, lo,
                                         t_start=t_start)
        return t[:B], hit[:B], steps
    perm = None
    if sort_rays is None or sort_rays is True:
        origins, dirs, t_start, perm = _sorted_blocks(pt, origins, dirs,
                                                      t_start)
    oc = origins.reshape(-1, MARCH_CHUNK, 3)
    dc = dirs.reshape(-1, MARCH_CHUNK, 3)
    if t_start is None:
        t, hit, kk = jax.lax.map(
            lambda od: _march_block(pt, od[0], od[1], t_max, hit_eps,
                                    max_steps, step_cap, lo=lo),
            (oc, dc))
    else:
        t, hit, kk = jax.lax.map(
            lambda od: _march_block(pt, od[0], od[1], t_max, hit_eps,
                                    max_steps, step_cap, lo=lo,
                                    t_start=od[2]),
            (oc, dc, t_start.reshape(-1, MARCH_CHUNK)))
    t = t.reshape(-1)
    hit = hit.reshape(-1)
    if perm is not None:
        t, hit = _unsort_blocks(perm, t, hit)
    return t[:B], hit[:B], jnp.max(jnp.sum(kk, axis=-1))


# Over-relaxation factor for the march (Keinert et al., "Enhanced Sphere
# Tracing": step OMEGA*f instead of f while consecutive step spheres
# overlap; on the first disjoint pair, roll back to the safe unrelaxed
# step and drop that lane to plain tracing). 1.0 disables; 1.6+ pays
# rollbacks.
OMEGA = 1.3

# LOD->full handoff threshold, in hit_eps units: a lane leaves the far-field
# (32-lane deg<=2) phase when its conservative value v_lo - err drops below
# LOD_HANDOFF * hit_eps. The march is not sensitive to it: near-surface
# leaves carry large truncation bounds err, which force the handoff
# regardless of the threshold.
LOD_HANDOFF = 8.0


def _march_block(pt: PackedTree, origins, dirs, t_max, hit_eps, max_steps,
                 step_cap=None, omega: float = OMEGA, lo=None,
                 with_stats: bool = False, init=None, outer_cap=None,
                 return_state: bool = False, t_start=None):
    """Two-level while_loop march over one ray chunk; all f32. Returns
    (t, hit, k) with k = i32[2]: [LOD-phase, full-phase] outer relocation
    rounds (k[0] = 0 when ``lo`` is None). ``with_stats`` appends the
    per-lane executed step counts (i32[B]) -- the frozen-lane occupancy
    numerator of the march's occupancy.

    ``outer_cap`` = (cap_lo, cap_full) bounds the LOD-phase / full-phase
    outer relocation rounds (None = max_steps, i.e. uncapped); lanes still
    active at a cap are reported in the returned state instead of being
    marched to completion. A cap_full of 0 skips the full phase entirely.
    ``init`` resumes from a state tuple previously returned with
    ``return_state=True``:

        state = (t, hit, p1_active, p2_active, nsteps, relax, adv_p, v_p)

    where p1_active lanes resume the LOD phase and p2_active lanes the
    full phase, each with its carried relaxation state (a pending relaxed
    step's rollback data survives the suspension, so the Keinert
    no-skipped-crossing guarantee is preserved across resume). This is the
    primitive behind the round-5 march schedule: a capped prefix over the
    whole batch, activity compaction, then chunked resumed tails
    (_march_compacted).

    ``omega`` > 1 enables over-relaxed stepping: lanes advance by
    ``omega * (STEP_SCALE*v + MIN_STEP)`` while the step spheres of
    consecutive samples overlap (|v_k| + |v_k+1| >= omega_adv_k, the
    Keinert overlap test); the first disjoint pair rolls the lane back to
    the safe unrelaxed position and disables relaxation for that lane, so
    no zero crossing can be skipped. Hits and final t carry exactly the
    plain-march guarantees (|f| < hit_eps at the reported position).

    ``lo`` = (lo_grid, lo_rows) from render._lo_of enables the far-field
    LOD phase: a first march on the 32-lane deg<=2 tables taking
    CONSERVATIVE steps 0.95*(v_lo - err) (a lower bound of the full field
    f, so no crossing of f can be skipped), handing each lane off to the
    full-row march when its conservative value drops under 8*hit_eps.
    p-refinement concentrates degree near the surface, so the far field
    marches on exact (err = 0) deg<=2 rows at ~5x cheaper evals; hits are
    only ever declared by the full phase, so hit/t guarantees are
    unchanged.

    A NEGATIVE result worth recording (round 4): certified leaf-exit jumps
    -- lanes in leaves whose coefficient-norm bound proves f > 0 jumping
    straight to the leaf's AABB exit -- measured a NO-OP on the reference-
    default tree and -3% on the depth-5 tree. The L1 corner bound c0 - sum|c_m| is tight for linear
    fields, so exactly the near-surface-but-empty leaves that dominate the
    grazing-ray tail never certify; far-field leaves do, but over-relaxed
    f-steps there are already leaf-sized or larger. The jump logic was
    removed again; the emptiness margin stayed out of the packed rows.
    """
    relax_on = omega > 1.0 and step_cap is None
    inner_steps = _inner_steps_for(pt)
    half = 0.5 * jnp.asarray(pt.root_sizes, jnp.float32)
    rc = jnp.asarray(pt.root_centre, jnp.float32)
    t_near, t_far, hits_box = intersect_aabb(origins, dirs, rc - half,
                                             rc + half)
    # Exit plane is a pure function of (origins, dirs): recomputed
    # identically on resume.
    t_end = jnp.minimum(t_far, t_max)
    if init is None:
        # Clamp the start to the AABB entry (reference: Octree.cpp:714-721),
        # or to the cone-prepass resume parameter (cone_start) -- rays whose
        # cone escaped carry t_start > t_end and deactivate immediately.
        t = jnp.maximum(t_near, 0.0)
        if t_start is not None:
            t = jnp.maximum(t, t_start)
        active0 = hits_box & (t <= t_end)
        hit0 = jnp.zeros_like(active0)
        nsteps0 = jnp.zeros(t.shape, jnp.int32)
        relax0 = jnp.full(t.shape, relax_on)
        # pending relaxed step: the amount the lane last advanced (0 = none)
        adv0 = jnp.zeros(t.shape, jnp.float32)
        vprev0 = jnp.zeros(t.shape, jnp.float32)
        p1_in = active0 if lo is not None else jnp.zeros_like(active0)
        p2_in = active0 if lo is None else jnp.zeros_like(active0)
    else:
        t, hit0, p1_in, p2_in, nsteps0, relax0, adv0, vprev0 = init
        active0 = p1_in | p2_in
    cap_lo, cap_full = (outer_cap if outer_cap is not None
                        else (max_steps, max_steps))
    cap_lo = max_steps if cap_lo is None else cap_lo
    cap_full = max_steps if cap_full is None else cap_full
    # leftover LOD-phase lanes at an uncapped phase boundary fold into the
    # full phase (the while exits with none active anyway, except at the
    # max_steps edge where the original semantics also merged them);
    # capped runs keep them in phase 1 for the resume instead
    merge_leftovers = cap_lo >= max_steps
    max_outer = max_steps          # safe cap: one relocation per step worst case
    k_lo = jnp.int32(0)
    # unit-space ray parametrization: unit(t) = uo + t * udir replaces the
    # per-step to_unit(origins + t*dirs) affine (same value, fewer ops)
    uo = accel.to_unit(pt, origins)
    udir = dirs * jnp.asarray(1.0 / np.asarray(pt.root_sizes), jnp.float32)

    p1_left = jnp.zeros_like(active0)
    relax2, adv2, vprev2 = relax0, adv0, vprev0
    if lo is not None:
        lo_grid, lo_rows = lo
        handoff = jnp.float32(LOD_HANDOFF) * jnp.float32(hit_eps)

        def cond1(state):
            active = state[1]
            k = state[-1]
            return jnp.logical_and(jnp.any(active),
                                   k < min(cap_lo, max_outer))

        def outer1(state):
            t, active, nsteps, relax, adv_p, v_p, need_full, k = state
            unit = jnp.clip(uo + t[..., None] * udir, -0.5, 0.5)
            row = accel.locate_in(lo_grid, lo_rows, pt.grid_depth,
                                  pt.extra_rounds, unit)

            def inner(_, s):
                t, active, nsteps, relax, adv_p, v_p, need_full = s
                unit = jnp.clip(uo + t[..., None] * udir, -0.5, 0.5)
                local = (unit - row[..., 2:5]) * row[..., 1:2]
                in_leaf = jnp.all(jnp.abs(local) <= LEAF_TOL, axis=-1)
                v_lo, err = _eval_lo(row, local)
                v = v_lo - err                # lower bound on the full field
                lane = active & in_leaf
                if relax_on:
                    # overlap radii must LOWER-bound |f|: relu(|v_lo| - err)
                    # covers the sign-unknown current sample (v_p was a
                    # stepping lane's conservative value, > 0 already)
                    rad = jax.nn.relu(jnp.abs(v_lo) - err)
                    over = (lane & relax & (adv_p > 0.0)
                            & (v_p + rad < adv_p * jnp.float32(1.001)))
                else:
                    over = jnp.zeros_like(lane)
                hand = lane & ~over & (v < handoff)
                stepping = lane & ~hand
                safe_adv = STEP_SCALE * v + MIN_STEP
                adv = safe_adv
                if relax_on:
                    adv = jnp.where(relax, jnp.float32(omega) * adv, adv)
                    adv = jnp.where(t + adv > t_end, safe_adv, adv)
                    adv = jnp.where(over,
                                    -adv_p + STEP_SCALE * v_p + MIN_STEP,
                                    adv)
                    relax = relax & ~over
                if step_cap is not None:
                    adv = jnp.minimum(adv, jnp.float32(step_cap))
                t_new = jnp.where(stepping, t + adv, t)
                escaped = stepping & ~over & (t + safe_adv > t_end)
                nsteps = nsteps + stepping.astype(jnp.int32)
                need_full = need_full | hand
                active = active & ~hand & ~escaped & (nsteps < max_steps)
                if relax_on:
                    adv_p = jnp.where(stepping,
                                      jnp.where(over, 0.0, adv), adv_p)
                    v_p = jnp.where(stepping, v, v_p)
                return (t_new, active, nsteps, relax, adv_p, v_p,
                        need_full)

            t, active, nsteps, relax, adv_p, v_p, need_full = (
                jax.lax.fori_loop(
                    0, INNER_STEPS_LO, inner,
                    (t, active, nsteps, relax, adv_p, v_p, need_full),
                    unroll=True))
            return t, active, nsteps, relax, adv_p, v_p, need_full, k + 1

        (t, act1, nsteps0, relax1, adv1, vp1, need_full, k_lo) = \
            jax.lax.while_loop(
                cond1, outer1,
                (t, p1_in, nsteps0, relax0, adv0, vprev0,
                 p2_in, jnp.int32(0)))
        # lanes that handed off continue on the full rows with FRESH
        # relaxation state (their pending step was validated by the overlap
        # test at hand-off); lanes resumed mid-full-phase (p2_in) keep
        # their carried state; capped leftovers stay in phase 1
        if merge_leftovers:
            active0 = act1 | need_full
            p1_left = jnp.zeros_like(act1)
        else:
            active0 = need_full
            p1_left = act1         # suspended; phase-1 relax state merged
            #                        back into the returned state below
        relax2 = jnp.where(p2_in, relax0, jnp.full(t.shape, relax_on))
        adv2 = jnp.where(p2_in, adv0, jnp.float32(0.0))
        vprev2 = jnp.where(p2_in, vprev0, jnp.float32(0.0))

    def cond(state):
        active = state[2]
        k = state[-1]
        return jnp.logical_and(jnp.any(active),
                               k < min(cap_full, max_outer))

    def outer(state):
        t, hit, active, nsteps, relax, adv_p, v_p, k = state
        unit = jnp.clip(uo + t[..., None] * udir, -0.5, 0.5)
        row = accel.locate(pt, unit)                     # the wide gathers

        def inner(_, s):
            t, hit, active, nsteps, relax, adv_p, v_p = s
            unit = jnp.clip(uo + t[..., None] * udir, -0.5, 0.5)
            local = (unit - row[..., 2:5]) * row[..., 1:2]
            in_leaf = jnp.all(jnp.abs(local) <= LEAF_TOL, axis=-1)
            v = _eval_local(pt, row, local)
            lane = active & in_leaf
            if relax_on:
                # Keinert overlap test on the PENDING relaxed step: the
                # spheres |f| around the previous and current samples must
                # overlap, else the step may have jumped the surface. The
                # 1e-3 slack covers the Lipschitz worst case, which lands
                # exactly ON the test boundary (a crossing at distance
                # f_prev with penetration 0.52*f_prev sums to adv_p).
                over = (lane & relax & (adv_p > 0.0)
                        & (jnp.abs(v_p) + jnp.abs(v)
                           < adv_p * jnp.float32(1.001)))
            else:
                over = jnp.zeros_like(lane)
            now_hit = lane & ~over & (v < hit_eps)
            stepping = lane & ~now_hit
            safe_adv = STEP_SCALE * v + MIN_STEP
            adv = safe_adv
            if relax_on:
                adv = jnp.where(relax, jnp.float32(omega) * adv, adv)
                # never let a RELAXED step carry the lane past the exit
                # plane (its next sample would be boundary-clipped and the
                # overlap test would read a wrong field value); plain steps
                # past t_end are the legitimate escape signal below
                adv = jnp.where(t + adv > t_end, safe_adv, adv)
                # rollback: undo the relaxed step, take the safe one instead
                adv = jnp.where(over,
                                -adv_p + STEP_SCALE * v_p + MIN_STEP, adv)
                relax = relax & ~over
            if step_cap is not None:
                adv = jnp.minimum(adv, jnp.float32(step_cap))
            t_new = jnp.where(stepping, t + adv, t)
            # escape is decided from the UNRELAXED step: f(t) > t_end - t
            # proves no crossing before the exit plane; a relaxed overshoot
            # of t_end alone proves nothing and must keep marching (its
            # overlap test fires next round if it jumped the surface)
            escaped = stepping & ~over & (t + safe_adv > t_end)
            nsteps = nsteps + stepping.astype(jnp.int32)
            active = (active & ~now_hit & ~escaped
                      & (nsteps < max_steps))
            if relax_on:
                adv_p = jnp.where(stepping, jnp.where(over, 0.0, adv), adv_p)
                v_p = jnp.where(stepping, v, v_p)
            return t_new, hit | now_hit, active, nsteps, relax, adv_p, v_p

        t, hit, active, nsteps, relax, adv_p, v_p = jax.lax.fori_loop(
            0, inner_steps, inner,
            (t, hit, active, nsteps, relax, adv_p, v_p), unroll=True)
        return t, hit, active, nsteps, relax, adv_p, v_p, k + 1

    if cap_full > 0:
        t, hit, act2, nsteps1, relaxF, advF, vpF, k = jax.lax.while_loop(
            cond, outer, (t, hit0, active0, nsteps0, relax2, adv2, vprev2,
                          jnp.int32(0)))
    else:                          # full phase skipped (LOD-only prefix)
        hit, act2, nsteps1, k = hit0, active0, nsteps0, jnp.int32(0)
        relaxF, advF, vpF = relax2, adv2, vprev2
    kk = jnp.stack([k_lo, k])
    outs = (t, hit, kk)
    if with_stats:
        outs = outs + (nsteps1,)
    if return_state:
        if lo is not None and not merge_leftovers:
            # suspended phase-1 lanes carry their phase-1 relax state
            relaxF = jnp.where(p1_left, relax1, relaxF)
            advF = jnp.where(p1_left, adv1, advF)
            vpF = jnp.where(p1_left, vp1, vpF)
        outs = outs + ((t, hit, p1_left, act2, nsteps1, relaxF, advF, vpF),)
    return outs


# --------------------------------------------------------------------------
# Differentiable trace (custom VJP w.r.t. coefficients)
# --------------------------------------------------------------------------
#
# ``static`` must stay hashable (custom_vjp nondiff args cannot hold
# tracers), so device arrays travel as explicit arguments. Only ``coeffs``
# carries a nonzero cotangent; the packed rows/grid are a read-optimized
# *function of* coeffs used in the forward march only.

def _rebuild_tree(static, child_idx, centre, depth, coeffs) -> Octree:
    n_nodes, deg_used, depth_used, config = static[:4]
    return Octree(child_idx=child_idx, centre=centre, depth=depth,
                  degree=depth,  # unused on the read path; any i32[N] works
                  coeffs=coeffs, n_nodes=n_nodes, deg_used=deg_used,
                  depth_used=depth_used, config=config)


def _rebuild_packed(static, rows, grid) -> PackedTree:
    pmeta = static[6]
    return PackedTree(rows=rows, grid=grid, **pmeta)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _trace_core(static, rows, grid, child_idx, centre, depth, coeffs,
                origins, dirs, t_max):
    hit_eps, max_steps = static[4:6]
    step_cap = static[9] if len(static) > 9 else None
    sort_rays = static[10] if len(static) > 10 else None
    cone_tiles = static[11] if len(static) > 11 else None
    pt = _rebuild_packed(static, rows, grid)
    return _march(pt, origins, dirs, t_max, hit_eps, max_steps, step_cap,
                  sort_rays, cone_tiles)


def _trace_fwd(static, rows, grid, child_idx, centre, depth, coeffs,
               origins, dirs, t_max):
    out = _trace_core(static, rows, grid, child_idx, centre, depth, coeffs,
                      origins, dirs, t_max)
    t, hit, _ = out
    return out, (child_idx, centre, depth, coeffs, origins, dirs, t, hit)


def _trace_bwd(static, res, cts):
    child_idx, centre, depth, coeffs, origins, dirs, t, hit = res
    dt = cts[0]
    p = origins + t[..., None] * dirs

    def f_of_c(c):
        return _values_at(_rebuild_tree(static, child_idx, centre, depth, c),
                          p)

    # df/dt = grad_x f . dir via forward-mode along the ray direction.
    def f_of_t(tv):
        return _values_at(
            _rebuild_tree(static, child_idx, centre, depth, coeffs),
            origins + tv[..., None] * dirs)

    _, dfdt = jax.jvp(f_of_t, (t,), (jnp.ones_like(t),))
    # Implicit function theorem at f = 0: dt = -(df/dc)/(df/dt).
    safe = jnp.where(jnp.abs(dfdt) > 1e-6, dfdt, 1e-6)
    w = jnp.where(hit, -dt / safe, 0.0)
    _, pull = jax.vjp(f_of_c, coeffs)
    (dcoeffs,) = pull(w)

    def zct(x):
        if jnp.issubdtype(x.dtype, jnp.integer):
            return jnp.zeros(x.shape, dtype=jax.dtypes.float0)
        return jnp.zeros_like(x)

    # order: rows, grid, child_idx, centre, depth, coeffs, origins, dirs, t_max
    rows_z = jnp.zeros(static[7], jnp.float32)
    grid_z = jnp.zeros(static[8], jnp.float32)
    return (rows_z, grid_z, zct(child_idx), zct(centre), zct(depth), dcoeffs,
            zct(origins), zct(dirs), jnp.zeros((), origins.dtype))


_trace_core.defvjp(_trace_fwd, _trace_bwd)


def _static_of(tree32: Octree, pt: PackedTree, hit_eps, max_steps,
               step_cap=None, sort_rays=None, cone_tiles=None):
    pmeta = _HashableMeta(dict(
        deg_used=pt.deg_used, grid_depth=pt.grid_depth,
        extra_rounds=pt.extra_rounds, root_centre=pt.root_centre,
        root_sizes=pt.root_sizes))
    return (tree32.n_nodes, tree32.deg_used, tree32.depth_used, tree32.config,
            hit_eps, max_steps, pmeta,
            tuple(pt.rows.shape), tuple(pt.grid.shape), step_cap, sort_rays,
            cone_tiles)


class _HashableMeta:
    """Hashable dict wrapper for custom_vjp static state (supports ** via
    keys/__getitem__)."""

    def __init__(self, d):
        self._d = dict(d)
        self._key = tuple(sorted(d.items()))

    def keys(self):
        return self._d.keys()

    def __getitem__(self, k):
        return self._d[k]

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, _HashableMeta) and self._key == other._key


def trace(tree: Octree, origins: jax.Array, dirs: jax.Array,
          t_max: float = 10.0, hit_eps: float = HIT_EPS,
          max_steps: int = MAX_STEPS,
          packed: PackedTree | None = None,
          step_cap: float | None = None,
          sort_rays: bool | None = None,
          cone_tiles: tuple | None = None) -> TraceResult:
    """Sphere-trace a ray batch against the fitted octree.

    origins, dirs: (B, 3) world-space (dirs should be unit-norm). Returns
    TraceResult(t, hit, steps); ``t`` is differentiable w.r.t. ``tree.coeffs``
    (implicit-function VJP). Pass a precomputed ``packed=pack_tree(tree)``
    when tracing repeatedly -- building it per call costs a host round trip.
    ``sort_rays`` (default: on for multi-chunk batches) groups rays into
    march chunks by expected cost; per-ray results are identical either way
    (lanes only share termination, not arithmetic). ``cone_tiles`` =
    (H, W, T): enable the conservative cone prepass (see cone_start) for
    row-major H x W ray grids -- render() passes this automatically.

    Batched equivalent of Octree::QueryRay (Source/HP/Octree.cpp:705-746).
    """
    tree32 = _tree_f32(tree)
    if packed is None:
        packed = pack_tree(tree)
    origins = jnp.asarray(origins, jnp.float32)
    dirs = jnp.asarray(dirs, jnp.float32)
    t, hit, steps = _trace_core(
        _static_of(tree32, packed, hit_eps, max_steps, step_cap, sort_rays,
                   cone_tiles),
        packed.rows, packed.grid, tree32.child_idx, tree32.centre,
        tree32.depth, tree32.coeffs, origins, dirs, jnp.float32(t_max))
    return TraceResult(t, hit, steps)


# --------------------------------------------------------------------------
# Camera + shading
# --------------------------------------------------------------------------

def camera_rays(eye, look_at, up=(0.0, 1.0, 0.0), fov_deg: float = 40.0,
                width: int = 256, height: int = 256):
    """Pinhole camera ray grid. Returns (origins (H*W, 3), dirs (H*W, 3))."""
    eye = jnp.asarray(eye, jnp.float32)
    fwd = jnp.asarray(look_at, jnp.float32) - eye
    fwd = fwd / jnp.linalg.norm(fwd)
    right = jnp.cross(fwd, jnp.asarray(up, jnp.float32))
    right = right / jnp.linalg.norm(right)
    cam_up = jnp.cross(right, fwd)
    tan = jnp.tan(jnp.deg2rad(jnp.float32(fov_deg)) * 0.5)
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0
    aspect = width / height
    px, py = jnp.meshgrid(xs * tan * aspect, ys * tan, indexing="xy")
    d = (px[..., None] * right + py[..., None] * cam_up + fwd)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    origins = jnp.broadcast_to(eye, d.shape).reshape(-1, 3)
    return origins, d.reshape(-1, 3)


def _normals_at(pt: PackedTree, p: jax.Array) -> jax.Array:
    """Unit surface normals = normalized position-gradient of the packed
    eval (analytic Legendre derivatives; the packed row is re-gathered once)."""
    unit = jnp.clip(accel.to_unit(pt, p), -0.5, 0.5)
    row = accel.locate(pt, unit)
    meta = accel.row_meta(row)
    local = (unit - meta[..., 1:4]) * meta[..., 0:1]
    idx = basis.basis_indices(pt.deg_used)
    L, dL = basis.legendre_all_with_derivative(local, pt.deg_used)
    Lx, Ly, Lz = (L[..., a, idx[:, a]] for a in range(3))
    dLx, dLy, dLz = (dL[..., a, idx[:, a]] for a in range(3))
    W = row.shape[-1]
    gx = jnp.sum(row * accel.pad_products(dLx * Ly * Lz, W), axis=-1)
    gy = jnp.sum(row * accel.pad_products(Lx * dLy * Lz, W), axis=-1)
    gz = jnp.sum(row * accel.pad_products(Lx * Ly * dLz, W), axis=-1)
    g = jnp.stack([gx, gy, gz], axis=-1)
    # chain through local = (unit - centre)*scale and unit = (w - c)/sizes
    g = g * meta[..., 0:1] / jnp.asarray(pt.root_sizes, jnp.float32)
    return g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-12)


@functools.partial(jax.jit, static_argnames=("width", "height", "max_steps"))
def _render_impl(pt: PackedTree, origins, dirs, t_max, width, height,
                 max_steps):
    tiles = ((height, width, CONE_TILE)
             if height % CONE_TILE == 0 and width % CONE_TILE == 0 else None)
    t, hit, _ = _march(pt, origins, dirs, t_max, HIT_EPS, max_steps,
                       cone_tiles=tiles)
    p = origins + t[..., None] * dirs
    normals = _normals_at(pt, p)
    # headlight Lambertian + small ambient
    lam = jnp.maximum(-jnp.sum(normals * dirs, axis=-1), 0.0)
    shade = jnp.where(hit, 0.15 + 0.85 * lam, 0.0)
    img = jnp.stack([shade, shade, shade], axis=-1)
    depth = jnp.where(hit, t, jnp.inf)
    return (img.reshape(height, width, 3), depth.reshape(height, width),
            hit.reshape(height, width))


def render(tree: Octree, eye, look_at, up=(0.0, 1.0, 0.0),
           fov_deg: float = 40.0, width: int = 256, height: int = 256,
           t_max: float = 10.0, max_steps: int = MAX_STEPS,
           packed: PackedTree | None = None):
    """Render the octree SDF with sphere tracing + normal shading.

    Returns (image (H, W, 3) f32 in [0,1], depth (H, W), hit (H, W) bool).
    """
    if packed is None:
        packed = pack_tree(tree)
    origins, dirs = camera_rays(eye, look_at, up, fov_deg, width, height)
    return _render_impl(packed, origins, dirs, jnp.float32(t_max),
                        width, height, max_steps)
