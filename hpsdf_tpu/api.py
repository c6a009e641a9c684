"""Top-level user API.

The batched counterpart of the ``SDF::Octree`` public surface
(reference: Include/HP/Octree.h:50-86): build, query, CSG, serialization.
Functional style -- every operation returns a new (immutable) Octree pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from . import build as _build
from . import query as _query
from .build import CapturedSDF
from .config import Config
from .tree import Octree

SDFFn = Callable[[jax.Array], jax.Array]


def build_octree(config: Config, F: SDFFn, **kw) -> Octree:
    """Approximate the batched SDF callable ``F`` (world pts (K,3) -> (K,)).

    Equivalent of Octree::Create (Source/HP/Octree.cpp:312-352), including
    the continuity post-process when config.continuity is set.
    """
    if config.continuity and "continuity_fn" not in kw:
        from . import continuity as _continuity

        kw["continuity_fn"] = _continuity.enforce_continuity
    return _build.build(config, F, **kw)


query = _query.query
query_with_gradient = _query.query_with_gradient
query_grid = _query.query_grid


def as_sdf(tree: Octree, packed_reads: bool | None = None) -> CapturedSDF:
    """Wrap a fitted octree as a batched SDF callable usable as a build
    input -- the composition mechanism behind the CSG rebuilds.

    Returns a CapturedSDF: the tree's arrays travel through jit as
    ARGUMENTS rather than closure constants, so (a) XLA cannot
    constant-fold multi-million-element gathers on them at compile time
    (measured 126 s per union rebuild in round 1) and (b) the fit programs
    traced for one CSG rebuild are reused verbatim by every later rebuild
    over same-shaped trees.

    ``packed_reads`` selects the read path: the gather-optimized f32 packed
    layout (fast, device-friendly; default for f32/compensated builds whose
    CSG tolerance is 0.05 anyway) or the generic f64 descent (reference
    precision; default for f64 builds).
    """
    if packed_reads is None:
        packed_reads = tree.config.fit_dtype in ("float32", "compensated")
    if packed_reads:
        from . import accel

        pt = accel.pack_tree(tree)

        def fn(caps, pts):
            p = dataclasses.replace(pt, rows=caps[0], grid=caps[1])
            return accel.values_at(p, pts.astype(jnp.float32)).astype(
                pts.dtype)

        key = ("as_sdf_packed", pt.deg_used, pt.grid_depth, pt.extra_rounds,
               pt.root_centre, pt.root_sizes,
               tuple(pt.rows.shape), tuple(pt.grid.shape))
        return CapturedSDF(fn, (pt.rows, pt.grid), key)

    def fn(caps, pts):
        t = dataclasses.replace(tree, child_idx=caps[0], centre=caps[1],
                                depth=caps[2], degree=caps[3],
                                coeffs=caps[4])
        return _query.query(t, pts, outside_value_max=False)

    key = ("as_sdf_generic", tree.deg_used, tree.depth_used, tree.capacity,
           tree.coeff_width, tuple(tree.config.root_min),
           tuple(tree.config.root_max))
    return CapturedSDF(fn, (tree.child_idx, tree.centre, tree.depth,
                            tree.degree, tree.coeffs), key)


def _csg(tree: Octree, F: SDFFn, op: str, combine, **kw) -> Octree:
    old = as_sdf(tree)
    inner = old.fn
    f_call = (F.fn if isinstance(F, CapturedSDF)
              else getattr(F, "call_caps", None))
    if f_call is not None:
        # F carries array state (CapturedSDF / df64.DF64Fn): thread it
        # through jit as an ARGUMENT alongside the tree's captures. Baking
        # it into the combine closure while keying the program by F's
        # STRUCTURAL key would silently reuse the first operand's compiled
        # program for every later same-structure operand (two different
        # df64.Spheres share key ("df64.Sphere",)) -- the round-2 advisor's
        # high-severity stale-cache bug.
        comb = CapturedSDF(
            lambda caps, pts: combine(inner(caps[0], pts),
                                      f_call(caps[1], pts)),
            (old.captures, _build._f_captures(F)),
            (op, old.key, _build._f_key(F)))
    else:
        # plain closure F: nothing to thread; _f_key(F) is id(F), so the
        # cached program can only ever be hit by this exact object (which
        # the cache entry keeps alive -- no id reuse while it lives).
        comb = CapturedSDF(
            lambda caps, pts: combine(inner(caps, pts), F(pts)),
            old.captures, (op, old.key, _build._f_key(F)))
    return build_octree(tree.config, comb, **kw)


def union_sdf(tree: Octree, F: SDFFn, **kw) -> Octree:
    """Rebuild approximating min(tree, F) (Octree::UnionSDF,
    Source/HP/Octree.cpp:355-374)."""
    return _csg(tree, F, "union", jnp.minimum, **kw)


def subtract_sdf(tree: Octree, F: SDFFn, **kw) -> Octree:
    """Rebuild approximating max(-tree, F) (Octree::SubtractSDF,
    Source/HP/Octree.cpp:377-387)."""
    return _csg(tree, F, "subtract", lambda a, b: jnp.maximum(-a, b), **kw)


def intersect_sdf(tree: Octree, F: SDFFn, **kw) -> Octree:
    """Rebuild approximating max(tree, F) (Octree::IntersectSDF,
    Source/HP/Octree.cpp:390-400)."""
    return _csg(tree, F, "intersect", jnp.maximum, **kw)
