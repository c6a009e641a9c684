"""Differentiable inverse rendering: optimize octree coefficients from
target depth images.

This is the end-to-end differentiable loop the reference cannot express
(its QueryRay is a scalar CPU march, Source/HP/Octree.cpp:705-746, with no
gradients): sphere-trace a ray batch through the fitted tree, compare hit
depths against targets, and pull the loss back to the node coefficients
through the implicit-function VJP of the march (render.py). Each step
re-derives the packed read layout from the current coefficients on device
(accel.repack), so the whole optimization is one jitted scan.

Scaling note: the forward/backward trace is batched over rays, so sharding
the ray axis with parallel.shard_trace-style pjit and psum-ing the
coefficient gradient extends this to multi-chip meshes unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import accel, render as R
from .tree import Octree


class InverseResult(NamedTuple):
    tree: Octree          # tree carrying the optimized coefficients
    losses: jax.Array     # (n_steps,) f32 loss trajectory


def depth_loss(t, hit, target_t, target_hit):
    """Masked L2 depth loss: rays counted only where both the current and
    the target trace hit (miss/hit disagreement is non-differentiable)."""
    m = (hit & target_hit).astype(jnp.float32)
    n = jnp.maximum(jnp.sum(m), 1.0)
    return jnp.sum(m * (t - target_t) ** 2) / n


def fit_to_depth(tree: Octree, origins, dirs, target_t, target_hit,
                 n_steps: int = 100, lr: float = 3e-3, t_max: float = 10.0,
                 max_steps: int = R.MAX_STEPS,
                 surface_weight: float = 1.0,
                 depth_weight: float = 0.1,
                 anchor_weight: float = 1.0,
                 eikonal_weight: float = 0.1,
                 ray_chunk: int = 1 << 16,
                 param_space: str = "folded",
                 lr_warmup: int = 5,
                 mesh=None) -> InverseResult:
    """Gradient-descent the tree's coefficients so its sphere-traced depths
    match ``target_t`` on ``target_hit`` rays (Adam, jitted lax.scan).

    origins, dirs: (B, 3); target_t: (B,); target_hit: (B,) bool.

    The loss combines (a) the marched-depth L2 through the implicit-function
    VJP of the trace, (b) ``surface_weight`` * [f(x*)^2 at the target hit
    points x* = o + t* d, plus sign-band hinges at x* -+ band along the
    ray: f must stay positive a band BEFORE the target surface and go
    negative a band BEHIND it]. The field terms are required for
    convergence, not a frill: the depth term's gradient reaches only the
    coefficients of the leaf the ray currently hits in (the surface stalls
    at the first leaf boundary it would have to cross), and the bare f^2
    term alone lets f TOUCH zero without crossing (the march steps over
    such a dip). Together they differentiate the field at and around the
    TARGET points, reaching the correct leaves with the correct sign.
    ``anchor_weight`` * mean((c - c0)^2) regularizes toward the initial
    coefficients: the constraints are sparse point samples and an
    unregularized polynomial basis oscillates wildly between them (the
    field stops being SDF-like and the march misbehaves); anchoring to a
    valid SDF keeps the deformation minimal. ``eikonal_weight`` *
    (|grad f| - 1)^2 at the band points keeps the optimized field
    metric (IGR-style): sphere tracing assumes |grad f| <= 1, and an
    unconstrained fit develops slopes >> 1 at the new surface, which makes
    even a capped march overshoot the crossing.

    Rays are processed in ``ray_chunk``-sized rematerialized chunks inside
    a lax.scan, so the working set is chunk-sized regardless of B --
    1920x1080 ray grids (BASELINE config #5) fit one chip.

    ``param_space`` selects the optimization coordinates:

      * ``"folded"`` (default): Adam runs on the normalizer-premultiplied
        coefficients (the packed-row coefficient lanes, accel._pack_rows).
        Adam's per-coordinate steps are ~lr-sized regardless of parameter
        scale, so in RAW coordinates a first-moment kick of lr on a
        degree-6/depth-5 coefficient gets amplified by its eq-(4)
        normalizer sqrt((2p+1) 2^d)^3 (up to ~1e3) when it reaches the
        field -- one Adam step can wreck the fit (measured: the 1080p
        bench's loss jumped 0.002 -> 1400 on step 1 and the depth RMSE
        never recovered within 40 steps). In folded space a ±lr step
        changes the field contribution by O(lr) uniformly across degrees
        and depths.
      * ``"raw"``: optimize tree.coeffs directly (round-2 behavior).

    ``mesh``: optional jax.sharding.Mesh with a ``batch`` axis -- rays
    shard across it inside every chunk (tree/packed tables replicated, the
    coefficient gradient psum-aggregated by XLA from the shardings). The
    BASELINE config-#5 multi-chip path; per-step results match the
    single-device run (rays only share reductions).
    """
    import optax

    tree32 = R._tree_f32(tree)
    packed = accel.pack_tree(tree)
    support = accel.pack_support(tree)
    # capped march: a half-optimized field is not a metric SDF, and the
    # uncapped sphere trace would step over its thin zero-crossing band
    static = R._static_of(tree32, packed, R.HIT_EPS, max_steps,
                          step_cap=0.02)
    origins = jnp.asarray(origins, jnp.float32)
    dirs = jnp.asarray(dirs, jnp.float32)
    target_t = jnp.asarray(target_t, jnp.float32)
    target_hit = jnp.asarray(target_hit)
    tm = jnp.float32(t_max)

    B = origins.shape[0]
    chunk = min(ray_chunk, B)
    pad = (-B) % chunk
    if pad:
        # padded rays: target_hit False, so every masked term ignores them
        origins = jnp.concatenate(
            [origins, jnp.broadcast_to(origins[-1:], (pad, 3))])
        dirs = jnp.concatenate([dirs, jnp.broadcast_to(dirs[-1:], (pad, 3))])
        target_t = jnp.concatenate([target_t, jnp.zeros(pad, jnp.float32)])
        target_hit = jnp.concatenate(
            [target_hit, jnp.zeros(pad, bool)])
    n_chunks = origins.shape[0] // chunk

    def chunks_of(x):
        return x.reshape((n_chunks, chunk) + x.shape[1:])

    data = (chunks_of(origins), chunks_of(dirs), chunks_of(target_t),
            chunks_of(target_hit))

    if mesh is not None:
        # rays shard across the mesh batch axis within each chunk; every
        # other array the step closes over is replicated explicitly (mixed
        # implicit placements would conflict under jit)
        from jax.sharding import NamedSharding, PartitionSpec as P
        from .parallel import BATCH_AXIS
        rep = NamedSharding(mesh, P())
        ray_spec = [P(None, BATCH_AXIS, None), P(None, BATCH_AXIS, None),
                    P(None, BATCH_AXIS), P(None, BATCH_AXIS)]
        data = tuple(jax.device_put(x, NamedSharding(mesh, s))
                     for x, s in zip(data, ray_spec))
        tree32 = jax.device_put(tree32, rep)
        packed = jax.device_put(packed, rep)
        support = jax.device_put(support, rep)
        target_hit = jax.device_put(target_hit, rep)

    # lr WARMUP NOTE: a linear ramp measured badly in RAW coefficient
    # space, where Adam's sign-like early steps get amplified by the eq-(4)
    # normalizers regardless of ramp. In FOLDED space (512^2 sphere
    # recovery): the step-1 Adam transient
    # (bias-corrected update = lr*sign(g) elementwise, all ~400k
    # coefficients kicked by the full lr at once) spikes the loss 12.8x
    # and costs final accuracy; a 5-step linear ramp cuts the spike to
    # 1.38x and HALVES the final depth RMSE (0.0129 -> 0.0061, vs 0.0073
    # for lr/2 and 0.0086 for 3x more steps). Warmup is the measured
    # winner in folded space and the default.
    if param_space not in ("folded", "raw"):
        raise ValueError(f"param_space must be 'folded' or 'raw', "
                         f"got {param_space!r}")
    folded_space = param_space == "folded"
    if lr_warmup > 0:
        sched = lambda count: lr * jnp.minimum(  # noqa: E731
            1.0, (count.astype(jnp.float32) + 1.0) / lr_warmup)
        opt = optax.adam(sched)
    else:
        opt = optax.adam(lr)
    coeffs0 = tree.coeffs.astype(jnp.float32)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        coeffs0 = jax.device_put(coeffs0, NamedSharding(mesh, P()))
    fold = support.fold                       # f32 (Np, cw), strictly > 0
    inv_fold = 1.0 / fold
    params0 = coeffs0 * fold if folded_space else coeffs0
    band = jnp.float32(0.02)
    fracs = jnp.asarray([0.35, 0.6, 0.8, 0.93], jnp.float32)
    surf_n = jnp.maximum(jnp.sum(target_hit.astype(jnp.float32)), 1.0)
    sw = jnp.float32(surface_weight)
    half = band * 0.5

    def chunk_field(c32, pk_rows, pk_grid, od, t, hit):
        """Per-chunk loss sums GIVEN the marched (t, hit). Returns
        (rest_sum, depth_sum, depth_n): the field/eikonal terms normalized
        by the fixed target-hit count, plus the UN-normalized masked depth
        sum and its mask count -- the depth term is normalized by the total
        (hit & target_hit) count accumulated across chunks, matching
        depth_loss()'s contract (the round-2 advisor flagged a fixed
        surf_n proxy here, which down-weighted depth whenever the current
        trace missed many target hits -- exactly the early-optimization
        regime).

        The march itself runs OUTSIDE this function and outside
        jax.checkpoint: its custom VJP (render._trace_bwd) differentiates
        from the small (t, hit) residuals without re-marching, so wrapping
        it in remat re-executed the most expensive phase of the step for
        nothing (measured 2x step cost).

        Field terms read through the packed f32 layout (accel.values_at on
        the repacked rows, which are a differentiable linear function of
        the coefficients) -- one wide gather per point instead of the
        generic path's ~depth_used narrow gathers, which dominates the
        step cost at 1080p ray counts."""
        o, d, t_tgt, h_tgt = od
        m = (hit & h_tgt).astype(jnp.float32)
        depth_sum = jnp.sum(m * (t - t_tgt) ** 2)
        pk_t = dataclasses.replace(packed, rows=pk_rows, grid=pk_grid)
        surf_m = h_tgt.astype(jnp.float32)
        surf_pts = o + t_tgt[..., None] * d
        out_pts = o + (t_tgt - band)[..., None] * d
        in_pts = o + (t_tgt + band)[..., None] * d
        free_pts = (o[None] + (fracs[:, None, None]
                               * t_tgt[None, :, None]) * d[None])
        fsurf = accel.values_at(pk_t, surf_pts)
        f_in = accel.values_at(pk_t, in_pts)   # want <= -band/2 (inside)
        f_out = accel.values_at(pk_t, out_pts)  # want >= +band/2 (outside)
        f_free = accel.values_at(pk_t, free_pts.reshape(-1, 3))
        field = (fsurf ** 2
                 + jax.nn.relu(f_in + half) ** 2
                 + jax.nn.relu(half - f_out) ** 2)
        free_sum = jnp.sum(surf_m[None]
                           * jax.nn.relu(half - f_free.reshape(
                               free_pts.shape[:2])) ** 2)
        # eikonal: per-point spatial gradients of the band points in one
        # backward pass (grad of the sum = per-point gradient)
        band_pts = jnp.concatenate([surf_pts, in_pts, out_pts], axis=0)
        gpts = jax.grad(
            lambda P: jnp.sum(accel.values_at(pk_t, P)))(band_pts)
        # eps inside the sqrt: a zero spatial gradient (flat fit, or a
        # masked miss-ray point) has a NaN norm-gradient otherwise
        gnorm = jnp.sqrt(jnp.sum(gpts * gpts, axis=-1) + 1e-12)
        m3 = jnp.concatenate([surf_m, surf_m, surf_m], axis=0)
        eik_sum = jnp.sum(m3 * (gnorm - 1.0) ** 2)
        rest = (sw * (jnp.sum(surf_m * field)
                      + free_sum / fracs.shape[0]) / surf_n
                + jnp.float32(eikonal_weight) * eik_sum / (3.0 * surf_n))
        return rest, depth_sum, jnp.sum(m)

    chunk_field = jax.checkpoint(chunk_field)

    def loss_fn(params):
        p32 = params.astype(jnp.float32)
        if folded_space:
            c32 = p32 * inv_fold
            pk = accel.repack_folded(packed, support, p32)
        else:
            c32 = p32
            pk = accel.repack(packed, support, c32)

        def body(acc, od):
            o, d = od[0], od[1]
            t, hit, _ = R._trace_core(
                static, pk.rows, pk.grid, tree32.child_idx, tree32.centre,
                tree32.depth, c32, o, d, tm)
            rest, ds, dn = chunk_field(c32, pk.rows, pk.grid, od, t, hit)
            a_rest, a_ds, a_dn = acc
            return (a_rest + rest, a_ds + ds, a_dn + dn), None

        (rest, ds, dn), _ = jax.lax.scan(
            body, (jnp.float32(0.0),) * 3, data)
        anchor = jnp.float32(anchor_weight) * jnp.mean((p32 - params0) ** 2)
        return (rest + jnp.float32(depth_weight) * ds / jnp.maximum(dn, 1.0)
                + anchor)

    @jax.jit
    def run(params0):
        def step(carry, _):
            params, opt_state = carry
            loss, g = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = opt.update(g, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), loss

        state0 = (params0, opt.init(params0))
        (params, _), losses = jax.lax.scan(step, state0, None,
                                           length=n_steps)
        return params, losses

    params, losses = run(params0)
    coeffs = params * inv_fold if folded_space else params
    out = dataclasses.replace(tree, coeffs=coeffs.astype(tree.coeffs.dtype))
    return InverseResult(tree=out, losses=losses)


def render_targets(tree: Octree, origins, dirs, t_max: float = 10.0,
                   step_cap: float | None = None):
    """Trace a reference tree to produce (target_t, target_hit) for
    fit_to_depth. Pass ``step_cap~=0.02`` when tracing a PARTIALLY
    OPTIMIZED tree (its field is not a metric SDF and the uncapped sphere
    trace can step over the surface)."""
    res = R.trace(tree, origins, dirs, t_max=t_max, step_cap=step_cap)
    return res.t, res.hit
