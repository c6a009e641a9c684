#!/usr/bin/env python3
"""Smoke test of the hp-SDF main path on one GPU.

    python chip_smoke.py               # every phase, one card
    python chip_smoke.py --devices 4   # only the sharded paths, four cards

Drives the public API (``hpsdf_tpu``, ``hpsdf_tpu.mesh``,
``hpsdf_tpu.inverse``) once at the reference benchmark's own sizes
(Source/Tests/HPBenchmarks.cpp, MeshingBenchmarks.cpp), with every kernel
compiled for the card, and compares each phase with a plain reference.
Each phase prints one JSON line: its checks (tolerance, worst error, and
why that tolerance), wall seconds, and the seconds JAX spent tracing,
lowering and compiling inside it. Any failed check or phase exception
makes the exit code non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, when JAX finds no GPU. One process
drives the card(s); do not run it next to another JAX process on a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback

import numpy as np

# reference-default build (HPBenchmarks.cpp:25-48; the README quick start)
SPHERE_R, SPHERE_C = 0.5, (0.25, 0.0, 0.0)
REFDEFAULT = dict(target_error=1e-10, nearness_strength=3.0, max_degree=12,
                  max_depth=10, node_capacity=600000, continuity=False)
EYE, LOOK_AT = (0.0, 0.0, -1.8), (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Sizes:
    query_pts: int = 8 << 20          # HPBenchmarks.cpp:78-115
    compare_pts: int = 1 << 20
    image: int = 1024
    mesh_subdiv: int = 8              # bumpy sphere, 1,310,720 triangles
    mesh_pts: int = 1 << 20
    mesh_ref_pts: int = 10_000
    ico_subdiv: int = 5               # 20,480 triangles
    inverse_wh: tuple = (1920, 1080)
    inverse_steps: int = 3
    small_fit: tuple = (1e-7, 5, 6)   # target, depth, degree


# --------------------------------------------------------------------------
# Timing and reporting
# --------------------------------------------------------------------------

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]


def _on_duration(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration


class Check:
    """Collects (name, worst error, tolerance, reason) for one phase."""

    def __init__(self):
        self.items = []
        self.info = {}

    def __call__(self, name, err, tol, why):
        err = float(err)
        self.items.append(dict(check=name, worst=err, tol=tol, why=why,
                               ok=bool(np.isfinite(err) and err <= tol)))

    def true(self, name, cond, why):
        self(name, 0.0 if cond else np.inf, 0.0, why)


def run_phase(name, fn, *args):
    """Run one phase; print its line; return whether every check held."""
    import jax

    chk = Check()
    c0, t0 = _compile_s[0], time.perf_counter()
    err = None
    try:
        fn(chk, *args)
        jax.effects_barrier()
    except Exception:                                   # reported, not hidden
        err = traceback.format_exc()
    wall = time.perf_counter() - t0
    worst = max(chk.items, default=None, key=lambda c: (
        not c["ok"], c["worst"] / max(c["tol"], 1e-300)))
    ok = err is None and bool(chk.items) and all(c["ok"] for c in chk.items)
    line = dict(phase=name, ok=ok, wall_s=wall,
                compile_s=_compile_s[0] - c0,
                tol=worst and worst["tol"], worst=worst and worst["worst"],
                worst_check=worst and worst["check"], checks=chk.items,
                **chk.info)
    if err is not None:
        line["error"] = err[-3000:]
    print(json.dumps(line), flush=True)
    return ok


def timed(fn, *args):
    """(result, seconds) with the result blocked until ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def _sphere_sdf(p):
    return np.linalg.norm(p - np.asarray(SPHERE_C), axis=-1) - SPHERE_R


def refdefault_config(**kw):
    import hpsdf_tpu as hp

    return hp.Config(nearness_weighting=hp.NearnessWeighting.EXPONENTIAL,
                     **{**REFDEFAULT, **kw})


def phase_fit(chk, sz, state):
    import jax.numpy as jnp
    import hpsdf_tpu as hp

    F = hp.df64.Sphere(SPHERE_R, centre=SPHERE_C)
    rng = np.random.default_rng(0)
    P = rng.uniform(-0.5, 0.5, (sz.compare_pts, 3))
    Pj = jnp.asarray(P)
    want = _sphere_sdf(P)
    # the distance field has a kink at the sphere centre, which no
    # polynomial leaf represents; the check holds away from it
    smooth = np.linalg.norm(P - np.asarray(SPHERE_C), axis=1) > 0.05
    vals = {}
    for dt in ("float64", "compensated"):
        cfg = refdefault_config(fit_dtype=dt)
        c0, t0 = _compile_s[0], time.perf_counter()
        hp.build_octree(cfg, F).coeffs.block_until_ready()
        cold, cold_compile = time.perf_counter() - t0, _compile_s[0] - c0
        t0 = time.perf_counter()
        tree = hp.build_octree(cfg, F)
        tree.coeffs.block_until_ready()
        warm = time.perf_counter() - t0
        q = np.asarray(hp.query(tree, Pj))
        vals[dt] = q
        chk(f"{dt}_vs_analytic", np.max(np.abs(q - want)[smooth]), 1e-4,
            "target_error 1e-10 bounds the summed squared top-degree "
            "coefficients; pointwise error 1e-4 away from the centre kink")
        chk.info[dt] = dict(nodes=tree.n_nodes, deg_used=tree.deg_used,
                            depth_used=tree.depth_used, cold_build_s=cold,
                            cold_compile_s=cold_compile, warm_build_s=warm,
                            max_err_incl_kink=float(np.max(np.abs(q - want))))
        if dt == "float64":
            state["tree"] = tree
    chk("float64_vs_compensated",
        np.max(np.abs(vals["float64"] - vals["compensated"])), 1e-5,
        "both fits project at ~1e-15 relative; trees may differ only in "
        "near-tie refinement decisions, far below the 1e-4 fit error")


def phase_continuity(chk, sz, state):
    import jax.numpy as jnp
    import hpsdf_tpu as hp
    from hpsdf_tpu import continuity, oracle

    F = hp.df64.Sphere(SPHERE_R, centre=SPHERE_C)
    cfg = refdefault_config(continuity=True, continuity_strength=8.0,
                            enable_logging=True)
    # HPBenchmarks.cpp:51-75: the reference-default build + strength 8
    tree = hp.build_octree(cfg, F, continuity_fn=None)
    t0 = time.perf_counter()
    ref = oracle.scipy_continuity(tree, 8.0)
    chk.info["scipy_oracle_s"] = time.perf_counter() - t0
    chk.info["leaves"] = int(tree.num_leaves())
    P = jnp.asarray(np.random.default_rng(1).uniform(-0.5, 0.5,
                                                     (sz.compare_pts, 3)))
    qr = np.asarray(hp.query(ref, P))
    for mode in ("f64", "mixed"):
        continuity.enforce_continuity(tree, cg=mode)      # compile
        t0 = time.perf_counter()
        out = continuity.enforce_continuity(tree, cg=mode)
        out.coeffs.block_until_ready()
        chk.info[f"{mode}_warm_s"] = time.perf_counter() - t0
        chk.info[f"{mode}_device"] = str(out.coeffs.devices())
        q = np.asarray(hp.query(out, P))
        chk(f"cg_{mode}_vs_scipy", np.max(np.abs(q - qr)), 1e-4,
            "every solver stops at ||r|| <= 1e-6 ||b||; the solutions may "
            "differ by that residual times the system's conditioning")


def phase_query(chk, sz, state):
    import jax
    import jax.numpy as jnp
    import hpsdf_tpu as hp
    from hpsdf_tpu import accel

    tree = state["tree"]
    P = np.random.default_rng(2).uniform(-0.5, 0.5, (sz.query_pts, 3))
    p64 = jnp.asarray(P)
    p32 = jnp.asarray(P.astype(np.float32))
    packed = hp.pack_tree(tree)
    n = sz.compare_pts
    out = {}
    for name, fn, arg in (
            ("packed_f32", accel.query_packed, p32),
            ("query_f64", hp.query, p64),
            ("query_with_gradient_f64", hp.query_with_gradient, p64)):
        if name == "packed_f32":
            f = lambda x: fn(packed, x)                    # noqa: E731
        else:
            f = lambda x, fn=fn: fn(tree, x)               # noqa: E731
        timed(f, arg)                                      # compile
        res, dt = timed(f, arg)
        out[name] = res
        chk.info[f"{name}_s"] = dt
        chk.info[f"{name}_device"] = str(jax.tree.leaves(res)[0].devices())
    v64 = np.asarray(out["query_f64"][:n])
    chk("packed_vs_f64", np.max(np.abs(np.asarray(out["packed_f32"][:n])
                                       - v64)), 1e-5,
        "packed rows hold the coefficients in f32 (~6e-8 relative) summed "
        "over <= 455 basis products")
    vg, g = out["query_with_gradient_f64"]
    chk("grad_value_vs_query", np.max(np.abs(np.asarray(vg[:n]) - v64)),
        1e-12, "same f64 descent and basis sum")
    Pn = P[:n]
    r = np.linalg.norm(Pn - np.asarray(SPHERE_C), axis=1)
    normal = (Pn - np.asarray(SPHERE_C)) / r[:, None]
    dots = np.sum(np.asarray(g[:n]) * normal, axis=1)
    chk("gradient_vs_analytic_normal", np.max((1.0 - dots)[r > 0.05]), 1e-3,
        "unit gradient of a 1e-4-accurate fit, away from the centre kink")


def _analytic_depth(o, d):
    c = np.asarray(SPHERE_C)
    oc = o - c
    b = np.sum(oc * d, axis=1)
    disc = b * b - (np.sum(oc * oc, axis=1) - SPHERE_R ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return np.where(disc > 0, t, np.inf)


def phase_trace(chk, sz, state):
    import jax.numpy as jnp
    import hpsdf_tpu as hp

    small_target, small_depth, small_deg = sz.small_fit
    small = hp.build_octree(hp.Config(target_error=small_target,
                                      max_depth=small_depth,
                                      max_degree=small_deg,
                                      continuity=False, fit_dtype="float64"),
                            hp.df64.Sphere(0.3))
    W = H = sz.image
    o, d = hp.camera_rays(EYE, LOOK_AT, width=W, height=H)
    o_np, d_np = np.asarray(o, np.float64), np.asarray(d, np.float64)
    for name, tree, centre, radius in (
            ("refdefault", state["tree"], SPHERE_C, SPHERE_R),
            ("depth5_degree6", small, (0.0, 0.0, 0.0), 0.3)):
        packed = hp.pack_tree(tree)
        render = lambda: hp.render_image(tree, EYE, LOOK_AT, width=W,  # noqa
                                         height=H, t_max=5.0, packed=packed)
        timed(render)                                      # compile
        (_, depth, hit), dt = timed(render)
        chk.info[f"{name}_render_s"] = dt
        chk.info[f"{name}_mrays_per_s"] = W * H / dt / 1e6
        plain = hp.trace(tree, o, d, t_max=5.0, packed=packed,
                         sort_rays=False)
        hit = np.asarray(hit).reshape(-1)
        depth = np.asarray(depth).reshape(-1)
        hit_p = np.asarray(plain.hit)
        t_p = np.asarray(plain.t)
        chk(f"{name}_hit_vs_plain", np.mean(hit != hit_p), 1e-3,
            "schedules differ only in ray order and over-relaxation; a "
            "silhouette-grazing ray may land on either side of hit_eps")
        both = hit & hit_p
        chk(f"{name}_depth_vs_plain", np.max(np.abs(depth - t_p)[both]),
            2e-3, "both stop within hit_eps=1e-4 of the surface; grazing "
            "rays convert that to a longer depth difference")
        # analytic ray-sphere depth, where the hit lies inside the root box
        # (beyond it the tree does not represent the sphere)
        c = np.asarray(centre)
        oc = o_np - c
        b = np.sum(oc * d_np, axis=1)
        disc = b * b - (np.sum(oc * oc, axis=1) - radius ** 2)
        t_a = -b - np.sqrt(np.maximum(disc, 0.0))
        inside = np.all(np.abs(o_np + t_a[:, None] * d_np) < 0.499, axis=1)
        ok_rays = both & (disc > 1e-3) & inside
        chk(f"{name}_depth_vs_analytic",
            np.median(np.abs(depth - t_a)[ok_rays]), 1e-4,
            "median over hit rays: fit error 1e-4 and hit_eps 1e-4")
        chk(f"{name}_hits_analytic", np.mean(hit[ok_rays] != (disc > 0)
                                               [ok_rays]), 1e-3,
            "rays that clearly cross the sphere inside the box must hit")
        chk.info[f"{name}_hit_fraction"] = float(np.mean(hit))


def phase_mesh(chk, sz, state):
    import jax
    import jax.numpy as jnp
    from hpsdf_tpu import native
    from hpsdf_tpu.mesh import build_bvh, build_mesh, gen, mesh_sdf
    from hpsdf_tpu.mesh import sdf as msdf

    t0 = time.perf_counter()
    chk.info["native"] = native.available()
    chk.info["native_build_s"] = time.perf_counter() - t0
    v, f = gen.bumpy_sphere(0.3, sz.mesh_subdiv)
    t0 = time.perf_counter()
    mesh = build_mesh(v, f)
    chk.info["mesh_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bvh = build_bvh(mesh)
    bvh.tri_rows.block_until_ready()
    chk.info["bvh_build_s"] = time.perf_counter() - t0
    chk.info["triangles"] = int(mesh.n_faces)
    rng = np.random.default_rng(3)
    pts = jnp.asarray(rng.uniform(-0.5, 0.5, (sz.mesh_pts, 3)), jnp.float32)
    F = jax.jit(mesh_sdf(mesh, bvh=bvh, method="hybrid"))
    timed(F, pts)
    got, dt = timed(F, pts)
    chk.info["hybrid_s"] = dt
    sub = pts[:sz.mesh_ref_pts]
    Fx = jax.jit(mesh_sdf(mesh, bvh=bvh, method="bvh", max_iters=0))
    want, dt = timed(Fx, sub)
    chk.info["bvh_exact_s"] = dt
    err = np.abs(np.asarray(got[:sz.mesh_ref_pts]) - np.asarray(want))
    lo, hi = msdf.cluster_aabbs(bvh)
    d2, _, bd = msdf._hybrid_closest(lo, hi, bvh.node_rows, bvh.tri_rows,
                                     sub, msdf.HYBRID_K1, msdf.HYBRID_K2)
    chk("hybrid_vs_exact_over_bound",
        np.max(err - msdf._dist_err_bound(d2, bd)), 1e-6,
        "the fixed-K prune certifies each query's error bound")
    near = np.abs(np.asarray(want)) < 0.1
    chk.info["hybrid_fixed_k_max_err"] = float(np.max(err))
    chk.info["hybrid_fixed_k_max_err_near_surface"] = float(np.max(err[near]))
    # the escalating path: queries whose bound exceeds atol=0 re-run wider,
    # then through the exact O(T) scan
    esc = np.asarray(msdf.signed_distance_hybrid(bvh, sub))
    chk("hybrid_escalating_vs_exact", np.max(np.abs(esc - np.asarray(want))),
        1e-6, "exact by certificate; f32 rounding and tie order only")

    vi, fi = gen.icosphere(0.3, sz.ico_subdiv)
    ico = build_mesh(vi, fi)
    bvh_i = build_bvh(ico)
    chk.info["ico_triangles"] = int(ico.n_faces)
    Ft = jax.jit(mesh_sdf(ico, bvh=bvh_i, method="tiles"))
    timed(Ft, pts)
    got_t, dt = timed(Ft, pts)
    chk.info["tiles_s"] = dt
    sub = pts[:sz.mesh_ref_pts]
    brute = np.asarray(msdf.signed_distance_brute(bvh_i.tri_rows, sub))
    chk("tiles_vs_brute", np.max(np.abs(np.asarray(got_t[:sz.mesh_ref_pts])
                                        - brute)), 1e-6,
        "same closest triangle and epilogue; f32 rounding only")


def phase_inverse(chk, sz, state):
    import jax
    import jax.numpy as jnp
    import hpsdf_tpu as hp
    from hpsdf_tpu import inverse

    target, depth, deg = sz.small_fit
    cfg = hp.Config(target_error=target, max_depth=depth, max_degree=deg,
                    continuity=False, fit_dtype="float64")
    tgt = hp.build_octree(cfg, hp.df64.Sphere(0.3))
    init = hp.build_octree(cfg, hp.df64.Sphere(0.27))
    W, H = sz.inverse_wh
    o, d = hp.camera_rays(EYE, LOOK_AT, width=W, height=H)
    t_star, hit_star = inverse.render_targets(tgt, o, d, t_max=5.0)
    # lr 3e-4: the default 3e-3 is tuned for runs of tens of steps, and its
    # first Adam steps (every coefficient moved by ~lr) raise the loss
    # before it falls; three small steps test that the gradient descends
    lr = 3e-4
    res, dt = timed(lambda: inverse.fit_to_depth(
        init, o, d, t_star, hit_star, n_steps=sz.inverse_steps, t_max=5.0,
        lr=lr))
    losses = np.asarray(res.losses)
    chk.info["rays"] = W * H
    chk.info["lr"] = lr
    chk.info["losses"] = losses.tolist()
    chk.info["fit_to_depth_s"] = dt
    chk.true("losses_finite", np.all(np.isfinite(losses)),
             "a finite loss at every step")
    chk.true("loss_decreases", losses[-1] < losses[0],
             "small Adam steps on the coefficients lower the loss")
    # step 0 with only the depth term equals depth_loss of a direct trace
    # of the initial tree (same capped march as the optimizer uses)
    res0 = inverse.fit_to_depth(init, o, d, t_star, hit_star, n_steps=1,
                                t_max=5.0, surface_weight=0.0,
                                eikonal_weight=0.0, depth_weight=1.0)
    t0_, h0_ = inverse.render_targets(init, o, d, t_max=5.0, step_cap=0.02)
    direct = float(inverse.depth_loss(t0_, h0_, t_star, hit_star))
    step0 = float(res0.losses[0])
    chk.info["depth_loss_step0"] = step0
    chk.info["depth_loss_direct"] = direct
    chk("step0_vs_direct", abs(step0 - direct) / max(abs(direct), 1e-30),
        1e-3, "packing from folded f32 coefficients rounds differently "
        "from pack_tree: ~1e-7 relative in depth")
    jax.block_until_ready(res.tree.coeffs)


def phase_sharded(chk, sz, state, n_dev):
    """The sharded paths on ``n_dev`` cards, each against one card."""
    import jax
    import jax.numpy as jnp
    import hpsdf_tpu as hp
    from hpsdf_tpu import continuity, parallel

    devs = jax.devices()[:n_dev]
    chk.info["devices"] = len(devs)
    F = hp.df64.Sphere(SPHERE_R, centre=SPHERE_C)
    cfg = refdefault_config(fit_dtype="float64")
    mesh = parallel.make_mesh(devs, node_parallel=1)
    tree = hp.build_octree(cfg, F)
    tree_sh, dt = timed(lambda: hp.build_octree(cfg, F, fit_mesh=mesh))
    chk.info["fit_mesh_build_s"] = dt
    same_topology = tree_sh.coeffs.shape == tree.coeffs.shape and all(
        np.array_equal(np.asarray(a), np.asarray(b)) for a, b in (
            (tree_sh.child_idx, tree.child_idx),
            (tree_sh.degree, tree.degree)))
    chk.info["fit_mesh_same_topology"] = bool(same_topology)
    chk("fit_mesh_vs_one_device", np.max(np.abs(
        np.asarray(tree_sh.coeffs) - np.asarray(tree.coeffs)))
        if same_topology else np.inf, 0.0,
        "each card runs the single-card block shape: bit-identical")
    P = np.random.default_rng(4).uniform(-0.5, 0.5, (sz.compare_pts, 3))

    W = H = sz.image
    o, d = hp.camera_rays(EYE, LOOK_AT, width=W, height=H)
    res = parallel.shard_trace(tree, o, d, mesh, t_max=5.0)
    one = hp.trace(tree, o, d, t_max=5.0)
    chk("ray_sharded_trace_hits", np.mean(np.asarray(res.hit)
                                          != np.asarray(one.hit)), 0.0,
        "rays are independent; sharding only splits the batch")
    both = np.asarray(res.hit) & np.asarray(one.hit)
    chk("ray_sharded_trace_depth", np.max(np.abs(np.asarray(res.t)
                                                 - np.asarray(one.t))[both]),
        1e-5, "same per-ray march; f32 rounding of fused code may differ")

    mesh_np = parallel.make_mesh(devs, node_parallel=2)
    q = np.asarray(parallel.shard_query(tree, P, mesh_np, shard_nodes=True))
    q1 = np.asarray(hp.query(tree, jnp.asarray(P)))
    chk("node_sharded_query", np.max(np.abs(q - q1)), 1e-12,
        "the same f64 descent; node rows are gathered across cards")

    tree_c = dataclasses.replace(tree, config=dataclasses.replace(
        tree.config, continuity=True, continuity_strength=8.0))
    c1 = np.asarray(continuity.enforce_continuity(tree_c).coeffs)
    c4 = np.asarray(continuity.enforce_continuity(tree_c, mesh=mesh).coeffs)
    chk("row_sharded_cg", np.max(np.abs(c4 - c1)) / np.max(np.abs(c1)), 1e-5,
        "both f64 CGs stop at ||r|| <= 1e-6 ||b||; sums run in another order")

    step = parallel.make_sharded_train_step(mesh_np, tree, shard_nodes=True)
    Pt = P[: 1 << 16]
    target = _sphere_sdf(Pt)
    new_tree, loss = step(tree, Pt, target, lr=1e-4)
    new1, loss1 = parallel.train_step(tree, jnp.asarray(Pt),
                                      jnp.asarray(target), 1e-4)
    chk("sharded_train_step_loss",
        abs(float(loss) - float(loss1)) / abs(float(loss1)), 1e-10,
        "f64 loss; only the reduction order differs")
    chk("sharded_train_step_coeffs",
        np.max(np.abs(np.asarray(new_tree.coeffs) - np.asarray(new1.coeffs))),
        1e-12, "f64 gradient psum over the batch axis")


# --------------------------------------------------------------------------
# Entry
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: every phase on one card; N>1: only the "
                         "sharded paths on N cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (default device: {devs[0].platform})",
              file=sys.stderr)
        return 2
    if len(devs) < args.devices:
        print(f"chip_smoke: {args.devices} devices asked, {len(devs)} found",
              file=sys.stderr)
        return 2

    from hpsdf_tpu import compile_cache

    cache = compile_cache.enable()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(device_kind=devs[0].device_kind,
                          jax=jax.__version__, compile_cache=cache)))
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)

    sz = Sizes()
    state: dict = {}
    t0 = time.perf_counter()
    if args.devices > 1:
        ok = run_phase("sharded", phase_sharded, sz, state, args.devices)
    else:
        ok = True
        for name, fn in (("fit", phase_fit), ("continuity", phase_continuity),
                         ("query", phase_query), ("trace", phase_trace),
                         ("mesh", phase_mesh), ("inverse", phase_inverse)):
            if name in ("query", "trace") and "tree" not in state:
                print(json.dumps(dict(phase=name, ok=False,
                                      error="no fitted tree")), flush=True)
                ok = False
                continue
            ok = run_phase(name, fn, sz, state) and ok
    print(json.dumps(dict(total_s=time.perf_counter() - t0,
                          compile_s=_compile_s[0])), flush=True)
    if not ok:
        return 1
    used = jax.devices()[:args.devices]
    print(json.dumps({"ok": True, "device": {
        "platform": used[0].platform, "kind": used[0].device_kind,
        "count": len(used)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
