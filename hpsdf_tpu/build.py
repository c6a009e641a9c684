"""Level-synchronous hp-adaptive octree construction.

Batched redesign of the reference build path (SURVEY.md section 3.1;
Source/HP/Octree.cpp:194-352, 558-659, 1007-1093):

  reference                              this module
  ---------------------------------     ---------------------------------
  dynamic priority queue + thread        rounds: ALL nodes above the
  pool popping max-error nodes           equidistribution threshold refine
  (Octree.cpp:216-240)                   together, as one batched device op
  per-node scalar (4d+1)^3 quadrature    separable Gauss-Legendre projection:
  loop (Octree.cpp:1028-1056)            three axis contractions (matmuls)
                                         over the whole frontier at once
  100-sample Monte-Carlo nearness mean   exact cell mean c_000 * 2**(1.5*depth)
  (Octree.cpp:1209-1247)                 (Legendre bases >0 have zero mean)
  h/p decision per popped node           vectorized eqs (8)/(9) over the round
  (Octree.cpp:594-601)

Refinement-order semantics differ from the reference's greedy max-error-first
queue: a round refines every leaf whose error exceeds target_error/n_leaves.
If all leaves fall below that per-leaf share the total is below target, so
the stopping criterion (total error < target, Octree.cpp:216) is met with the
same tolerance guarantees; the round-synchronous schedule may refine slightly
more nodes but each round is one fully-parallel device program instead of a
mutex-guarded work queue.

The topology (child indices, centres, depths) lives on host in numpy during
construction -- it is tiny and mutates irregularly -- while every fit,
error estimate and F evaluation runs batched on device.
"""

from __future__ import annotations

import collections
import functools
import math
import threading
import time
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from . import basis, consts, df64
from .config import Config, NearnessWeighting
from .tree import Octree, pack

# F signature: world points (K, 3) f64 -> (K,) f64, jax-traceable.
SDFFn = Callable[[jax.Array], jax.Array]


class CapturedSDF:
    """An SDF whose array state is threaded through jit as ARGUMENTS.

    A plain closure turns captured arrays into XLA constants, so every CSG
    rebuild (whose F reads the previous tree) would compile a fresh fit
    program per tree; shipping the arrays as operands makes the traced
    programs reusable across any same-shaped captures. ``key`` identifies
    the program structure (op name + capture shapes + inner-F identity) for
    the process-wide fused-program cache.

    CACHE CONTRACT: a non-None ``key`` asserts that ``fn`` is a pure
    function of ``(captures, pts)`` given the key -- EVERY array (and any
    other run-to-run-varying state) ``fn`` reads must be threaded through
    ``captures``, and every structural choice baked into the closure
    (shapes, degrees, inner-F identity for un-captured closures) must
    appear in the key. A key that under-describes its closure makes the
    program caches silently return a program traced for a DIFFERENT
    instance. When in doubt, leave ``key`` None: id()-keyed entries can
    only be hit by the exact same object (which the cache pins alive).
    """

    def __init__(self, fn, captures, key):
        self.fn = fn                 # (captures, pts) -> (K,)
        self.captures = captures     # pytree of arrays
        self.key = key               # hashable program identity

    def __call__(self, pts):
        return self.fn(self.captures, pts)


def _f_key(F):
    """Cache identity of an F: CapturedSDF / keyed DF64Fn instances by
    their structural key (their array state travels through jit as
    arguments, so same-structure instances share traced programs);
    everything else by object id."""
    key = getattr(F, "key", None)
    return key if key is not None else id(F)


def _f_captures(F):
    return getattr(F, "captures", jnp.zeros(0, jnp.float32))


# --------------------------------------------------------------------------
# Batched polynomial fitting (hot loop #1)
# --------------------------------------------------------------------------

def _fit_impl(nw: NearnessWeighting, nw_strength: float, degree: int,
              prev_width: int, Fv, depths, cn_sel, prev_coeffs):
    """Fit degree-``degree`` bases to a batch of cells.

    Fv     : (M, Q, Q, Q) F sampled at each cell's tensor-product
             Gauss-Legendre grid (produced host-side by _FitCache so the
             user SDF compiles once per build, not once per batch shape)
    depths : (M,)  int32
    cn_sel : (M, C) per-cell coeff_norms row, gathered HOST-side (depths
      are host values; keeping the table out of the traced program keeps
      the program free of device-resident constants -- see the numpy-
      constants note below)
    prev_coeffs: (M, prev_width) coeffs to retain verbatim (p-refinement
      reuse, Octree.cpp:1011-1012,1025), or (M, 0).

    Returns (coeffs (M, C), err (M,)) where err follows paper eq (6) with
    optional nearness weighting eqs (11)/(12).
    """
    half = jnp.exp2(-(depths.astype(Fv.dtype) + 1.0))             # (M,)

    # Separable projection: A[p, q] = w_q L_p(x_q); three contractions.
    # Constants stay NUMPY: a jnp constant closed over by the traced
    # program forces a device->host fetch during lowering, which deadlocks
    # when speculative background compiles lower concurrently.
    # HIGHEST: an f32 fit must not run its projection in TF32 on a GPU.
    A = np.asarray(basis.quadrature_matrix(degree), Fv.dtype)     # (P+1, Q)
    hi = jax.lax.Precision.HIGHEST
    T = jnp.einsum("mijk,pi->mpjk", Fv, A, precision=hi)
    T = jnp.einsum("mpjk,qj->mpqk", T, A, precision=hi)
    T = jnp.einsum("mpqk,rk->mpqr", T, A, precision=hi)

    idx = basis.basis_indices(degree)                             # (C, 3)
    raw = T[:, idx[:, 0], idx[:, 1], idx[:, 2]]                   # (M, C)
    vol = half ** 3                                               # aabbScalesMult
    coeffs = raw * cn_sel * vol[:, None]

    if prev_width:
        # p-refinement keeps previously fitted coefficients bit-exact
        # (the reference only computes the new ones, Octree.cpp:1043).
        coeffs = jnp.concatenate([prev_coeffs, coeffs[:, prev_width:]], axis=1)

    # eq (6): error = sum of squared top-total-degree coefficients.
    top = idx.sum(axis=1) == degree
    err = jnp.sum(jnp.where(top[None, :], coeffs**2, 0.0), axis=1)

    if nw != NearnessWeighting.NONE:
        # Exact cell mean of the approximation: only the constant basis
        # function has nonzero mean, so fbar = c_000 * 2**(1.5*depth).
        # Replaces the reference's 100-sample MC estimate
        # (Octree.cpp:1209-1247) with the closed form.
        fbar = jnp.abs(coeffs[:, 0]
                       * jnp.exp2(1.5 * depths.astype(coeffs.dtype)))
        d = math.sqrt(3.0)
        if nw == NearnessWeighting.POLYNOMIAL:
            k = jnp.clip((1.0 - fbar / d) ** nw_strength, 0.0, 1.0)
        else:
            k = jnp.exp(-nw_strength * fbar / d)
        err = err * k

    return coeffs, err


@functools.lru_cache(maxsize=None)
def _quad_matrix_df(degree: int):
    """quadrature_matrix(degree) exactly split into (hi, lo) f32 pairs."""
    return df64.from_f64(basis.quadrature_matrix(degree))


@functools.lru_cache(maxsize=None)
def _coeff_norms_df(degree: int):
    """coeff_norms(degree) exactly split into (hi, lo) f32 pairs."""
    return df64.from_f64(basis.coeff_norms(degree))


def _fit_impl_df64(nw: NearnessWeighting, nw_strength: float, degree: int,
                   prev_width: int, Fhi, Flo, depths, cnh_sel, cnl_sel,
                   prev_hi, prev_lo):
    """Compensated (double-float) variant of _fit_impl: the same separable
    Gauss-Legendre projection, accumulated at ~4e-15 relative precision in
    native f32 device ops (df64.py) instead of f64 (the reference fits in
    f64, Source/HP/Octree.cpp:1007-1093). On the H100 the native f64 fit is
    several times faster (PERF.md); this path remains for devices without
    fast f64.

    Fhi, Flo : (M, Q, Q, Q) df64 pair of F at the quadrature grids
    Returns (coeffs_hi (M, C), coeffs_lo (M, C), err (M,) f32). The error
    (eq 6) is a sum of non-negative squares -- no cancellation -- so f32
    relative precision (~1e-7) on it is ample for threshold decisions.
    """
    f32 = jnp.float32
    Ah, Al = _quad_matrix_df(degree)          # numpy pair (see _fit_impl)
    Th, Tl = Fhi, Flo
    for ax in (1, 2, 3):
        Th, Tl = df64.contract_axis(Th, Tl, ax, Ah, Al)

    idx = basis.basis_indices(degree)                            # (C, 3)
    raw = (Th[:, idx[:, 0], idx[:, 1], idx[:, 2]],
           Tl[:, idx[:, 0], idx[:, 1], idx[:, 2]])               # (M, C)
    c = df64.mul(raw, (cnh_sel, cnl_sel))
    half = jnp.exp2(-(depths.astype(f32) + 1.0))                 # exact pow2
    c = df64.mul_pow2(c, (half ** 3)[:, None])                   # aabbScalesMult

    if prev_width:
        # p-refinement keeps previously fitted coefficients bit-exact
        # (the reference only computes the new ones, Octree.cpp:1043).
        c = (jnp.concatenate([prev_hi, c[0][:, prev_width:]], axis=1),
             jnp.concatenate([prev_lo, c[1][:, prev_width:]], axis=1))

    top = idx.sum(axis=1) == degree
    err = jnp.sum(jnp.where(top[None, :], c[0] * c[0], f32(0.0)), axis=1)

    if nw != NearnessWeighting.NONE:
        # exact cell mean |c_000| * 2**(1.5*depth); see _fit_impl
        fbar = jnp.abs(c[0][:, 0] * jnp.exp2(1.5 * depths.astype(f32)))
        d = f32(math.sqrt(3.0))
        if nw == NearnessWeighting.POLYNOMIAL:
            k = jnp.clip((f32(1.0) - fbar / d) ** f32(nw_strength),
                         0.0, 1.0)
        else:
            k = jnp.exp(f32(-nw_strength) * fbar / d)
        err = err * k

    return c[0], c[1], err


class _LRU:
    """Bounded access-ordered cache for compiled programs.

    Entries pin their values -- the traced programs AND the F objects they
    were traced for -- which is what makes id()-based keys safe: an id can
    only be reused after its object dies, and the object cannot die while
    its entry lives (evicted entry => cache miss, never a stale hit).
    Bounding the cache releases old pins instead of growing without limit:
    each CSG rebuild's entry pins that tree's packed rows/grid on device
    for the process lifetime otherwise."""

    def __init__(self, cap: int = 128):
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self._cap = cap

    def get(self, key):
        v = self._d.get(key)
        if v is not None:
            self._d.move_to_end(key)
        return v

    def __setitem__(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self._cap:
            self._d.popitem(last=False)

    def clear(self):
        self._d.clear()


# Process-wide cache of compiled fused fit programs. A per-build cache
# would re-trace and re-compile every program on every build, dominating
# warm rebuild time. Keyed by _f_key(F) plus
# every config field the traced program closes over; see the CapturedSDF
# docstring for the purity contract non-None keys must satisfy.
_FUSED_CACHE = _LRU()

# Domain-normalization wrappers, memoized so repeated builds of the same F
# present the SAME F object to the fused-program cache above.
_WRAP_CACHE = _LRU()

# -- speculative background compilation (cold-start) ------------------------
# A cold fit program costs seconds of XLA compile. The win is (a) keeping
# the program count small (fixed block shapes below) and (b) OVERLAPPING
# upcoming compiles with the build's non-compile work (F evaluation,
# dispatches, host topology). _FitCache.speculate() AOT-compiles the
# predictable next shapes in daemon threads and STORES the compiled
# executable for reuse; _get() waits on an in-flight speculation instead of
# compiling twice. Whether this still pays once JAX's persistent compile
# cache holds the programs is ROADMAP design item 1.
_SPEC_LOCK = threading.Lock()
_SPEC_INFLIGHT: dict = {}                 # key -> threading.Event
_SPEC_SEM = threading.Semaphore(1)        # serialize speculative compiles
_COUNTS = {"programs": 0, "speculative": 0}


class _CompiledProgram:
    """An AOT-compiled fit executable with a lazy jit fallback.

    Speculative compiles lower at the exact dummy avals the build later
    passes; if an aval ever mismatches (dtype drift, sharding), the first
    failing call falls back to a fresh jit of the same traced function."""

    def __init__(self, compiled, make_jit):
        self._compiled = compiled
        self._make_jit = make_jit
        self._fallback = None

    def __call__(self, *args):
        if self._fallback is None:
            try:
                return self._compiled(*args)
            except Exception:
                self._fallback = self._make_jit()
        return self._fallback(*args)


def program_counts() -> dict:
    """Copy of the process-wide fit-program counters: ``programs`` = fused
    programs traced on demand, ``speculative`` = background pre-compiles."""
    with _SPEC_LOCK:
        return dict(_COUNTS)


def wait_for_speculation(timeout: float = 600.0) -> None:
    """Block until no speculative compiles are in flight. Benchmarks time
    host-side phases (mesh/BVH construction) against an otherwise idle
    host; a background compile thread still draining skews them."""
    import time as _time

    deadline = _time.monotonic() + timeout
    while _time.monotonic() < deadline:
        with _SPEC_LOCK:
            evs = list(_SPEC_INFLIGHT.values())
        if not evs:
            return
        evs[0].wait(timeout=max(0.0, deadline - _time.monotonic()))


class _FitCache:
    """Per-build view of the fused-fit program cache, keyed by
    (degree, prev_width, cell-block size).

    The user SDF ``F`` is deliberately evaluated OUTSIDE the projection
    program, host-chunked at a small set of fixed shapes: a fit batch can
    reach tens of millions of quadrature points and its shape changes every
    round, so tracing F into the fit kernel recompiles the (potentially
    expensive -- tree queries for CSG rebuilds, closest-triangle scans for
    mesh SDFs) F program at every new bucket size. Fixed-shape chunking
    compiles F a handful of times per build and makes the per-(degree,
    prev_width, bucket) projection programs trivial to compile.
    """

    def __init__(self, F_int, cfg: Config, mesh=None):
        self._F = F_int
        self._cfg = cfg
        self._comp = cfg.fit_dtype == "compensated"
        self._dt = (jnp.dtype(jnp.float32) if self._comp
                    else jnp.dtype(cfg.fit_dtype))
        # Frontier sharding (SURVEY.md 5.7): cells within a fit block are
        # data-parallel (each cell's quadrature grid, F evaluation and
        # projection are independent), so the block axis shards cleanly
        # over a device mesh; F's captures stay replicated.
        self._mesh = None
        self._ndev = 1
        if mesh is not None:
            devs = np.asarray(mesh.devices).reshape(-1)
            if devs.size > 1:
                from jax.sharding import Mesh
                self._mesh = Mesh(devs, ("fitcells",))
                self._ndev = devs.size
        # Quadrature points per fused dispatch, on every platform. Larger
        # blocks mean fewer dispatches but longer compiles per program.
        self.block_pts = 1 << 21

    def _key(self, degree: int, pw: int, cc: int):
        return (_f_key(self._F), self._cfg.fit_dtype,
                self._cfg.nearness_weighting,
                self._cfg.nearness_strength, degree, pw, cc,
                None if self._mesh is None
                else tuple(d.id for d in self._mesh.devices.flat))

    def _get(self, degree: int, pw: int, cc: int):
        key = self._key(degree, pw, cc)
        keyed = getattr(self._F, "key", None) is not None
        hit = _FUSED_CACHE.get(key)
        if hit is not None and (keyed or hit[0] is self._F):
            return hit[1]
        # a speculative pre-compile of this shape may be in flight: wait for
        # it and reuse its executable rather than compiling a second time
        ev = _SPEC_INFLIGHT.get(key)
        if ev is not None:
            ev.wait(timeout=600)
            hit = _FUSED_CACHE.get(key)
            if hit is not None and (keyed or hit[0] is self._F):
                return hit[1]
        fn = self._fused(degree, pw)
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(self._mesh, P())
            sh = NamedSharding(self._mesh, P("fitcells"))
            caps_sh = jax.tree.map(lambda _: rep, self._F.captures) \
                if isinstance(self._F, CapturedSDF) else rep
            n_in = 6 if self._comp else 4
            fn = jax.jit(fn.__wrapped__,
                         in_shardings=(caps_sh,) + (sh,) * n_in,
                         out_shardings=sh)
        _FUSED_CACHE[key] = (self._F, fn)
        with _SPEC_LOCK:
            _COUNTS["programs"] += 1
        return fn

    # -- block sizing -------------------------------------------------------
    # One canonical block per degree (the point-budget cap), plus a short
    # ladder of small blocks so late small-frontier rounds do not pay the
    # full block's padded F evaluations (mesh/CSG Fs are expensive per
    # point). A SMALL, PREDICTABLE shape set is what keeps cold builds
    # fast: every distinct (degree, prev_width, cc) is its own compile.
    # A sharded build gives every device the block a single device would
    # run (the block is ndev times larger), so each cell goes through the
    # same program at the same shape and the tree is bit-identical; a
    # frontier that fits a small block runs on the first device.
    _SMALL_BLOCKS = (64, 256, 1024)

    def _block_cc(self, degree: int) -> int:
        Q = basis.fit_rule_size(degree)
        return max(256, self.block_pts // Q ** 3) * self._ndev

    def _cc_for(self, M: int, degree: int) -> int:
        block = self._block_cc(degree)
        for b in self._SMALL_BLOCKS:
            if b * self._ndev < block and M <= b:
                return b * self._ndev
        return block

    # -- speculative pre-compilation ---------------------------------------
    def speculate(self, shapes) -> None:
        """Pre-compile fused programs for ``shapes`` = [(degree, pw, cc)]
        in background daemon threads (backend-cache side effect only; see
        the _SPEC_LOCK comment). No-op for sharded builds and for shapes
        already compiled or in flight."""
        if self._mesh is not None:
            return
        for degree, pw, cc in shapes:
            key = self._key(degree, pw, cc)
            with _SPEC_LOCK:
                if _FUSED_CACHE.get(key) is not None or key in _SPEC_INFLIGHT:
                    continue
                ev = threading.Event()
                _SPEC_INFLIGHT[key] = ev
                _COUNTS["speculative"] += 1
            threading.Thread(
                target=self._spec_compile, args=(degree, pw, cc, key, ev),
                daemon=True).start()

    def _spec_compile(self, degree, pw, cc, key, ev):
        try:
            with _SPEC_SEM:
                if _FUSED_CACHE.get(key) is not None:
                    return
                fn = self._fused(degree, pw)
                caps = _f_captures(self._F)
                C = consts.coeff_count(degree)
                if self._comp:
                    args = (jnp.zeros((cc, 3), jnp.float32),
                            jnp.zeros((cc,), jnp.int32),
                            jnp.zeros((cc, C), jnp.float32),
                            jnp.zeros((cc, C), jnp.float32),
                            jnp.zeros((cc, pw), jnp.float32),
                            jnp.zeros((cc, pw), jnp.float32))
                else:
                    args = (jnp.zeros((cc, 3), self._dt),
                            jnp.zeros((cc,), jnp.int32),
                            jnp.zeros((cc, C), self._dt),
                            jnp.zeros((cc, pw), self._dt))
                compiled = fn.lower(caps, *args).compile()
                # store for direct reuse: recompiling identical HLO pays
                # full price again (no reliable backend cache, see above)
                prog = _CompiledProgram(
                    compiled, lambda: self._fused(degree, pw))
                with _SPEC_LOCK:
                    if _FUSED_CACHE.get(key) is None:
                        _FUSED_CACHE[key] = (self._F, prog)
                        _COUNTS["programs"] += 1
        except Exception:
            pass                 # speculation must never break the build
        finally:
            ev.set()
            with _SPEC_LOCK:
                _SPEC_INFLIGHT.pop(key, None)

    def speculate_for_groups(self, degrees) -> None:
        """Pre-compile the canonical-block programs a refinement round over
        degree-``degrees`` groups will request: the p-candidate program
        (d+1, C(d)) and the h-candidate program (d, 0) per group degree d.

        Speculate ONLY shapes the next round is certain to request:
        speculative compiles run one at a time, so a wasted one (a degree
        the build never reaches -- high-degree programs compile longest)
        queues AHEAD of needed work and can multiply cold-start time
        instead of hiding it."""
        shapes = []
        for d in degrees:
            if d < self._cfg.max_degree - 1:     # p allowed (build.py rule)
                shapes.append((d + 1, consts.coeff_count(d),
                               self._block_cc(d + 1)))
            shapes.append((d, 0, self._block_cc(d)))
        self.speculate(shapes)

    def _fused(self, degree: int, pw: int):
        """Point-gen + F + projection as one program over a cell block."""
        if self._comp:
            return self._fused_df(degree, pw)
        Q = basis.fit_rule_size(degree)
        x, _ = basis.leggauss(Q)
        xj = np.asarray(x, self._dt)          # numpy: see _fit_impl note
        F = self._F
        dt = self._dt
        nw, nws = self._cfg.nearness_weighting, self._cfg.nearness_strength
        call_caps = (F.fn if isinstance(F, CapturedSDF)
                     else getattr(F, "call_caps", None))

        def fused(caps, c, d, cn, p):
            cc = c.shape[0]
            half = jnp.exp2(-(d.astype(c.dtype) + 1.0))
            gax = c[:, :, None] + half[:, None, None] * xj       # (cc, 3, Q)
            px = jnp.broadcast_to(gax[:, 0, :, None, None], (cc, Q, Q, Q))
            py = jnp.broadcast_to(gax[:, 1, None, :, None], (cc, Q, Q, Q))
            pz = jnp.broadcast_to(gax[:, 2, None, None, :], (cc, Q, Q, Q))
            pts = jnp.stack([px, py, pz], axis=-1).reshape(-1, 3)
            Fv = (call_caps(caps, pts) if call_caps is not None else F(pts))
            Fv = Fv.astype(dt).reshape(cc, Q, Q, Q)
            c_, e_ = _fit_impl(nw, nws, degree, pw, Fv, d, cn, p)
            # ONE packed output array -> one device->host fetch per block
            return jnp.concatenate([c_, e_[:, None]], axis=1)

        return jax.jit(fused)

    def _fused_df(self, degree: int, pw: int):
        """Compensated-mode fused program: df64 quadrature points, F in
        df64 when it supports it (df64.DF64Fn) else plain f32, projection
        via _fit_impl_df64. Runs in native f32 ops on any backend -- this is
        the compensated build path."""
        Q = basis.fit_rule_size(degree)
        x, _ = basis.leggauss(Q)
        xh, xl = df64.from_f64(x)             # numpy pair: see _fit_impl note
        F = self._F
        df_aware = isinstance(F, df64.DF64Fn)
        call_caps = (F.fn if isinstance(F, CapturedSDF)
                     else getattr(F, "call_caps", None))
        nw, nws = self._cfg.nearness_weighting, self._cfg.nearness_strength

        def fused(caps, c, d, cnh, cnl, ph, pl):
            # c: (cc, 3) f32 centres -- exact (multiples of 2**-(depth+2));
            # half is an exact power of two, so half*x stays an exact pair
            # and the centre add is a two_sum: the quadrature points carry
            # full f64-equivalent precision.
            cc = c.shape[0]
            half = jnp.exp2(-(d.astype(jnp.float32) + 1.0))      # (cc,)
            gh = half[:, None] * xh[None, :]                     # (cc, Q)
            gl = half[:, None] * xl[None, :]
            axes_h, axes_l = [], []
            for a in range(3):
                h, l = df64.add_f((gh, gl), c[:, a:a + 1])
                axes_h.append(h)
                axes_l.append(l)

            def grid3(ax):
                px = jnp.broadcast_to(ax[0][:, :, None, None], (cc, Q, Q, Q))
                py = jnp.broadcast_to(ax[1][:, None, :, None], (cc, Q, Q, Q))
                pz = jnp.broadcast_to(ax[2][:, None, None, :], (cc, Q, Q, Q))
                return jnp.stack([px, py, pz], axis=-1).reshape(-1, 3)

            pts_h = grid3(axes_h)
            if df_aware:
                vh, vl = F.eval_df_caps(caps, pts_h, grid3(axes_l))
                vh = vh.astype(jnp.float32)
                vl = vl.astype(jnp.float32)
            else:
                vh = (call_caps(caps, pts_h) if call_caps is not None
                      else F(pts_h)).astype(jnp.float32)
                vl = jnp.zeros_like(vh)
            Fh = vh.reshape(cc, Q, Q, Q)
            Fl = vl.reshape(cc, Q, Q, Q)
            ch, cl, err = _fit_impl_df64(nw, nws, degree, pw, Fh, Fl, d,
                                         cnh, cnl, ph, pl)
            # ONE packed output array -> one device->host fetch per block
            return jnp.concatenate([ch, cl, err[:, None]], axis=1)

        return jax.jit(fused)

    # when set to a list, every fit appends (degree, n_cells,
    # dispatch_seconds, collect_seconds) -- the bench's fit-phase
    # accounting hook (collect_seconds overlaps other fits' device work
    # under the pipelined round structure; see build()'s round loop)
    timing_log: list | None = None

    def dispatch(self, degree: int, centres: np.ndarray, depths: np.ndarray,
                 prev: np.ndarray | None = None) -> "_PendingFit":
        """Issue the device dispatches for one fit batch WITHOUT reading
        results back: the build's round loop dispatches the p- and
        h-candidate fits of ALL degree groups before collecting any of
        them, so per-fit host round trips overlap device work instead of
        serializing (the reference hides the same latency with its worker
        pool, Source/HP/Octree.cpp:194-309)."""
        t0 = time.perf_counter() if _FitCache.timing_log is not None else 0.0
        M = centres.shape[0]
        pw = 0 if prev is None else prev.shape[1]
        # Fixed cell-block sizes (_cc_for): large batches are split into
        # canonical-block dispatches, so each (degree, prev_width) compiles
        # its fused program at a SMALL, PREDICTABLE shape set no matter how
        # batch sizes evolve across refinement rounds (tracing F into an
        # unbounded-shape program recompiled the -- potentially expensive --
        # F at every new bucket size).
        cc = self._cc_for(M, degree)
        fn = self._get(degree, pw, cc)
        caps = _f_captures(self._F)
        outs = []                    # packed (cc, *) outputs, still on device
        for s in range(0, M, cc):
            c = centres[s: s + cc]
            d = depths[s: s + cc]
            p = (prev[s: s + cc] if pw
                 else np.zeros((c.shape[0], 0), np.float64))
            if c.shape[0] < cc:
                pad = cc - c.shape[0]
                c = np.concatenate([c, np.zeros((pad, 3), c.dtype)])
                d = np.concatenate([d, np.zeros(pad, d.dtype)])
                p = np.concatenate([p, np.zeros((pad, pw), p.dtype)])
            if self._comp:
                ph, pl = df64.from_f64(p)
                cnh, cnl = _coeff_norms_df(degree)
                outs.append(fn(caps, jnp.asarray(c, self._dt),
                               jnp.asarray(d),
                               jnp.asarray(cnh[d], jnp.float32),
                               jnp.asarray(cnl[d], jnp.float32),
                               jnp.asarray(ph), jnp.asarray(pl)))
            else:
                cn = basis.coeff_norms(degree)
                outs.append(fn(caps, jnp.asarray(c, self._dt),
                               jnp.asarray(d),
                               jnp.asarray(cn[d], self._dt),
                               jnp.asarray(p, self._dt)))
        # frontier sizes shrink late in a build: once this (degree, pw)'s
        # frontier is within reach of the next smaller block, pre-compile
        # that shape in the background. AFTER the dispatches above, so a
        # speculative compile never queues ahead of needed work on the
        # one-at-a-time speculative compile queue.
        lower = [b for b in self._SMALL_BLOCKS if b < cc]
        if lower and M <= 2 * lower[-1]:
            self.speculate([(degree, pw, lower[-1])])
        return _PendingFit(self, degree, M, outs, t0)

    def __call__(self, degree: int, centres: np.ndarray, depths: np.ndarray,
                 prev: np.ndarray | None = None):
        return self.dispatch(degree, centres, depths, prev).collect()


class _PendingFit:
    """In-flight fit batch: device dispatches issued, results not yet read.

    ``start_fetch`` begins the device->host copies without blocking
    (best-effort: backends without async host copies just no-op);
    ``collect`` blocks, unpacks the packed output columns and returns
    (coeffs (M, C) f64, err (M,) f64)."""

    def __init__(self, cache: _FitCache, degree: int, M: int, outs, t0):
        self._cache = cache
        self._degree = degree
        self._M = M
        self._outs = outs
        self._t0 = t0
        self._dispatch_s = (time.perf_counter() - t0) if t0 else 0.0
        self._fetching = False

    def start_fetch(self) -> None:
        if self._fetching:
            return
        self._fetching = True
        for o in self._outs:
            try:
                o.copy_to_host_async()
            except Exception:
                return                     # backend without async copies

    def collect(self):
        t0 = time.perf_counter() if _FitCache.timing_log is not None else 0.0
        self.start_fetch()
        C = consts.coeff_count(self._degree)
        arrs = [np.asarray(o) for o in self._outs]     # ONE fetch per block
        if self._cache._comp:
            out_c = [a[:, :C].astype(np.float64)
                     + a[:, C:2 * C].astype(np.float64) for a in arrs]
            out_e = [a[:, 2 * C].astype(np.float64) for a in arrs]
        else:
            out_c = [a[:, :C] for a in arrs]
            out_e = [a[:, C].astype(np.float64) for a in arrs]
        coeffs = np.concatenate(out_c)[: self._M]
        err = np.concatenate(out_e)[: self._M]
        if _FitCache.timing_log is not None:
            _FitCache.timing_log.append(
                (self._degree, self._M, self._dispatch_s,
                 time.perf_counter() - t0))
        return coeffs, err


# --------------------------------------------------------------------------
# Host-side topology + driver
# --------------------------------------------------------------------------

class _State:
    """Growable host SoA mirror of the tree during construction."""

    def __init__(self, cfg: Config, cap: int = 8192):
        # the coarse stage alone needs sum(8^d, d=0..COARSE_DEPTH) nodes
        min_cap = (8 ** (consts.COARSE_DEPTH + 1) - 1) // 7
        if cfg.node_capacity < min_cap:
            raise ValueError(
                f"node_capacity={cfg.node_capacity} below the coarse-stage "
                f"minimum of {min_cap}")
        cap = min(cap, cfg.node_capacity)
        self.cfg = cfg
        self.cw = consts.coeff_count(cfg.max_degree)
        self.child_idx = np.full(cap, consts.NO_CHILD, np.int32)
        self.centre = np.zeros((cap, 3), np.float64)
        self.depth = np.zeros(cap, np.int32)
        self.degree = np.full(cap, consts.NO_BASIS, np.int32)
        self.coeffs = np.zeros((cap, self.cw), np.float64)
        self.err = np.zeros(cap, np.float64)
        self.n = 0

    def _grow(self, need: int):
        cap = self.child_idx.shape[0]
        if self.n + need <= cap:
            return
        if self.n + need > self.cfg.node_capacity:
            raise RuntimeError(
                f"octree exceeded node_capacity={self.cfg.node_capacity}; "
                "raise Config.node_capacity or loosen target_error")
        new_cap = cap
        while new_cap < self.n + need:
            new_cap *= 2
        new_cap = min(new_cap, self.cfg.node_capacity)
        for name in ("child_idx", "centre", "depth", "degree", "coeffs",
                     "err"):
            old = getattr(self, name)
            new = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            new[:cap] = old
            if name == "child_idx":
                new[cap:] = consts.NO_CHILD
            if name == "degree":
                new[cap:] = consts.NO_BASIS
            setattr(self, name, new)

    def add_root(self):
        self._grow(1)
        self.centre[0] = 0.0
        self.depth[0] = 0
        self.n = 1

    def subdivide(self, parents: np.ndarray) -> np.ndarray:
        """Block-allocate 8 children per parent (reference: Octree.cpp:1115-1128).
        Returns (K, 8) child index array."""
        K = parents.shape[0]
        self._grow(8 * K)
        base = self.n + 8 * np.arange(K, dtype=np.int64)
        self.child_idx[parents] = base.astype(np.int32)
        kids = base[:, None] + np.arange(8)[None, :]
        # child centre offsets: +/- quarter cell per axis, Morton-style bits
        # (x = bit0, y = bit1, z = bit2) as in CornerAABB (Octree.cpp:1096-1112).
        pd = self.depth[parents]
        q = np.exp2(-(pd.astype(np.float64) + 2.0))               # quarter size
        octs = np.arange(8)
        sgn = np.stack([(octs & 1), (octs >> 1) & 1, (octs >> 2) & 1],
                       axis=-1) * 2.0 - 1.0                       # (8, 3)
        self.centre[kids.reshape(-1)] = (
            self.centre[parents][:, None, :] + q[:, None, None] * sgn[None]
        ).reshape(-1, 3)
        self.depth[kids.reshape(-1)] = np.repeat(pd + 1, 8)
        self.degree[kids.reshape(-1)] = consts.NO_BASIS
        self.n += 8 * K
        return kids


def build(config: Config, F: SDFFn, *,
          continuity_fn=None, progress: Callable[[str], None] | None = None,
          fit_mesh=None) -> Octree:
    """Approximate ``F`` with an hp-adaptive Legendre octree.

    Equivalent of Octree::Create (Source/HP/Octree.cpp:312-352). ``F`` maps
    world points (K, 3) -> (K,) and must be jax-traceable (it is evaluated
    on-device at every quadrature node of every fit, batched).

    ``fit_mesh``: optional jax.sharding.Mesh -- every refinement round's
    F-evaluation + projection shards its cell blocks over all devices of
    the mesh (the device equivalent of the reference's BuildThreadPool
    work distribution, SURVEY.md 5.7; topology stays host-side). Cells are
    data-parallel and each device runs the single-device block shape, so
    the tree is bit-identical to the single-device build.
    """
    config.validate()
    t0 = time.monotonic()

    # Domain normalization: internal tree spans the unit cube
    # (reference: Octree.cpp:321-328). The transform constants follow the
    # fit dtype so an f32 fit does not silently promote back to f64; a
    # df64-aware F under the compensated fit gets a df64 affine wrap so no
    # precision is lost before the field evaluation. The wrapper is memoized
    # on (F, fit_dtype, root): a fresh wrapper object per build would miss
    # the process-wide fused-program cache and re-trace every fit program
    # on every build.
    comp = config.fit_dtype == "compensated"
    wkey = (_f_key(F), config.fit_dtype, tuple(config.root_min),
            tuple(config.root_max))
    if comp and isinstance(F, df64.DF64Fn):
        # cheap to construct; keyed instances share fused programs anyway
        if F.key is not None:
            F_int = df64.AffineWrap(F, config.root_sizes, config.root_centre)
        else:
            hit = _WRAP_CACHE.get(wkey)
            if hit is not None and hit[0] is F:
                F_int = hit[1]
            else:
                F_int = df64.AffineWrap(F, config.root_sizes,
                                        config.root_centre)
                _WRAP_CACHE[wkey] = (F, F_int)
    elif isinstance(F, CapturedSDF):
        hit = _WRAP_CACHE.get(wkey)
        if hit is not None:
            # reuse the traced wrapper with THIS tree's arrays
            F_int = CapturedSDF(hit[1].fn, F.captures, hit[1].key)
        else:
            tdt = jnp.float32 if comp else jnp.dtype(config.fit_dtype)
            root_centre = jnp.asarray(config.root_centre, tdt)
            root_sizes = jnp.asarray(config.root_sizes, tdt)
            inner = F.fn
            F_int = CapturedSDF(
                lambda caps, pts: inner(caps, pts * root_sizes + root_centre),
                F.captures, ("affine", wkey))
            _WRAP_CACHE[wkey] = (F, F_int)
    else:
        hit = _WRAP_CACHE.get(wkey)
        if hit is not None and hit[0] is F:
            F_int = hit[1]
        else:
            tdt = jnp.float32 if comp else jnp.dtype(config.fit_dtype)
            root_centre = jnp.asarray(config.root_centre, tdt)
            root_sizes = jnp.asarray(config.root_sizes, tdt)

            def F_int(pts):
                return F(pts * root_sizes + root_centre)

            _WRAP_CACHE[wkey] = (F, F_int)

    st = _State(config)
    fit = _FitCache(F_int, config, mesh=fit_mesh)
    # cold-start pipelining: the coarse stage always requests (2, 0) and
    # round 1 -- if it happens -- requests the degree-2 group's programs;
    # compile them in the background while earlier work runs (see
    # speculate_for_groups for why speculation stays exact-need)
    fit.speculate([(consts.COARSE_DEGREE, 0,
                    fit._block_cc(consts.COARSE_DEGREE))])
    fit.speculate_for_groups([consts.COARSE_DEGREE])

    def log(msg):
        if config.enable_logging:
            print(f"[hpsdf build +{time.monotonic() - t0:7.2f}s] {msg}")
        if progress is not None:
            progress(msg)

    # -- root + uniform coarse refinement (Octree.cpp:112-191, 792-801) ----
    st.add_root()
    frontier = np.array([0], dtype=np.int64)
    for _ in range(consts.COARSE_DEPTH):
        kids = st.subdivide(frontier)
        frontier = kids.reshape(-1)

    # -- round 0: degree-2 fit on every coarse leaf (Octree.cpp:836-843) ---
    coeffs, errs = fit(consts.COARSE_DEGREE, st.centre[frontier],
                       st.depth[frontier])
    cc = consts.coeff_count(consts.COARSE_DEGREE)
    st.coeffs[frontier, :cc] = coeffs
    st.degree[frontier] = consts.COARSE_DEGREE
    st.err[frontier] = errs
    total_err = float(errs.sum())
    log(f"coarse fit: {frontier.size} leaves, total_err={total_err:.3e}")

    # Leaves that can never be refined further drop out of consideration
    # (mirrors the reference's silent queue drop at Octree.cpp:643-655).
    max_deg, max_dep = config.max_degree, config.max_depth

    rounds = 0
    while total_err > config.target_error:
        leaves = np.flatnonzero((st.child_idx[: st.n] < 0)
                                & (st.degree[: st.n] >= 0)).astype(np.int64)
        p_ok = st.degree[leaves] < max_deg - 1
        h_ok = st.depth[leaves] < max_dep
        cand = leaves[p_ok | h_ok]
        if cand.size == 0:
            log(f"stopping: no refinable leaves (total_err={total_err:.3e})")
            break
        # Batched analogue of the reference's greedy max-error-first queue
        # (Octree.cpp:216-240): take the smallest error-descending prefix
        # whose removal could bring the total below target -- a lower bound
        # on the nodes the greedy loop would pop before its stop check.
        errs_c = st.err[cand]
        order = np.argsort(-errs_c)
        csum = np.cumsum(errs_c[order])
        need = total_err - 0.5 * config.target_error
        k = int(np.searchsorted(csum, need)) + 1
        k = min(k, cand.size)
        sel = cand[order[:k]]
        if sel.size == 0:
            break

        # Group the round's jobs by basis degree for static-shape batching.
        # PIPELINED DISPATCH: the p- and h-candidate fits of every degree
        # group are independent of each other, so ALL of them are
        # dispatched to the device before any result is read back --
        # per-dispatch host round trips overlap instead of accumulating.
        # The reference hides the same latency with its producer-consumer
        # worker pool (Octree.cpp:194-309).
        next_degs: set = set()
        jobs = []
        for d in np.unique(st.degree[sel]):
            grp = sel[st.degree[sel] == d]
            d = int(d)
            gp_ok = d < max_deg - 1
            gh_ok_mask = st.depth[grp] < max_dep

            # --- p-candidates: incremental fit at degree d+1 --------------
            pend_p = None
            if gp_ok:
                pw = consts.coeff_count(d)
                pend_p = fit.dispatch(d + 1, st.centre[grp], st.depth[grp],
                                      prev=st.coeffs[grp, :pw])

            # --- h-candidates: 8 same-degree fits over the children -------
            pend_h = None
            if gh_ok_mask.any():
                hg = grp[gh_ok_mask]
                q = np.exp2(-(st.depth[hg].astype(np.float64) + 2.0))
                octs = np.arange(8)
                sgn = np.stack([(octs & 1), (octs >> 1) & 1,
                                (octs >> 2) & 1], axis=-1) * 2.0 - 1.0
                ch_cen = (st.centre[hg][:, None, :]
                          + q[:, None, None] * sgn[None]).reshape(-1, 3)
                ch_dep = np.repeat(st.depth[hg] + 1, 8)
                pend_h = fit.dispatch(d, ch_cen, ch_dep)
            jobs.append((d, grp, gp_ok, gh_ok_mask, pend_p, pend_h))

        for _, _, _, _, pend_p, pend_h in jobs:      # overlap host copies
            for pend in (pend_p, pend_h):
                if pend is not None:
                    pend.start_fetch()

        for d, grp, gp_ok, gh_ok_mask, pend_p, pend_h in jobs:
            p_err = np.full(grp.size, np.inf)
            p_coeffs = None
            if pend_p is not None:
                p_coeffs, p_err = pend_p.collect()
            h_err8 = None
            h_coeffs = None
            if pend_h is not None:
                h_coeffs, h_err_flat = pend_h.collect()
                h_err8 = h_err_flat.reshape(-1, 8)

            # --- decide h vs p (Octree.cpp:594-601, eqs (8)/(9)) ----------
            old_err = st.err[grp]
            cd, cd1 = consts.coeff_count(d), consts.coeff_count(d + 1)
            p_imp = np.full(grp.size, -np.inf)
            if gp_ok:
                p_imp = (old_err - 8.0 * p_err) / (cd1 - cd)
            h_imp = np.full(grp.size, -np.inf)
            if h_err8 is not None:
                max_child = h_err8.max(axis=1)
                h_imp[gh_ok_mask] = ((old_err[gh_ok_mask] - 8.0 * max_child)
                                     / (7.0 * cd))
            refine_p = gp_ok & (~gh_ok_mask | (p_imp > h_imp))
            refine_h = gh_ok_mask & ~refine_p

            # --- apply P (Octree.cpp:253-260) -----------------------------
            pg = grp[refine_p]
            if pg.size:
                next_degs.add(d + 1)    # next round may refine these anew
                pc = p_coeffs[refine_p]
                st.coeffs[pg, : pc.shape[1]] = pc
                st.degree[pg] = d + 1
                total_err += float(p_err[refine_p].sum()
                                   - old_err[refine_p].sum())
                st.err[pg] = p_err[refine_p]

            # --- apply H (Octree.cpp:262-279) -----------------------------
            hsel = grp[refine_h]
            if hsel.size:
                kids = st.subdivide(hsel)
                st.degree[hsel] = consts.NO_BASIS
                # scatter the candidate fits into the new children
                hpos = np.flatnonzero(refine_h[gh_ok_mask])  # rows in h arrays
                rows = (hpos[:, None] * 8 + np.arange(8)[None]).reshape(-1)
                kc = h_coeffs[rows]
                flat_kids = kids.reshape(-1)
                st.coeffs[flat_kids, : kc.shape[1]] = kc
                st.degree[flat_kids] = d
                kerr = h_err8[hpos]
                st.err[flat_kids] = kerr.reshape(-1)
                total_err += float(kerr.sum() - old_err[refine_h].sum())

        rounds += 1
        if total_err > config.target_error and next_degs:
            # p-refined nodes carry NEW degrees next round; pipeline their
            # programs behind this round (exact-need, see speculate_for_groups)
            fit.speculate_for_groups(sorted(next_degs))
        log(f"round {rounds}: {sel.size} refined, nodes={st.n}, "
            f"total_err={total_err:.3e}")

    tree = pack(st.child_idx, st.centre, st.depth, st.degree, st.coeffs,
                st.n, config)
    log(f"packed: {st.n} nodes, {tree.num_leaves()} leaves, "
        f"deg_used={tree.deg_used}, depth_used={tree.depth_used}")

    if config.continuity and continuity_fn is not None:
        tree = continuity_fn(tree)
        log("continuity post-process done")

    return tree
