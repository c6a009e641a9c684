"""Double-float (df64) arithmetic: ~49-bit-mantissa reals as f32 (hi, lo) pairs.

Why this exists: the reference fits its Legendre coefficients in f64
(Source/HP/Octree.cpp:1007-1093). This module provides the
error-free-transformation toolkit (Dekker/Knuth two_sum / two_prod and the
QD-style add/mul/sqrt built on them) that lets the quadrature projection
accumulate at ~4e-15 relative precision in native f32 device ops
(Config.fit_dtype = "compensated"; see build.py), for devices without fast
f64. On the H100 the native f64 fit is faster (PERF.md).

Correctness precondition: f32 add/sub must be IEEE correctly rounded, which
XLA honors on the GPU and CPU backends. Multiplications get NO
such trust: XLA:CPU's LLVM backend FMA-contracts ``multiply -> add/sub``
chains inside loop fusions (measured: Dekker's classic two_prod loses its
compensation term exactly when the producing multiply is rematerialized into
a consumer fusion). Every algorithm below is therefore built so that any
multiply feeding an add/sub is EXACT in f32 (a product of <=12-bit-mantissa
halves from a bitmask Veltkamp split) -- an FMA merely recomputes the same
exact value, so contraction cannot change results. two_sum is bit-exact;
two_prod is exact to ~2^-45 relative (its error accumulation rounds twice);
both verified against f64 on random pairs in tests/test_df64.py (CPU) and
tests/test_gpu.py (the card, where the compiler may contract into FMAs).

All functions are elementwise over jnp f32 arrays; a df64 value is a plain
``(hi, lo)`` tuple with ``hi + lo`` the represented real and
``|lo| <= ulp(hi)/2``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# keep the top 12 explicit mantissa bits (plus sign/exponent): halves then
# carry <= 12 significant bits, so products of halves are exact in f32
_MASK = np.int32(np.uint32(0xFFFFF000).view(np.int32))


# --------------------------------------------------------------------------
# Error-free transformations (exact: the pair sums to the true f64 result)
# --------------------------------------------------------------------------

def two_sum(a, b):
    """s + err == a + b exactly (Knuth; add/sub only -- FMA-proof)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """s + err == a + b exactly, REQUIRES |a| >= |b| (Dekker; FMA-proof)."""
    s = a + b
    return s, b - (s - a)


def split(a):
    """a == hi + lo, each half with <= 12 significant mantissa bits.

    Bitmask variant of Veltkamp splitting: integer ops only, so no float
    multiply exists for LLVM to contract (the classic ``a*4097`` split is
    exactly what XLA:CPU's FMA contraction corrupts). ``a - hi`` is exact
    (hi agrees with a in its leading bits)."""
    bits = jax.lax.bitcast_convert_type(a, jnp.int32)
    hi = jax.lax.bitcast_convert_type(bits & _MASK, jnp.float32)
    return hi, a - hi


def two_prod(a, b):
    """p + err == a * b exactly.

    All four partial products of the split halves are exact in f32 (12-bit
    x 12-bit significands), so the accumulation below is a pure two_sum
    chain over exact values: correct under any FMA contraction, unlike
    Dekker's ``a*b`` / ``ah*bh - p`` formulation."""
    ah, al = split(a)
    bh, bl = split(b)
    hh = ah * bh
    hl = ah * bl
    lh = al * bh
    ll = al * bl
    s, e1 = two_sum(hl, lh)
    p, e2 = two_sum(hh, s)
    return quick_two_sum(p, (e1 + e2) + ll)


# --------------------------------------------------------------------------
# df64 arithmetic (QD-library algorithms on (hi, lo) tuples)
# --------------------------------------------------------------------------

def add(x, y):
    """df64 + df64."""
    s1, s2 = two_sum(x[0], y[0])
    t1, t2 = two_sum(x[1], y[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def add_f(x, f):
    """df64 + f32."""
    s1, s2 = two_sum(x[0], f)
    s2 = s2 + x[1]
    return quick_two_sum(s1, s2)


def neg(x):
    return (-x[0], -x[1])


def sub(x, y):
    return add(x, neg(y))


def mul(x, y):
    """df64 * df64."""
    p1, p2 = two_prod(x[0], y[0])
    p2 = p2 + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p1, p2)


def mul_f(x, f):
    """df64 * f32."""
    p1, p2 = two_prod(x[0], f)
    p2 = p2 + x[1] * f
    return quick_two_sum(p1, p2)


def mul_pow2(x, f):
    """df64 * f where f is an exact power of two (exact, no rounding)."""
    return (x[0] * f, x[1] * f)


def sqrt(x):
    """df64 sqrt (one Newton correction on the f32 root; ~full df64
    accuracy for positive inputs; returns 0 for hi <= 0)."""
    hi = x[0]
    safe = jnp.maximum(hi, jnp.float32(1e-38))
    r = jnp.sqrt(safe)
    # e = x - r*r  (df64); correction = e / (2r)
    rr = two_prod(r, r)
    e = add(x, neg(rr))
    corr = e[0] / (jnp.float32(2.0) * r)
    out = quick_two_sum(r, corr)
    bad = hi <= 0
    return (jnp.where(bad, jnp.float32(0.0), out[0]),
            jnp.where(bad, jnp.float32(0.0), out[1]))


# --------------------------------------------------------------------------
# Conversions
# --------------------------------------------------------------------------

def from_f64(x):
    """Split f64 (numpy or jnp, any shape) into an exact (hi, lo) f32 pair."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def to_f64(x):
    """Recombine a (hi, lo) pair into f64 (numpy in, numpy out)."""
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


def zeros(shape):
    z = jnp.zeros(shape, jnp.float32)
    return z, z


def const(v):
    """Lift a Python/np scalar into a df64 scalar pair (f32 jnp scalars)."""
    hi, lo = from_f64(v)
    return jnp.float32(hi), jnp.float32(lo)


# --------------------------------------------------------------------------
# Contractions (the fit's workhorse)
# --------------------------------------------------------------------------

def contract_last(xhi, xlo, ahi, alo, unroll: int = 4):
    """df64 tensor contraction  out[..., p] = sum_q X[..., q] * A[p, q].

    X: (..., Q) df64, A: (P1, Q) df64 -> (..., P1) df64. Accumulates in df64
    via a lax.scan over Q -- each step is one large elementwise op, so
    the sequential dimension costs Q dispatch-free loop iterations.
    """
    Q = xhi.shape[-1]
    xs = (jnp.moveaxis(xhi, -1, 0), jnp.moveaxis(xlo, -1, 0),   # (Q, ...)
          ahi.T, alo.T)                                         # (Q, P1)
    out_shape = xhi.shape[:-1] + (ahi.shape[0],)

    def step(carry, qs):
        xh, xl, ah, al = qs
        term = mul((xh[..., None], xl[..., None]), (ah, al))
        return add(carry, term), None

    acc, _ = jax.lax.scan(step, zeros(out_shape), xs, unroll=unroll)
    return acc


def contract_axis(xhi, xlo, axis: int, ahi, alo):
    """df64 contraction of X's ``axis`` against A (P1, Q); the contracted
    axis is replaced by P1 in place."""
    xhi = jnp.moveaxis(xhi, axis, -1)
    xlo = jnp.moveaxis(xlo, axis, -1)
    ohi, olo = contract_last(xhi, xlo, ahi, alo)
    return jnp.moveaxis(ohi, -1, axis), jnp.moveaxis(olo, -1, axis)


# --------------------------------------------------------------------------
# df64-aware SDFs
# --------------------------------------------------------------------------

class DF64Fn:
    """Base class for SDFs that can evaluate in double-f32.

    Subclasses implement ``eval_df_caps(caps, hi, lo) -> (vhi, vlo)`` over
    (K, 3) point pairs, where ``caps`` is the instance's ``captures``
    pytree of parameter arrays. Parameters travel through jit as ARGUMENTS
    (never closure constants), so the fit programs traced for one instance
    are reused verbatim by any other instance of the same structure
    (``key``) -- e.g. every Sphere shares one compiled program set.
    ``__call__`` provides the plain-array path (any float dtype) so a
    DF64Fn is also a regular ``build_octree`` F. The compensated fit
    (build.py) detects this class and feeds it full-precision quadrature
    points, which is what lets a compensated build converge at reference-default
    target errors (1e-10) -- with a plain f32 F the field itself carries
    ~1e-7 relative noise and no projection precision can recover it.
    """

    # structural identity; None -> object-id caching. A non-None key
    # PROMISES eval_df_caps is a pure function of (caps, pts): every
    # parameter must live in ``captures``, none in instance attributes the
    # evaluation reads directly -- same contract as build.CapturedSDF.key.
    captures: tuple = ()
    key = None

    def eval_df_caps(self, caps, hi, lo):
        raise NotImplementedError

    def eval_df(self, hi, lo):
        return self.eval_df_caps(self.captures, hi, lo)

    def call_caps(self, caps, pts):
        """Plain-array entry with explicit captures (any float dtype)."""
        dt = pts.dtype
        if dt == jnp.float64:
            phi = pts.astype(jnp.float32)
            plo = (pts - phi.astype(jnp.float64)).astype(jnp.float32)
            vhi, vlo = self.eval_df_caps(caps, phi, plo)
            return vhi.astype(jnp.float64) + vlo.astype(jnp.float64)
        vhi, _ = self.eval_df_caps(caps, pts.astype(jnp.float32),
                                   jnp.zeros(pts.shape, jnp.float32))
        return vhi.astype(dt)

    def __call__(self, pts):
        return self.call_caps(self.captures, pts)


class Sphere(DF64Fn):
    """df64 sphere SDF: |p - centre| - radius (the reference benchmark's
    analytic F, Source/Tests/HPBenchmarks.cpp:25-48)."""

    key = ("df64.Sphere",)

    def __init__(self, radius: float, centre=(0.0, 0.0, 0.0)):
        self.radius = float(radius)
        self.centre = tuple(float(c) for c in centre)
        r = from_f64(radius)
        c = from_f64(np.asarray(self.centre, np.float64))
        self.captures = (jnp.float32(r[0]), jnp.float32(r[1]),
                         jnp.asarray(c[0]), jnp.asarray(c[1]))

    def eval_df_caps(self, caps, hi, lo):
        r_hi, r_lo, c_hi, c_lo = caps
        acc = zeros(hi.shape[:-1])
        for a in range(3):
            d = add_f((hi[..., a], lo[..., a]), -c_hi[a])
            d = add_f(d, -c_lo[a])
            acc = add(acc, mul(d, d))
        n = sqrt(acc)
        return add((n[0], n[1]), (-r_hi, -r_lo))


class Box(DF64Fn):
    """df64 axis-aligned box SDF (exterior-exact, interior max-norm)."""

    key = ("df64.Box",)

    def __init__(self, half_extents=(0.25, 0.25, 0.25),
                 centre=(0.0, 0.0, 0.0)):
        self.half = tuple(float(h) for h in half_extents)
        self.centre = tuple(float(c) for c in centre)
        h = from_f64(np.asarray(self.half, np.float64))
        c = from_f64(np.asarray(self.centre, np.float64))
        self.captures = (jnp.asarray(h[0]), jnp.asarray(h[1]),
                         jnp.asarray(c[0]), jnp.asarray(c[1]))

    def eval_df_caps(self, caps, hi, lo):
        b_hi, b_lo, c_hi, c_lo = caps
        qh, ql, inside = [], [], None
        for a in range(3):
            d = add_f((hi[..., a], lo[..., a]), -c_hi[a])
            d = add_f(d, -c_lo[a])
            mag = (jnp.abs(d[0]), jnp.sign(d[0]) * d[1])
            q = add(mag, (-b_hi[a], -b_lo[a]))
            qh.append(q[0])
            ql.append(q[1])
            m = (q[0], q[1])
            inside = m if inside is None else (
                jnp.where(m[0] > inside[0], m[0], inside[0]),
                jnp.where(m[0] > inside[0], m[1], inside[1]))
        acc = zeros(hi.shape[:-1])
        for a in range(3):
            pos = qh[a] > 0
            h = jnp.where(pos, qh[a], jnp.float32(0.0))
            l = jnp.where(pos, ql[a], jnp.float32(0.0))
            acc = add(acc, mul((h, l), (h, l)))
        outer = sqrt(acc)
        neg_in = (jnp.minimum(inside[0], jnp.float32(0.0)),
                  jnp.where(inside[0] < 0, inside[1], jnp.float32(0.0)))
        return add(outer, neg_in)


class AffineWrap(DF64Fn):
    """F'(p) = inner(p * scale + shift) in df64 -- the domain normalization
    of Octree::Create (Source/HP/Octree.cpp:321-328) at full precision."""

    def __init__(self, inner: DF64Fn, scale, shift):
        self.inner = inner
        s = from_f64(np.asarray(scale, np.float64))
        t = from_f64(np.asarray(shift, np.float64))
        self.captures = (inner.captures, jnp.asarray(s[0]),
                         jnp.asarray(s[1]), jnp.asarray(t[0]),
                         jnp.asarray(t[1]))
        self.key = (None if inner.key is None
                    else ("df64.AffineWrap", inner.key))

    def eval_df_caps(self, caps, hi, lo):
        inner_caps, s_hi, s_lo, t_hi, t_lo = caps
        outs = []
        for a in range(3):
            p = (hi[..., a], lo[..., a])
            p = mul(p, (s_hi[a], s_lo[a]))
            p = add(p, (t_hi[a], t_lo[a]))
            outs.append(p)
        phi = jnp.stack([o[0] for o in outs], axis=-1)
        plo = jnp.stack([o[1] for o in outs], axis=-1)
        return self.inner.eval_df_caps(inner_caps, phi, plo)
