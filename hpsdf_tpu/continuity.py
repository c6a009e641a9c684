"""Global continuity post-process.

Solves (M + sI) c = s c0, where M is the Gram matrix of inter-cell value
jumps across shared leaf faces -- the reference's PerformContinuityPostProcess
(Source/HP/Octree.cpp:1663-1762), redesigned for batched device work:

  reference                               this module
  -----------------------------------    ----------------------------------
  recursive NodeProc/FaceProc + procMap   iterative worklist expansion over
  (Octree.cpp:1549-1612)                  index arrays; pairs reached once
  per-thread Eigen triplet buffers        vectorized COO assembly in numpy
  scalar 2-D GL quadrature per entry      separable 1-D quadrature: each
  (Octree.cpp:1250-1456)                  cross-depth block factorizes into
                                          (normal) x (tan1) x (tan2) products
  Eigen CG + IncompleteCholesky           Jacobi-preconditioned CG on device,
  (Octree.cpp:1749-1755)                  matvec = gather * vals -> segment-sum
                                          in f64, or in f32 with f64 iterative
                                          refinement (same f64 stopping rule)

Analytic same-depth entries use L_p(1) = 1, L_p(-1) = (-1)^p, so the three
block families reduce to sign patterns times normalizer products under a
Kronecker-delta tangential mask (Octree.cpp:1459-1546, "Appendix A"). The
cross-depth entries use the separability of the reference's 2-D face
quadrature into per-tangential-axis 1-D integrals.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import basis, consts
from .tree import Octree


# --------------------------------------------------------------------------
# Face-pair enumeration
# --------------------------------------------------------------------------

def leaf_face_pairs(child_idx: np.ndarray, n_nodes: int):
    """All (leaf_a, leaf_b, dim) sharing a positive-area face, with a on the
    minus side of axis ``dim``. Iterative, batched equivalent of
    NodeProc/FaceProc (Octree.cpp:1549-1612)."""
    ci = child_idx[:n_nodes]
    internal = np.flatnonzero(ci >= 0)

    seeds_a, seeds_b, seeds_d = [], [], []
    for d in range(3):
        bit = 1 << d
        # the 4 sibling pairs sharing an internal face per axis
        # (reference table SharedFaceLookup, Include/HP/Utility.h:166-196)
        for o in (o for o in range(8) if not (o & bit)):
            seeds_a.append(ci[internal] + o)
            seeds_b.append(ci[internal] + o + bit)
            seeds_d.append(np.full(internal.size, d, np.int32))
    if not seeds_a:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.int32),)
    a = np.concatenate(seeds_a).astype(np.int64)
    b = np.concatenate(seeds_b).astype(np.int64)
    dd = np.concatenate(seeds_d)

    out = []
    while a.size:
        leaf_pair = (child_idx[a] < 0) & (child_idx[b] < 0)
        if leaf_pair.any():
            out.append((a[leaf_pair], b[leaf_pair], dd[leaf_pair]))
        live = ~leaf_pair
        a, b, dd = a[live], b[live], dd[live]
        if not a.size:
            break
        # expand each live pair into the 4 child sub-pairs facing the
        # shared plane (FaceProc recursion, Octree.cpp:1582-1588)
        na, nb, nd = [], [], []
        for d in range(3):
            m = dd == d
            if not m.any():
                continue
            bit = 1 << d
            aa, bb = a[m], b[m]
            a_has = child_idx[aa] >= 0
            b_has = child_idx[bb] >= 0
            for o in (o for o in range(8) if not (o & bit)):
                na.append(np.where(a_has, child_idx[aa] + o + bit, aa))
                nb.append(np.where(b_has, child_idx[bb] + o, bb))
                nd.append(np.full(aa.size, d, np.int32))
        a = np.concatenate(na).astype(np.int64)
        b = np.concatenate(nb).astype(np.int64)
        dd = np.concatenate(nd)

    if not out:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.int32),)
    A = np.concatenate([o[0] for o in out])
    B = np.concatenate([o[1] for o in out])
    D = np.concatenate([o[2] for o in out])
    # each pair is reached exactly once (unique lowest-common-ancestor seed),
    # but dedup defensively as the reference's procMap does (:1597-1604)
    _, keep = np.unique(A * (3 * n_nodes) + B * 3 + D, return_index=True)
    return A[keep], B[keep], D[keep]


# --------------------------------------------------------------------------
# COO assembly
# --------------------------------------------------------------------------

def _cc_vec(deg):
    d = np.maximum(deg, 0).astype(np.int64)
    return (d + 1) * (d + 2) * (d + 3) // 6


class _LeafView:
    """Host view of a packed tree with per-leaf flat coefficient offsets
    (the reference's post-ReallocCoeffs coeffsStart, Octree.cpp:535-544)."""

    def __init__(self, tree: Octree):
        self.child_idx = np.asarray(tree.child_idx)
        self.centre = np.asarray(tree.centre)
        self.depth = np.asarray(tree.depth)
        self.degree = np.asarray(tree.degree)
        self.n = tree.n_nodes
        widths = np.where(self.degree >= 0, _cc_vec(self.degree), 0)
        widths[self.n:] = 0
        starts = np.zeros(len(widths) + 1, np.int64)
        np.cumsum(widths, out=starts[1:])
        self.coeff_start = starts[:-1]
        self.widths = widths
        self.n_coeffs = int(starts[-1])


@functools.lru_cache(maxsize=None)
def _tangential_match(deg_a: int, deg_b: int, dim: int):
    """(i, j) index pairs whose tangential exponents match -- the nonzero
    pattern of the analytic same-depth blocks (Octree.cpp:1478-1484)."""
    ia = basis.basis_indices(deg_a)
    ib = basis.basis_indices(deg_b)
    t1, t2 = (dim + 1) % 3, (dim + 2) % 3
    eq = ((ia[:, None, t1] == ib[None, :, t1])
          & (ia[:, None, t2] == ib[None, :, t2]))
    i, j = np.nonzero(eq)
    return i.astype(np.int64), j.astype(np.int64)


def _groups(st, a, b, d):
    """Iterate (deg_a, deg_b, dim) -> boolean mask over the pair list."""
    key = (st.degree[a] * 1000 + st.degree[b]) * 10 + d
    for k in np.unique(key):
        m = key == k
        da = int(st.degree[a[m]][0])
        db = int(st.degree[b[m]][0])
        yield da, db, int(d[m][0]), m


# Peak dense elements materialized per emitted block during assembly. At
# degree 12 one cross-depth block is 455^2 = 207k elements, so this budget
# (~64 MB of f64 per intermediate) caps chunks at ~40 pairs -- assembly
# memory stays bounded no matter how many face pairs the tree has
# (materializing ALL pairs at once runs out of memory past deg_used ~ 6).
_BLOCK_ELEMS = 1 << 23


def _prune_append(rows, cols, vals, r, c, v):
    """Append COO entries with the reference's EPSILON_F32 pruning applied
    immediately (Octree.cpp:1336-1340), keeping host memory proportional to
    surviving entries rather than dense blocks. ``r``/``c`` may be any
    shape broadcastable to ``v`` (broadcast happens against v's original
    shape, BEFORE raveling)."""
    if r.size != v.size:
        r = np.broadcast_to(r, v.shape)
    if c.size != v.size:
        c = np.broadcast_to(c, v.shape)
    v = v.ravel()
    keep = np.abs(v) > consts.EPSILON_F32
    rows.append(r.ravel()[keep])
    cols.append(c.ravel()[keep])
    vals.append(v[keep])


def _analytic_entries(st, a, b, d, rows, cols, vals):
    """Same-depth blocks (Octree.cpp:1459-1546). With L_p(1)=1 and
    L_p(-1)=(-1)^p: AA[i,j] = n_i n_j, AB[i,j] = -(-1)^{j_d} n_i n_j
    (emitted symmetrically), BB[i,j] = (-1)^{i_d+j_d} n_i n_j, where
    n_p = NormalisedLengths[p_d][depth] and (i,j) range over tangentially
    matching index pairs. Pair chunks bound peak memory (_BLOCK_ELEMS)."""
    nt = basis.norm_table()
    for da, db, dim, m in _groups(st, a, b, d):
        pa_all, pb_all = a[m], b[m]
        ia = basis.basis_indices(da)
        ib = basis.basis_indices(db)
        kmax = max(_tangential_match(da, da, dim)[0].size,
                   _tangential_match(da, db, dim)[0].size,
                   _tangential_match(db, db, dim)[0].size, 1)
        step = max(1, _BLOCK_ELEMS // kmax)
        for s0 in range(0, pa_all.size, step):
            pa = pa_all[s0:s0 + step]
            pb = pb_all[s0:s0 + step]
            dep = st.depth[pa]                    # == depth[pb] here

            def emit(bi_idx, bj_idx, pd_i, pd_j, starts_i, starts_j, sign):
                Ni = nt[pd_i[None, :], dep[:, None]]  # (P, K)
                Nj = nt[pd_j[None, :], dep[:, None]]
                v = sign[None, :] * Ni * Nj           # (P, K)
                r = starts_i[:, None] + bi_idx[None, :]
                c = starts_j[:, None] + bj_idx[None, :]
                _prune_append(rows, cols, vals, r, c, v)

            sA, sB = st.coeff_start[pa], st.coeff_start[pb]
            # AA
            i, j = _tangential_match(da, da, dim)
            emit(i, j, ia[i, dim], ia[j, dim], sA, sA,
                 np.ones(i.size))
            # AB and BA (symmetric)
            i, j = _tangential_match(da, db, dim)
            sgn = -np.where(ib[j, dim] % 2 == 0, 1.0, -1.0)
            emit(i, j, ia[i, dim], ib[j, dim], sA, sB, sgn)
            emit(j, i, ib[j, dim], ia[i, dim], sB, sA, sgn)
            # BB
            i, j = _tangential_match(db, db, dim)
            sgn = np.where((ib[i, dim] + ib[j, dim]) % 2 == 0, 1.0, -1.0)
            emit(i, j, ib[i, dim], ib[j, dim], sB, sB, sgn)


def _numeric_entries(st, a, b, d, rows, cols, vals):
    """Cross-depth blocks via separable 1-D quadrature.

    The reference's 2-D face quadrature (Octree.cpp:1250-1456) factorizes:
    every block entry is (normal factor) * I_t1[p,q] * I_t2[p,q] with
    I[p,q] = sum_x w_x L_p(x_A) L_q(x_B), where the shallower node's sample
    is x*2^-dd + t (the shared sub-face mapped into its frame) and the
    deeper node's sample is x itself.
    """
    nt = basis.norm_table()
    for da, db, dim, m in _groups(st, a, b, d):
        pa_all, pb_all = a[m], b[m]
        Ci = consts.coeff_count(da)
        Cj = consts.coeff_count(db)
        step = max(1, _BLOCK_ELEMS // (Ci * Cj))
        for s0 in range(0, pa_all.size, step):
            _numeric_group(st, nt, pa_all[s0:s0 + step],
                           pb_all[s0:s0 + step], dim, da, db,
                           rows, cols, vals)


def _numeric_group(st, nt, pa, pb, dim, da, db, rows, cols, vals):
    """One bounded chunk of cross-depth pairs sharing (deg_a, deg_b, dim)."""
    if pa.size:
        P = pa.size
        dep_a, dep_b = st.depth[pa], st.depth[pb]
        max_deg = max(da, db)
        x, w = basis.leggauss(basis.face_rule_size(max_deg))
        Q = x.size
        t1, t2 = (dim + 1) % 3, (dim + 2) % 3

        dd_ = np.abs(dep_a - dep_b)
        inv_dist = np.exp2(-dd_.astype(np.float64))
        half_a = np.exp2(-(dep_a.astype(np.float64) + 1.0))
        half_b = np.exp2(-(dep_b.astype(np.float64) + 1.0))
        b_deeper = dep_b > dep_a

        # transformed per-axis samples for each side's local frame
        # (invDist/invTranslation, Octree.cpp:1275-1290)
        xA, xB = {}, {}
        for t in (t1, t2):
            ca, cb = st.centre[pa][:, t], st.centre[pb][:, t]
            off = np.where(b_deeper, (cb - ca) / half_a, (ca - cb) / half_b)
            warp = x[None, :] * inv_dist[:, None] + off[:, None]   # (P, Q)
            raw = np.broadcast_to(x[None, :], (P, Q))
            xA[t] = np.where(b_deeper[:, None], warp, raw)
            xB[t] = np.where(b_deeper[:, None], raw, warp)

        def integ(xs_i, xs_j):
            Li = basis.legendre_all_np(xs_i, max_deg)          # (D+1, P, Q)
            Lj = basis.legendre_all_np(xs_j, max_deg)
            return np.einsum("pnq,rnq,q->npr", Li, Lj, w)      # (P, D+1, D+1)

        I_AA = {t: integ(xA[t], xA[t]) for t in (t1, t2)}
        I_AB = {t: integ(xA[t], xB[t]) for t in (t1, t2)}
        I_BB = {t: integ(xB[t], xB[t]) for t in (t1, t2)}

        area = np.where(b_deeper, half_b, half_a) ** 2          # (P,)

        ia = basis.basis_indices(da)
        ib = basis.basis_indices(db)
        NA = (nt[ia[:, 0][None, :], dep_a[:, None]]
              * nt[ia[:, 1][None, :], dep_a[:, None]]
              * nt[ia[:, 2][None, :], dep_a[:, None]])          # (P, CA)
        NB = (nt[ib[:, 0][None, :], dep_b[:, None]]
              * nt[ib[:, 1][None, :], dep_b[:, None]]
              * nt[ib[:, 2][None, :], dep_b[:, None]])          # (P, CB)
        sA, sB = st.coeff_start[pa], st.coeff_start[pb]

        def emit(bi, bj, I1, I2, fd, starts_i, starts_j, Ni, Nj,
                 transpose=False):
            Bv = (I1[:, bi[:, t1][:, None], bj[:, t1][None, :]]
                  * I2[:, bi[:, t2][:, None], bj[:, t2][None, :]]
                  * fd[None, :, :] * area[:, None, None]
                  * Ni[:, :, None] * Nj[:, None, :])            # (P, Ci, Cj)
            ii = np.arange(bi.shape[0])
            jj = np.arange(bj.shape[0])
            r = starts_i[:, None, None] + ii[None, :, None]
            c = starts_j[:, None, None] + jj[None, None, :]
            r = np.broadcast_to(r, Bv.shape)
            c = np.broadcast_to(c, Bv.shape)
            if transpose:
                r, c = c, r
            _prune_append(rows, cols, vals, r, c, Bv)

        sgn_i_b = np.where(ib[:, dim] % 2 == 0, 1.0, -1.0)
        # AA: L_i(1) L_j(1) = 1
        emit(ia, ia, I_AA[t1], I_AA[t2],
             np.ones((ia.shape[0], ia.shape[0])), sA, sA, NA, NA)
        # AB: -L_i(1) L_j(-1) = -(-1)^{j_d}, emitted with its transpose
        fd_ab = -np.ones((ia.shape[0], 1)) * sgn_i_b[None, :]
        emit(ia, ib, I_AB[t1], I_AB[t2], fd_ab, sA, sB, NA, NB)
        emit(ia, ib, I_AB[t1], I_AB[t2], fd_ab, sA, sB, NA, NB,
             transpose=True)
        # BB: L_i(-1) L_j(-1) = (-1)^{i_d+j_d}
        fd_bb = sgn_i_b[:, None] * sgn_i_b[None, :]
        emit(ib, ib, I_BB[t1], I_BB[t2], fd_bb, sB, sB, NB, NB)


def assemble_face_matrix(tree: Octree):
    """COO (rows, cols, vals) of the face-jump Gram matrix M plus the leaf
    view used for coefficient packing."""
    st = _LeafView(tree)
    a, b, d = leaf_face_pairs(st.child_idx, st.n)
    rows: list = []
    cols: list = []
    vals: list = []
    if a.size:
        same = st.depth[a] == st.depth[b]
        if same.any():
            _analytic_entries(st, a[same], b[same], d[same], rows, cols, vals)
        if (~same).any():
            _numeric_entries(st, a[~same], b[~same], d[~same],
                             rows, cols, vals)
    if rows:
        # every chunk was already EPSILON_F32-pruned on emission
        # (_prune_append, mirroring Octree.cpp:1336-1340); re-pruning the
        # concatenated arrays cost ~half the assembly tail at 50k+ leaves
        R = np.concatenate(rows)
        C = np.concatenate(cols)
        V = np.concatenate(vals)
    else:
        R = np.zeros(0, np.int64)
        C = np.zeros(0, np.int64)
        V = np.zeros(0, np.float64)
    return st, R, C, V


# --------------------------------------------------------------------------
# CG solve (device)
# --------------------------------------------------------------------------

# COO entries per chunk of the sorted-segment matvec (_cg_solve
# sorted_rows=True): bounds the matvec workspace at any nnz. Module-level
# so tests can shrink it to exercise the chunked path at small scale.
COO_CHUNK = 1 << 23


@functools.partial(jax.jit,
                   static_argnames=("n", "max_iter", "sorted_rows"))
def _cg_solve(rows, cols, vals, s, diag, b, x0, n: int, tol, max_iter: int,
              sorted_rows: bool = False):
    """Jacobi-preconditioned CG on (M + sI) x = b, M in COO form.

    Matvec = gather * vals -> segment_sum + s*x: the batched replacement
    for Eigen's sparse CG + IncompleteCholesky (Octree.cpp:1749-1755).

    ``sorted_rows``: entries are pre-sorted by row -- the segment sum
    lowers to a sorted-segment reduction instead of a random scatter-add,
    and the matvec runs CHUNKED over the entries (a lax.scan accumulating
    full-length partials) so its workspace stays bounded at any nnz; nnz
    must then be a multiple of COO_CHUNK (callers pad with val=0)."""
    if sorted_rows and rows.shape[0] > COO_CHUNK:
        nc = -(-rows.shape[0] // COO_CHUNK)
        rows_c = rows.reshape(nc, -1)
        cols_c = cols.reshape(nc, -1)
        vals_c = vals.reshape(nc, -1)

        def matvec(x):
            def body(acc, rcv):
                r_, c_, v_ = rcv
                # each chunk is a contiguous slice of the row-sorted
                # entries, so its own indices are sorted too; rows spanning
                # a chunk boundary simply accumulate from both chunks
                return acc + jax.ops.segment_sum(
                    v_ * x[c_], r_, num_segments=n,
                    indices_are_sorted=True), None
            out, _ = jax.lax.scan(body, jnp.zeros_like(x),
                                  (rows_c, cols_c, vals_c))
            return out + s * x
    else:

        def matvec(x):
            return jax.ops.segment_sum(vals * x[cols], rows,
                                       num_segments=n,
                                       indices_are_sorted=sorted_rows) \
                + s * x

    minv = 1.0 / diag
    x = x0
    r = b - matvec(x)
    z = minv * r
    p = z
    rz = jnp.vdot(r, z)
    thresh = tol * tol * jnp.vdot(b, b)

    def cond(state):
        _, r, _, _, k = state
        return (jnp.vdot(r, r) > thresh) & (k < max_iter)

    def body(state):
        x, r, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv * r
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new, k + 1

    x, r, _, _, k = jax.lax.while_loop(cond, body, (x, r, p, rz, 0))
    # iteration count + final residual norm: a stalled solve must be
    # distinguishable from a converged one (the reference had Eigen's
    # iteration diagnostics available; enforce_continuity logs these).
    return x, k, jnp.sqrt(jnp.vdot(r, r))


def _cg_solve_mixed(R, C, V, s, diag, b, x0, n: int, tol, max_iter: int,
                    max_refine: int = 10):
    """Device f32 CG + host f64 iterative refinement.

    The alternative to the plain f64 CG (_cg_solve): the heavy CG
    iterations run in f32 on the default device, and each refinement round
    computes one exact f64 residual r = b - (M + sI)x on host (a single
    vectorized COO matvec), then solves the correction system
    (M + sI)dx = r on device as one CG program. Classic mixed-precision
    refinement: ~7 digits gained per round, converging to full f64
    accuracy for the modest condition numbers the s-regularized system has
    (s >= 1 in practice).

    Same (x, iters, residual) contract and stopping rule as _cg_solve:
    ||r||_2 <= tol * ||b||_2 in exact f64.
    """
    # i32 indices: n_coeffs is far below 2^31 and the i64 COO index pair
    # alone is ~1 GB at the 62M-nnz 260k-leaf scale -- halving it bounds
    # the device footprint of the f32 iteration arrays. Entries are
    # row-sorted on host so the device matvec runs as chunked
    # sorted-segment reductions instead of one scatter-add.
    order = np.argsort(R, kind="stable")
    R, C, V = R[order], C[order], V[order]
    if R.size > COO_CHUNK:
        pad = (-R.size) % COO_CHUNK
        if pad:
            # padding repeats the LAST row (keeps the sorted order the
            # chunked matvec asserts) with val 0: contributes nothing
            R = np.concatenate([R, np.full(pad, R[-1], R.dtype)])
            C = np.concatenate([C, np.zeros(pad, C.dtype)])
            V = np.concatenate([V, np.zeros(pad, V.dtype)])
    Rj, Cj = jnp.asarray(R, jnp.int32), jnp.asarray(C, jnp.int32)
    V32 = jnp.asarray(V, jnp.float32)
    d32 = jnp.asarray(diag, jnp.float32)
    nrm_b = float(np.linalg.norm(b))
    x = np.asarray(x0, np.float64).copy()
    iters = 0
    resid = np.inf
    for _ in range(max_refine):
        mv = np.bincount(R, weights=V * x[C], minlength=n) + s * x
        r = b - mv
        resid = float(np.linalg.norm(r))
        if resid <= tol * nrm_b:
            break
        # scale the correction rhs to O(1) so the f32 solve keeps its full
        # relative precision regardless of how small the residual has become
        scale = float(np.max(np.abs(r)))
        if scale == 0.0:
            break
        # bounded inner budget: an f32 CG can stall just above a 1e-6
        # relative residual (f32 rounding floor); rather than burning
        # max_iter iterations against the floor, cap each round and let
        # the outer refinement (which measures the TRUE f64 residual)
        # decide whether another round is needed.
        dx, k, _ = _cg_solve(
            Rj, Cj, V32, s, d32, jnp.asarray(r / scale, jnp.float32),
            jnp.zeros(n, jnp.float32), n=n, tol=consts.EPSILON_F32,
            max_iter=min(max_iter, 800), sorted_rows=True)
        x = x + scale * np.asarray(dx, np.float64)
        iters += int(k)
    return x, iters, resid


# --------------------------------------------------------------------------
# Sharded CG solve (multi-chip)
# --------------------------------------------------------------------------

def _cg_solve_sharded(mesh, rows, cols, vals, s, diag, b, x0, n: int,
                      tol, max_iter: int):
    """Row-sharded CG over all devices of ``mesh`` (SURVEY.md section 7.4:
    "global sharded CG ... matvec via segment-sum of per-face blocks").

    Layout: the coefficient vector is block-partitioned across devices; COO
    entries are assigned to the device owning their output ROW, padded to
    equal per-device counts. Each matvec all-gathers x (the vector is a few
    MB -- cheap next to the segment-sum; the devices are joined all to all,
    so the mesh is one flat axis) and reduces locally; CG inner products
    are psum'd scalars.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    devs = mesh.devices.reshape(-1)
    cgmesh = jax.sharding.Mesh(devs, ("cg",))
    ndev = devs.size
    n_loc = -(-n // ndev)
    n_pad = n_loc * ndev

    def padv(v, fill):
        out = np.full(n_pad, fill, np.float64)
        out[:n] = v
        return out

    shard_of = rows // n_loc
    order = np.argsort(shard_of, kind="stable")
    rows, cols, vals, shard_of = (rows[order], cols[order], vals[order],
                                  shard_of[order])
    counts = np.bincount(shard_of, minlength=ndev)
    e_max = max(int(counts.max(initial=0)), 1)
    lrows = np.zeros((ndev, e_max), np.int64)     # padding -> row 0, val 0
    gcols = np.zeros((ndev, e_max), np.int64)
    gvals = np.zeros((ndev, e_max), np.float64)
    ofs = 0
    for k in range(ndev):
        c = int(counts[k])
        lrows[k, :c] = rows[ofs:ofs + c] - k * n_loc
        gcols[k, :c] = cols[ofs:ofs + c]
        gvals[k, :c] = vals[ofs:ofs + c]
        ofs += c

    def solve(lr_, gc_, gv_, diag_l, b_l, x0_l):
        lr_, gc_, gv_ = lr_[0], gc_[0], gv_[0]

        def matvec(xl):
            xg = jax.lax.all_gather(xl, "cg", tiled=True)     # (n_pad,)
            return jax.ops.segment_sum(
                gv_ * xg[gc_], lr_, num_segments=n_loc) + s * xl

        def pdot(u, v):
            return jax.lax.psum(jnp.vdot(u, v), "cg")

        minv = 1.0 / diag_l
        x = x0_l
        r = b_l - matvec(x)
        z = minv * r
        p = z
        rz = pdot(r, z)
        thresh = tol * tol * pdot(b_l, b_l)

        def cond(state):
            _, r, _, _, k = state
            return (pdot(r, r) > thresh) & (k < max_iter)

        def body(state):
            x, r, p, rz, k = state
            Ap = matvec(p)
            alpha = rz / pdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = minv * r
            rz_new = pdot(r, z)
            p = z + (rz_new / rz) * p
            return x, r, p, rz_new, k + 1

        x, r, _, _, k = jax.lax.while_loop(cond, body, (x, r, p, rz, 0))
        return x, k, jnp.sqrt(pdot(r, r))

    fn = jax.jit(shard_map(
        solve, mesh=cgmesh,
        in_specs=(P("cg", None), P("cg", None), P("cg", None),
                  P("cg"), P("cg"), P("cg")),
        out_specs=(P("cg"), P(), P())))
    ent = NamedSharding(cgmesh, P("cg", None))
    vec = NamedSharding(cgmesh, P("cg"))
    x, k, rn = fn(jax.device_put(lrows, ent), jax.device_put(gcols, ent),
                  jax.device_put(gvals, ent),
                  jax.device_put(padv(diag, 1.0), vec),
                  jax.device_put(padv(b, 0.0), vec),
                  jax.device_put(padv(x0, 0.0), vec))
    if jax.process_count() > 1:
        # multi-host: x spans processes; gather the full (small) vector
        from jax.experimental import multihost_utils
        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x)[:n], int(k), float(rn)


# --------------------------------------------------------------------------
# Public entry
# --------------------------------------------------------------------------

def enforce_continuity(tree: Octree, mesh=None, cg: str = "auto") -> Octree:
    """Return a tree whose coefficients minimize inter-cell jumps: solves
    (M + sI) c = s c0 with warm start (reference: Octree.cpp:1717-1762).

    Pass a ``jax.sharding.Mesh`` to run the CG row-sharded over its devices
    (the reference's OpenMP-in-Eigen data parallelism, re-designed as
    collectives between devices).

    ``cg``: "f64" = plain f64 CG on the default device; "mixed" = f32 CG on
    the default device with host f64 iterative refinement (same accuracy
    target); "auto" = "f64", measured faster than "mixed" on an NVIDIA
    H100 (PERF.md)."""
    st, R, C, V = assemble_face_matrix(tree)
    if st.n_coeffs == 0:
        return tree
    s = float(tree.config.continuity_strength)
    n = st.n_coeffs

    # pack padded per-leaf rows into the flat coefficient vector
    coeffs = np.asarray(tree.coeffs)
    leaf_ids = np.flatnonzero(st.degree[: st.n] >= 0)
    widths = st.widths[leaf_ids]
    flat_rows = np.repeat(leaf_ids, widths)
    flat_cols = np.concatenate([np.arange(w) for w in widths]) \
        if leaf_ids.size else np.zeros(0, np.int64)
    c0 = coeffs[flat_rows, flat_cols]

    diag = np.full(n, s, np.float64)
    on_diag = R == C
    np.add.at(diag, R[on_diag], V[on_diag])

    if cg == "auto":
        cg = "f64"
    if mesh is not None:
        x, iters, resid = _cg_solve_sharded(
            mesh, R, C, V, s, diag, s * c0, c0,
            n=n, tol=consts.EPSILON_F32, max_iter=2 * n)
    elif cg == "mixed":
        x, iters, resid = _cg_solve_mixed(
            R, C, V, s, diag, s * c0, c0,
            n=n, tol=consts.EPSILON_F32, max_iter=2 * n)
    else:
        x, iters, resid = _cg_solve(
            jnp.asarray(R), jnp.asarray(C), jnp.asarray(V),
            s, jnp.asarray(diag), jnp.asarray(s * c0),
            jnp.asarray(c0), n=n, tol=consts.EPSILON_F32,
            max_iter=2 * n)
        iters, resid = int(iters), float(resid)
    if tree.config.enable_logging:
        print(f"[hpsdf continuity] n={n} nnz={R.size} cg={cg} "
              f"iters={iters} residual={resid:.3e} "
              f"(tol {consts.EPSILON_F32:g}, max_iter {2 * n})")
    new_coeffs = coeffs.copy()
    new_coeffs[flat_rows, flat_cols] = np.asarray(x)
    return dataclasses.replace(tree, coeffs=jnp.asarray(new_coeffs))
