"""Relative orientation: 5-point essential matrix and camera extraction
(a numpy copy of dbat_tpu/geometry/essential.py).

Capability parity with the reference's essmat5.m (5-point minimal
solver) and camsfrome.m (E -> cameras with chirality disambiguation,
code/photogrammetry/). The solver here is the Stewenius/Nister
formulation: 4-dim nullspace of the epipolar constraints, the ten
cubic constraints det(E)=0 and 2*E*E'*E - tr(E*E')*E = 0, Gauss-Jordan
reduction and an action-matrix eigendecomposition.

References (method): Nister (2004) "An efficient solution to the
five-point relative pose problem", PAMI 26(6); Stewenius, Engels,
Nister (2006) ISPRS 60(4).
"""

from __future__ import annotations

import numpy as np

# Monomial order: degree-3 first (leading), then the quotient basis.
_MONOS = [
    (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
    (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3),
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
_MIDX = {m: i for i, m in enumerate(_MONOS)}


class _Poly:
    """Sparse polynomial in (x,y,z), total degree <= 3."""

    __slots__ = ("c",)

    def __init__(self, c=None):
        self.c = dict(c) if c else {}

    @classmethod
    def lin(cls, cx, cy, cz, c1):
        p = cls()
        for mono, v in (((1, 0, 0), cx), ((0, 1, 0), cy),
                        ((0, 0, 1), cz), ((0, 0, 0), c1)):
            if v != 0:
                p.c[mono] = v
        return p

    def __add__(self, o):
        out = _Poly(self.c)
        for m, v in o.c.items():
            out.c[m] = out.c.get(m, 0.0) + v
        return out

    def __sub__(self, o):
        out = _Poly(self.c)
        for m, v in o.c.items():
            out.c[m] = out.c.get(m, 0.0) - v
        return out

    def __mul__(self, o):
        out = _Poly()
        if isinstance(o, _Poly):
            for m1, v1 in self.c.items():
                for m2, v2 in o.c.items():
                    m = (m1[0] + m2[0], m1[1] + m2[1], m1[2] + m2[2])
                    out.c[m] = out.c.get(m, 0.0) + v1 * v2
        else:
            for m, v in self.c.items():
                out.c[m] = v * o
        return out

    def coeffs(self):
        v = np.zeros(20)
        for m, c in self.c.items():
            v[_MIDX[m]] = c
        return v


def essential_5pt(x1: np.ndarray, x2: np.ndarray) -> list:
    """Essential matrices from >=5 normalized correspondences.

    x1, x2: (2,n) or (3,n) normalized image coordinates (K^-1 applied);
    the epipolar constraint used is x2' E x1 = 0. Returns a list of
    3x3 candidates (up to 10).
    """
    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    if x1.shape[0] == 2:
        x1 = np.vstack([x1, np.ones(x1.shape[1])])
    if x2.shape[0] == 2:
        x2 = np.vstack([x2, np.ones(x2.shape[1])])
    n = x1.shape[1]
    if n < 5:
        raise ValueError("need at least 5 correspondences")

    # Epipolar design matrix: rows kron(x1, x2) for E stacked row-major
    # (x2' E x1 = sum_ij E[i,j] x2[i] x1[j]).
    A = np.zeros((n, 9))
    for k in range(n):
        A[k] = np.outer(x2[:, k], x1[:, k]).reshape(-1)
    _, _, Vt = np.linalg.svd(A)
    basis = Vt[-4:][::-1]  # 4-dim nullspace: E = x B0 + y B1 + z B2 + B3

    # E entries as linear polynomials.
    E = [[_Poly.lin(basis[0, 3 * i + j], basis[1, 3 * i + j],
                    basis[2, 3 * i + j], basis[3, 3 * i + j])
          for j in range(3)] for i in range(3)]

    def det3(M):
        return (M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1])
                - M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0])
                + M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0]))

    eqs = [det3(E)]

    # EEt = E*E'; trace; C = 2*EEt*E - tr*E
    EEt = [[sum((E[i][k] * E[j][k] for k in range(3)), _Poly())
            for j in range(3)] for i in range(3)]
    tr = EEt[0][0] + EEt[1][1] + EEt[2][2]
    for i in range(3):
        for j in range(3):
            s = sum((EEt[i][k] * E[k][j] for k in range(3)), _Poly())
            eqs.append(s * 2.0 - tr * E[i][j])

    M = np.stack([e.coeffs() for e in eqs])  # (10, 20)

    # Gauss-Jordan: leading 10 columns -> identity.
    try:
        B = np.linalg.solve(M[:, :10], M[:, 10:])  # (10,10)
    except np.linalg.LinAlgError:
        return []

    # Action matrix for multiplication by x on the quotient basis
    # q = [x^2, xy, xz, y^2, yz, z^2, x, y, z, 1]: row i expresses
    # x*q_i in the basis.  x*q_i for i<6 is a degree-3 monomial
    # (x^3, x^2y, x^2z, xy^2, xyz, xz^2 = _MONOS rows 0..5), reduced
    # via the Gauss-Jordan rows: mono_lead = -B[row] . q; the rest map
    # back into the basis directly.  Then A q = x q, so q is a right
    # eigenvector with eigenvalue x.
    At = np.zeros((10, 10))
    for i in range(6):
        At[i] = -B[i]
    At[6, 0] = 1.0  # x*x = x^2
    At[7, 1] = 1.0  # x*y = xy
    At[8, 2] = 1.0  # x*z = xz
    At[9, 6] = 1.0  # x*1 = x

    w, V = np.linalg.eig(At)
    out = []
    for k in range(10):
        if abs(w[k].imag) > 1e-8 * max(1.0, abs(w[k])):
            continue
        v = V[:, k].real
        if abs(v[9]) < 1e-12:
            continue
        x = v[6] / v[9]
        y = v[7] / v[9]
        z = v[8] / v[9]
        Em = (x * basis[0] + y * basis[1] + z * basis[2] + basis[3]
              ).reshape(3, 3)
        nrm = np.linalg.norm(Em)
        if nrm > 0:
            out.append(Em / nrm)
    return out


def cams_from_e(E: np.ndarray, x1=None, x2=None):
    """Camera pairs from an essential matrix (ref camsfrome.m).

    Returns the 4 candidate second cameras P2 = [R|t] (P1 = [I|0]);
    with correspondences given, returns the single chirality-consistent
    (R, t) plus the candidate list.
    """
    U, s, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    if x1 is None:
        return cands

    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    if x1.shape[0] == 2:
        x1 = np.vstack([x1, np.ones(x1.shape[1])])
    if x2.shape[0] == 2:
        x2 = np.vstack([x2, np.ones(x2.shape[1])])
    # The chirality vote only needs a sample: 24 triangulations decide
    # between 4 candidates with overwhelming margin (the full per-point
    # loop was the hot spot of the 239-camera view-graph build).
    if x1.shape[1] > 24:
        step = x1.shape[1] // 24
        x1 = x1[:, ::step][:, :24]
        x2 = x2[:, ::step][:, :24]

    best = None
    best_count = -1
    for R, tt in cands:
        # Triangulate and count points in front of both cameras.
        count = 0
        for k in range(x1.shape[1]):
            X = _triangulate(np.eye(3), np.zeros(3), R, tt,
                             x1[:, k], x2[:, k])
            z1 = X[2]
            z2 = (R @ X + tt)[2]
            if z1 > 0 and z2 > 0:
                count += 1
        if count > best_count:
            best_count = count
            best = (R, tt)
    return best, cands


def _triangulate(R1, t1, R2, t2, u1, u2):
    """Linear two-view triangulation (DLT) with P = [R|t]."""
    P1 = np.hstack([R1, t1[:, None]])
    P2 = np.hstack([R2, t2[:, None]])
    A = np.vstack([
        u1[0] * P1[2] - P1[0],
        u1[1] * P1[2] - P1[1],
        u2[0] * P2[2] - P2[0],
        u2[1] * P2[2] - P2[1],
    ])
    _, _, Vt = np.linalg.svd(A)
    X = Vt[-1]
    return X[:3] / X[3]


def essential_ransac(x1, x2, threshold: float = 1e-3, iters: int = 200,
                     rng=None):
    """Robust essential matrix via 5-point RANSAC with Sampson error.

    MSAC scoring (sum of thresholded Sampson distances) rather than a
    raw inlier count: with low-noise data several candidate E's can fit
    every point inside the threshold, and the count alone would keep
    whichever wrong solution was sampled first."""
    rng = rng or np.random.default_rng(0)
    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    if x1.shape[0] == 2:
        x1 = np.vstack([x1, np.ones(x1.shape[1])])
    if x2.shape[0] == 2:
        x2 = np.vstack([x2, np.ones(x2.shape[1])])
    n = x1.shape[1]
    best_E, best_inl = None, np.zeros(n, dtype=bool)
    best_score = np.inf
    # Adaptive termination [Fischler & Bolles 1981 / Hartley-Zisserman
    # alg. 4.5]: stop once enough samples were drawn to contain an
    # all-inlier 5-tuple with 99.9% confidence at the current inlier
    # ratio.  On clean networks (inlier ratio ~1) this is 1-2
    # iterations instead of the fixed budget — the dominant cost of
    # the large-network view-graph build (POSEGRAPH_C5.md).
    need = iters
    it = 0
    # Floor of 3 samples: MSAC score comparison needs competing
    # hypotheses — on low-noise data several candidate E's can fit
    # every point inside the threshold and the first sampled one may
    # be the wrong (e.g. near-planar-degenerate) solution.
    min_samples = min(3, iters)
    while it < min(iters, max(need, min_samples)):
        sel = rng.choice(n, 5, replace=False)
        for E in essential_5pt(x1[:, sel], x2[:, sel]):
            d = _sampson(E, x1, x2)
            score = np.minimum(d, threshold).sum()
            if score < best_score:
                best_E, best_inl, best_score = E, d < threshold, score
                w = best_inl.mean()
                if w >= 1.0 - 1e-12:
                    need = 1
                elif w > 0:
                    need = int(np.ceil(np.log(1e-3)
                                       / np.log(1.0 - w ** 5 + 1e-300)))
        it += 1
    return best_E, best_inl


def _sampson(E, x1, x2):
    Ex1 = E @ x1
    Etx2 = E.T @ x2
    num = np.einsum("ij,ij->j", x2, Ex1) ** 2
    den = Ex1[0] ** 2 + Ex1[1] ** 2 + Etx2[0] ** 2 + Etx2[1] ** 2
    return num / np.maximum(den, 1e-300)
