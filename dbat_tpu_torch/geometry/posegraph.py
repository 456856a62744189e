"""Pose-graph initialization for large networks without control points
(a numpy copy of dbat_tpu/geometry/posegraph.py).

The reference initializes networks camera-by-camera with 3-point
resection against known object points (code/photogrammetry/resect.m) —
which requires control points or prior OP values.  This layer builds
initial EO/OP values from image measurements alone:

  1. view graph: a relative orientation (5-point essential RANSAC,
     essential.py; ref essmat5.m/camsfrome.m) per camera pair with
     enough shared points;
  2. global rotation averaging: spanning-tree chaining + chordal
     (projected-mean) sweeps [Hartley, Trumpf, Dai, Li IJCV 2013];
  3. global translation recovery: the cross-product linear system
     [t_ij]_x R_j (C_i - C_j) = 0 over all edges, smallest singular
     vector with the gauge fixed by C_0 = 0 and unit RMS baseline
     [Govindu CVPR 2001];
  4. point initialization by multi-ray forward intersection
     (initvals.forward_intersect; ref forwintersect.m) and, when
     control points exist, a similarity alignment onto them
     (align.rigid_align; ref pm_multialign.m).

Everything is one-time host-side numpy (like resection); the heavy
iteration stays in the bundle on the card.
"""

from __future__ import annotations

import numpy as np

from .essential import cams_from_e, essential_ransac
from .initvals import forward_intersect, ideal_proj_obs
from ..models.rotation import decompose_w2c_np, w2c_from_angles_np


def _normalized_obs(project):
    """Normalized camera-ray coordinates u = [ideal/-f, 1] per
    observation.

    ideal_proj_obs inverts the full measured-side chain (lens AND
    affine), so u equals Xc/Xc_z exactly for noise-free data.  Note
    DBAT cameras look down -z (in-front points have Xc_z < 0), so u is
    anti-parallel to the true ray; the epipolar constraint is
    scale-sign-invariant, and cams_from_e's z>0 chirality vote then
    selects (R_true, -t_true) — correct rotation, translation direction
    negated, which recover_centers' cross-product system and the final
    global-sign vote both tolerate."""
    p = project
    un = ideal_proj_obs(p) / -p.io[p.obs_img][:, 0:1]
    return np.concatenate([un, np.ones((len(un), 1))], axis=1)


def build_view_graph(project, min_shared: int = 12, ransac_iters: int = 100,
                     threshold: float = 2e-3, max_pairs_per_cam: int = 8,
                     rng=None):
    """Pairwise relative orientations over the measurement graph.

    Returns a list of edges (i, j, R_ij, t_ij, n_inliers) with
    R_ij = R_j R_i^T and t_ij ~ R_j (C_i - C_j) (unit, sign fixed by
    chirality voting).  Camera pairs are ranked by shared-point count
    and each camera keeps at most `max_pairs_per_cam` strongest edges —
    the graph stays O(n) while staying connected for ring/strip
    networks.
    """
    p = project
    rng = rng or np.random.default_rng(0)
    u = _normalized_obs(p)

    # Shared-observation pairs per camera pair, fully vectorized (the
    # round-2 Python dict loop was O(sum rays^2) appends — minutes at
    # 197k observations): strict within-point observation pairs from
    # the solver's pair builder, keyed and sorted by camera pair.
    from ..solve.schur import _build_pairs

    i1, i2 = _build_pairs(np.asarray(p.obs_pt))
    c1 = np.asarray(p.obs_img)[i1]
    c2 = np.asarray(p.obs_img)[i2]
    swap = c1 > c2
    c1s = np.where(swap, c2, c1)
    c2s = np.where(swap, c1, c2)
    o1 = np.where(swap, i2, i1)
    o2 = np.where(swap, i1, i2)
    key = c1s.astype(np.int64) * p.n_img + c2s
    ko = np.argsort(key, kind="stable")
    key, o1, o2 = key[ko], o1[ko], o2[ko]
    ukey, kstart, kcount = np.unique(key, return_index=True,
                                     return_counts=True)
    big = kcount >= min_shared
    cand_order = np.argsort(-kcount[big], kind="stable")
    cand_idx = np.flatnonzero(big)[cand_order]

    deg = np.zeros(p.n_img, dtype=int)
    edges = []
    for q in cand_idx:
        i = int(ukey[q] // p.n_img)
        j = int(ukey[q] % p.n_img)
        if deg[i] >= max_pairs_per_cam and deg[j] >= max_pairs_per_cam:
            continue
        sl = slice(kstart[q], kstart[q] + kcount[q])
        x1 = u[o1[sl]].T  # camera i
        x2 = u[o2[sl]].T  # camera j
        E, inl = essential_ransac(x1, x2, threshold=threshold,
                                  iters=ransac_iters, rng=rng)
        if E is None or inl.sum() < min_shared:
            continue
        best, _ = cams_from_e(E, x1[:, inl], x2[:, inl])
        if best is None:
            continue
        R, t = best
        nt = np.linalg.norm(t)
        if nt == 0:
            continue
        edges.append((int(i), int(j), R, t / nt, int(inl.sum())))
        deg[i] += 1
        deg[j] += 1
    return edges


def _project_so3_batch(M):
    """SO(3) projection of a (..., 3, 3) stack via batched SVD."""
    U, _, Vt = np.linalg.svd(M)
    R = U @ Vt
    neg = np.linalg.det(R) < 0
    if np.any(neg):
        U = U.copy()
        U[neg, :, 2] *= -1.0
        R = U @ Vt
    return R


def _spectral_rotations(n_img, ei, ej, Rrel, w):
    """Spectral rotation synchronization: top-3 eigenvectors of the
    degree-normalized block matrix of relative rotations.

    With R_ij = R_j R_i^T, each camera block satisfies
    R_i = R_ij^T R_j, so the stacked 3n x 3 matrix X with X_i = R_i is
    (noise-free) an invariant subspace of the symmetric block matrix
    M[i,j] = w_ij R_ij^T, M[j,i] = w_ij R_ij.  The top-3 eigenvectors
    of D^-1/2 M D^-1/2 recover X up to a global 3x3 mixing, which the
    per-block SO(3) projection and the R_0 = I gauge remove
    [Singer 2011 angular synchronization; Arie-Nachimson et al. 3DV
    2012].  Direct and global: no sweep/diffusion mixing time, which
    is what made iterated local averaging collapse on large ring
    graphs (error diffuses O(diameter^2) sweeps)."""
    M = np.zeros((3 * n_img, 3 * n_img))
    deg = np.zeros(n_img)
    Rw = w[:, None, None] * Rrel
    for k in range(len(ei)):
        i, j = ei[k], ej[k]
        M[3 * i:3 * i + 3, 3 * j:3 * j + 3] += Rw[k].T
        M[3 * j:3 * j + 3, 3 * i:3 * i + 3] += Rw[k]
    np.add.at(deg, ei, w)
    np.add.at(deg, ej, w)
    dis = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    Dh = np.repeat(dis, 3)
    vals, vecs = np.linalg.eigh(Dh[:, None] * M * Dh[None, :])
    X = (Dh[:, None] * vecs[:, -3:]).reshape(n_img, 3, 3).copy()
    # The eigenvectors recover X_i = R_i Q for a common invertible Q
    # whose sign of det is arbitrary.  polar(R_i Q) = R_i polar(Q) is
    # block-consistent only when det Q > 0 — the per-block det<0 fix
    # in _project_so3_batch would otherwise break synchronization.
    # Flip one eigenvector column globally to force det Q > 0.
    if np.median(np.linalg.det(X)) < 0:
        X[:, :, 2] *= -1.0
    R = _project_so3_batch(X)
    # Global mixing removal: gauge to camera 0.
    return np.einsum("nab,cb->nac", R, R[0])


def average_rotations(n_img: int, edges, sweeps: int = 20,
                      irls_rounds: int = 3):
    """Global rotations from pairwise R_ij = R_j R_i^T.

    Spectral synchronization (global, direct — see
    _spectral_rotations) wrapped in IRLS rounds with Cauchy
    reweighting of the per-edge chordal residual, then a few
    vectorized Jacobi chordal-mean sweeps for local refinement
    (each camera re-estimated as the SO(3) projection of the weighted
    mean of its neighbors' predictions) [Hartley et al. IJCV 2013;
    Chatterjee & Govindu ICCV 2013 robust L1/IRLS].

    Fully vectorized: the spectral step is one dense 3n x 3n eigh
    (239 cameras -> 717 x 717, milliseconds); each sweep is one
    batched 3x3 einsum over the directed edge list, a segment sum per
    target camera, and one batched SVD — O(edges) numpy work with no
    Python loop over cameras (the round-3 version was minutes of
    interpreter time at 239+ cameras; see POSEGRAPH_C5.md)."""
    m = len(edges)
    ei = np.array([e[0] for e in edges], dtype=np.int64)
    ej = np.array([e[1] for e in edges], dtype=np.int64)
    Rrel = np.stack([e[2] for e in edges])  # R_j = Rrel @ R_i
    w0 = np.array([float(e[4]) for e in edges])

    # Connectivity check (spectral recovery needs one component).
    seen = np.zeros(n_img, bool)
    seen[0] = True
    frontier = np.array([0])
    adj_i = np.concatenate([ei, ej])
    adj_j = np.concatenate([ej, ei])
    while frontier.size:
        nxt = np.unique(adj_j[np.isin(adj_i, frontier)])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    if not seen.all():
        raise ValueError(
            f"view graph disconnected: {int((~seen).sum())} cameras "
            "unreachable from camera 0")

    def edge_residuals(Rg):
        return np.linalg.norm(
            (Rg[ej] - np.einsum("kab,kbc->kac", Rrel, Rg[ei])
             ).reshape(m, 9), axis=1)

    w = w0.copy()
    Rg = None
    for round_ in range(irls_rounds):
        Rg = _spectral_rotations(n_img, ei, ej, Rrel, w)
        if round_ == irls_rounds - 1:
            break
        res = edge_residuals(Rg)
        sigma = max(1.4826 * np.median(res), 1e-6)
        w = w0 / (1.0 + (res / sigma) ** 2)

    # Local chordal-mean refinement: directed edges, prediction of
    # R_tgt from R_src is P @ R_src.
    tgt = np.concatenate([ei, ej])
    src = np.concatenate([ej, ei])
    P = np.concatenate([Rrel.transpose(0, 2, 1), Rrel])
    wd = np.concatenate([w, w])
    for _ in range(sweeps):
        pred = wd[:, None, None] * np.einsum("kab,kbc->kac", P, Rg[src])
        M = np.zeros((n_img, 3, 3))
        np.add.at(M, tgt, pred)
        ok = np.linalg.norm(M.reshape(n_img, 9), axis=1) > 0
        Rnew = np.where(ok[:, None, None], _project_so3_batch(M), Rg)
        delta = np.abs(Rnew - Rg).max()
        Rg = Rnew
        if delta < 1e-10:
            break
    # Re-fix the gauge after refinement.
    return np.einsum("nab,cb->nac", Rg, Rg[0])


def recover_centers(n_img: int, edges, Rg, irls_rounds: int = 4,
                    max_dense_entries: int = 50_000_000):
    """Camera centers from translation directions t_ij ~ R_j(C_i - C_j).

    Minimizes sum ||[t_ij]_x R_j (C_i - C_j)||^2 with C_0 = 0, over the
    unit sphere (smallest right singular vector); IRLS rounds with
    Cauchy weights on the per-edge residual (normalized by baseline)
    keep wrong translation directions from bending the solution.
    Returns centers up to a global scale whose sign is later fixed by
    chirality.

    Edge-only translation averaging is the small-graph fallback: the
    dense (3m, 3(n-1)) SVD system is guarded by `max_dense_entries`
    (~400 MB of f64); larger graphs must use
    recover_centers_structure, the production path (its conditioning
    also does not collapse with graph diameter — POSEGRAPH_C5.md)."""
    m = len(edges)
    if 9 * m * max(n_img - 1, 1) > max_dense_entries:
        raise ValueError(
            f"recover_centers: dense system over {m} edges x {n_img} "
            "cameras exceeds the size guard; use "
            "recover_centers_structure (the production path) for "
            "large graphs")
    ei = np.array([e[0] for e in edges], np.int64)
    ej = np.array([e[1] for e in edges], np.int64)
    t_e = np.stack([np.asarray(e[3], float) for e in edges])
    w_e = np.array([float(e[4]) for e in edges])

    # Batched [t]_x R_j blocks (one per edge).
    z = np.zeros(m)
    Tx = np.array([
        [z, -t_e[:, 2], t_e[:, 1]],
        [t_e[:, 2], z, -t_e[:, 0]],
        [-t_e[:, 1], t_e[:, 0], z],
    ]).transpose(2, 0, 1)
    B_all = np.einsum("kab,kbc->kac", Tx, Rg[ej])

    def solve(weights):
        Bw = np.sqrt(weights)[:, None, None] * B_all
        A = np.zeros((m, 3, n_img - 1, 3))
        kk = np.arange(m)
        si = ei != 0
        A[kk[si], :, ei[si] - 1, :] = Bw[si]
        sj = ej != 0
        A[kk[sj], :, ej[sj] - 1, :] = -Bw[sj]
        A = A.reshape(3 * m, 3 * (n_img - 1))
        _, _, Vt = np.linalg.svd(A, full_matrices=False)
        C = np.zeros((n_img, 3))
        C[1:] = Vt[-1].reshape(-1, 3)
        rms = np.sqrt((C ** 2).sum(axis=1).mean())
        return C / max(rms, 1e-300)

    weights = w_e.copy()
    C = solve(weights)
    for _ in range(irls_rounds - 1):
        v = np.einsum("kab,kb->ka", Rg[ej], C[ei] - C[ej])
        nb = np.maximum(np.linalg.norm(v, axis=1), 1e-12)
        res = np.linalg.norm(np.cross(t_e, v), axis=1) / nb
        sigma = max(1.4826 * np.median(res), 1e-6)
        weights = w_e / (1.0 + (res / sigma) ** 2)
        C = solve(weights)
    return C


def recover_centers_structure(project, Rg, irls_rounds: int = 3):
    """Camera centers from ALL image observations at known global
    rotations (the 'known-rotation problem': cameras AND points are
    linear unknowns; points are Schur-eliminated).

    Each observation of point p in camera i with world ray direction
    u = R_i^T u_cam contributes the rank-2 constraint
    P_u (X_p - C_i) = 0 with P_u = I - u u^T.  The normal equations
    have 3x3 block-diagonal point blocks; eliminating them leaves the
    3n x 3n reduced camera system S whose null space (noise-free) is
    the 3 global translations plus the sought similarity-scale mode —
    the solution is the smallest eigenvector of S after projecting the
    translations out.  [Known-rotation SfM: Kahl & Hartley PAMI 2008;
    spectral gauge handling as in Govindu CVPR 2001.]

    Unlike edge-only translation averaging (recover_centers), every
    track couples all its cameras: the conditioning does not collapse
    with graph diameter, which is what bent 60+-camera rings (see
    POSEGRAPH_C5.md).  IRLS rounds with Cauchy weights on the per-obs
    residual keep wrong matches from bending the solution.

    Returns (C, X): centers (n_img, 3) and points (n_op, 3) in the
    same free gauge (zero-mean C, unit RMS C), up to global sign.
    """
    p = project
    n, n_pt = p.n_img, p.n_op
    u = _normalized_obs(p)
    # World ray direction: Xc = R (X - C)  =>  direction R^T u_cam.
    u_w = np.einsum("nba,nb->na", Rg[p.obs_img], u)
    u_w /= np.linalg.norm(u_w, axis=1, keepdims=True)
    Pu0 = np.eye(3)[None] - u_w[:, :, None] * u_w[:, None, :]
    oi = np.asarray(p.obs_img, np.int64)
    op = np.asarray(p.obs_pt, np.int64)

    from ..solve.schur import _build_pairs

    i1, i2 = _build_pairs(op)  # strict pairs of obs within each point

    def _accum_blocks(idx, blocks, n_bins):
        """Sum (k, 3, 3) blocks into bins: returns (n_bins, 3, 3).
        bincount per component — orders of magnitude faster than
        np.add.at for the millions of within-point pairs at C5 scale."""
        B = blocks.reshape(-1, 9)
        out = np.empty((9, n_bins))
        for c in range(9):
            out[c] = np.bincount(idx, weights=B[:, c], minlength=n_bins)
        return out.reshape(3, 3, n_bins).transpose(2, 0, 1)

    w_obs = np.ones(len(u_w))
    C = X = None
    for round_ in range(irls_rounds):
        Pu = w_obs[:, None, None] * Pu0
        # Point blocks and their inverses (regularized: near-parallel
        # two-ray points must not blow up the back-substitution).
        Npp = _accum_blocks(op, Pu, n_pt)
        tr = np.trace(Npp, axis1=1, axis2=2)
        Npp_r = Npp + (1e-9 * np.maximum(tr, 1e-12))[:, None, None] \
            * np.eye(3)[None]
        Npp_inv = np.linalg.inv(Npp_r)

        # Reduced camera system S = Ncc - Ncp Npp^-1 Npc, accumulated
        # into (n*n) bins keyed by camera pair.
        G = np.einsum("kab,kbc,kcd->kad", Pu, Npp_inv[op], Pu)
        Gp = np.einsum("kab,kbc,kcd->kad",
                       Pu[i1], Npp_inv[op[i1]], Pu[i2])
        S = _accum_blocks(oi * n + oi, Pu - G, n * n)
        S -= _accum_blocks(oi[i1] * n + oi[i2], Gp, n * n)
        S -= _accum_blocks(oi[i2] * n + oi[i1],
                           Gp.transpose(0, 2, 1), n * n)
        Sf = S.reshape(n, n, 3, 3).transpose(0, 2, 1, 3).reshape(
            3 * n, 3 * n)

        vals, vecs = np.linalg.eigh(Sf)
        # 4-dim (near-)null space: 3 translations + the solution mode.
        V4 = vecs[:, :4]
        T = np.zeros((3 * n, 3))
        T[0::3, 0] = T[1::3, 1] = T[2::3, 2] = 1.0
        T /= np.sqrt(n)
        # Component of span(V4) orthogonal to the translations: the
        # smallest right singular vector of T' V4 spans it.
        _u_, _s_, vt = np.linalg.svd(T.T @ V4)
        coef = vt[-1]  # null direction of the 3x4 map (exists: 4 > 3)
        c_vec = V4 @ coef
        C = c_vec.reshape(n, 3)
        C = C - C.mean(axis=0)
        C /= max(np.sqrt((C ** 2).sum(axis=1).mean()), 1e-300)

        # Back-substitute points: X_p = Npp^-1 sum_obs Pu C_i.
        pc = np.einsum("kab,kb->ka", Pu, C[oi])
        rhs = np.stack([np.bincount(op, weights=pc[:, c],
                                    minlength=n_pt) for c in range(3)],
                       axis=1)
        X = np.einsum("pab,pb->pa", Npp_inv, rhs)

        if round_ == irls_rounds - 1:
            break
        # Residual per observation at the current geometry, normalized
        # by depth so far points do not dominate.
        v = X[op] - C[oi]
        depth = np.maximum(np.linalg.norm(v, axis=1), 1e-12)
        res = np.linalg.norm(
            np.einsum("kab,kb->ka", Pu0, v), axis=1) / depth
        sigma = max(1.4826 * np.median(res), 1e-9)
        w_obs = 1.0 / (1.0 + (res / sigma) ** 2)
    return C, X


def init_from_pose_graph(project, min_shared: int = 12,
                         ransac_iters: int = 100, threshold: float = 2e-3,
                         max_pairs_per_cam: int = 8, sweeps: int = 30,
                         rng=None):
    """Initialize project.eo and project.op from measurements alone.

    Returns a dict with the view-graph edges and diagnostics.  When the
    project carries control points (prior_op), the free-gauge network
    is similarity-aligned onto them; otherwise it is left in the
    pose-graph gauge (C_0 = 0, unit RMS baseline) — exactly what a
    free-network bundle with inner constraints expects."""
    p = project
    # Known object coordinates to align the free-gauge network onto:
    # fully-fixed points (est_op none; ctrl points in synthetic/demo
    # networks) plus weighted ctrl points carrying full priors.  Saved
    # now because forward_intersect below overwrites every OP.
    fixed = ~p.est_op.any(axis=1) & np.isfinite(p.op).all(axis=1)
    fixed_vals = p.op[fixed].copy()
    prior_full = (p.prior_op_use.all(axis=1)
                  & np.isfinite(p.prior_op_val).all(axis=1) & ~fixed)
    ctrl_idx = np.concatenate(
        [np.flatnonzero(fixed), np.flatnonzero(prior_full)])
    ctrl_target = np.concatenate(
        [fixed_vals, p.prior_op_val[prior_full]], axis=0)

    import time as _time

    t0 = _time.time()
    edges = build_view_graph(p, min_shared=min_shared,
                             ransac_iters=ransac_iters, threshold=threshold,
                             max_pairs_per_cam=max_pairs_per_cam, rng=rng)
    t_graph = _time.time() - t0
    if not edges:
        raise ValueError("no view-graph edges (too few shared points?)")
    t0 = _time.time()
    Rg = average_rotations(p.n_img, edges, sweeps=sweeps)
    t_rot = _time.time() - t0
    t0 = _time.time()
    C, _X = recover_centers_structure(p, Rg)
    t_cen = _time.time() - t0

    # Write EO (angles via the project's w2c convention), then
    # triangulate; chirality vote fixes the global scale sign.
    ang_g = decompose_w2c_np(np.stack(Rg))
    for sign in (1.0, -1.0):
        p.eo[:, 0:3] = sign * C
        p.eo[:, 3:6] = ang_g
        ids, _res = forward_intersect(p, ids="all", skip_prior=False)
        depths = _point_depths(p)
        # In-front is depth < 0 in this convention (projection uses -f;
        # ref pointdepth.m negates ptdepth) — cf. bundle.chirality_veto.
        if np.median(depths) < 0:
            break

    n_behind = int((depths >= 0).sum())

    # Similarity-align the free-gauge network onto the known control
    # coordinates (ref pm_multialign.m / rigidalign.m), then restore
    # fixed points exactly (the bundle treats them as constants).
    aligned = False
    if len(ctrl_idx) >= 3:
        from .align import rigid_align, transform_network

        T, _R, _d, _alpha = rigid_align(
            p.op[ctrl_idx].T, ctrl_target.T, scale=True)
        transform_network(p, T)
        aligned = True
    p.op[fixed] = fixed_vals

    return {"edges": [(i, j, w) for (i, j, _R, _t, w) in edges],
            "n_edges": len(edges), "behind": n_behind,
            "aligned_to_ctrl": aligned,
            "times": {"view_graph": t_graph, "rotations": t_rot,
                      "centers": t_cen}}


def _point_depths(project):
    """Depth (camera-frame z) of every observation's object point."""
    p = project
    R = w2c_from_angles_np(p.eo[:, 3:6])
    Xc = np.einsum(
        "nab,nb->na", R[p.obs_img], p.op[p.obs_pt] - p.eo[p.obs_img, 0:3])
    return Xc[:, 2]
