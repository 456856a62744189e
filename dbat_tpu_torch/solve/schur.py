"""Schur-complement reduced camera system (counterpart of
dbat_tpu/solve/schur.py, single-device path).

    N = [ U   Wc ]     U : (n_c,n_c) dense camera/IO block
        [ Wc' V  ]     V : (n_op,3,3) block-diagonal point blocks
                       Wc: one (n_cb,3) block per *observation*

    S  = U - sum_j Wc_j V_j^-1 Wc_j'          (reduced camera system)
    pc = S^-1 (bc - sum_j Wc_j V_j^-1 bp_j)
    pp_j = V_j^-1 (bp_j - Wc_j' pc)           (batched 3x3 solves)

Block products run through FlatBilinear (kernel A on the card), the
off-diagonal S fill-in through PairBucketPlan (kernel B); reductions
are SegSum plans, and the scatters into U, S and the camera gradient
are SegScatter plans on index maps built once here.  Every sum runs in
an order fixed at setup, with no atomics, so f32 results on the card
repeat bit for bit from run to run.

`_solve_pcg_impl` solves the same system without forming S (pcg.py).

Deferred (same numbers through this general path): the packed-R plan
for uniform ray counts, the `_img_block6` windowed scatter, the
chunked-scan mesh plan.
"""

from __future__ import annotations

import numpy as np
import torch

from .flatsel import FlatBilinear, abt_terms, ata_terms, atb_terms, \
    matmul_terms
from .kernels import PairBucketPlan
from .ops import BundleOps
from .segsum import SegScatter, SegSum
from .smallblas import chol3x3, inv3x3

#: Cholesky jitter ladder for the f32 scaled camera system: the first
#: rung sits just above the f32 assembly-error floor; the next ones are
#: tried only when the factorization breaks down.
JITTER_RUNGS = (3e-6, 1e-4, 1e-3, 1e-2)


def _build_pairs(obs_pt: np.ndarray):
    """Strict observation pairs (i1 before i2) within each point's
    observation list. Returns (i1, i2); total = sum_j k_j(k_j-1)/2."""
    order = np.argsort(obs_pt, kind="stable")
    sorted_pt = obs_pt[order]
    starts = np.flatnonzero(np.diff(sorted_pt, prepend=-1))
    counts = np.diff(np.append(starts, len(obs_pt)))

    # Element at within-group offset w pairs with the w earlier ones.
    pos = np.arange(len(obs_pt))
    grp = np.repeat(np.arange(len(counts)), counts)
    w = pos - starts[grp]
    i2s = np.repeat(pos, w)
    off = np.arange(int(w.sum())) - np.repeat(np.cumsum(w) - w, w)
    i1s = starts[grp[i2s]] + off
    return order[i1s], order[i2s]


class SchurOps(BundleOps):
    """BundleOps with a Schur-complement normal backend.

    refine_iters: iterative-refinement steps of the f32 reduced solve."""

    def __init__(self, project, spec, dtype=torch.float64, device=None,
                 refine_iters: int = 2):
        super().__init__(project, spec, dtype=dtype, device=device)
        dev = self.device
        self.refine_iters = refine_iters
        self.n_c = nc = spec.n_io + spec.n_eo
        # Active camera-block columns: IO parameters estimated in at
        # least one image plus all six EO parameters.
        NC = project.NC
        io_active = np.flatnonzero(np.asarray(project.est_io).any(axis=0))
        cam_active = np.concatenate([io_active, NC + np.arange(6)])
        self.n_cb = nb = len(cam_active)
        self._has_active_io = len(io_active) > 0
        if not self._has_active_io:
            from ..models.residuals import make_obs_jacobian_fn

            self._jac_eo_op_fn = make_obs_jacobian_fn(
                self.model, self.nK, self.nP, with_io=False)
        self.cam_active = torch.as_tensor(cam_active, device=dev)
        self.op_xidx = torch.as_tensor(np.asarray(spec.op_x, np.int64),
                                       device=dev)  # (n_op,3)
        self.op_mask = (self.op_xidx >= 0).to(self.dtype)
        self.n_pt = project.n_op

        # Prior split: io/eo priors have x < n_c; op priors x >= n_c.
        pr_x = self.prior_x_np
        cam_sel = np.flatnonzero(pr_x < nc)
        op_sel = np.flatnonzero(pr_x >= nc)
        self.cam_prior_sel = torch.as_tensor(cam_sel, device=dev)
        self.cam_prior_x = torch.as_tensor(pr_x[cam_sel], device=dev)
        self.op_prior_sel = torch.as_tensor(op_sel, device=dev)
        op_x = np.asarray(spec.op_x)
        inv = np.full(spec.n_x + 1, -1, dtype=np.int64)
        flat = op_x.reshape(-1)
        valid = flat >= 0
        inv[flat[valid]] = np.arange(flat.size)[valid]
        op_pr_flat = inv[pr_x[op_sel]]
        self.op_prior_pt = torch.as_tensor(op_pr_flat // 3, device=dev)
        self.op_prior_coord = torch.as_tensor(op_pr_flat % 3, device=dev)

        # Observation pairs for the S fill-in, sorted and grouped by
        # camera pair (img(i1), img(i2)).
        i1, i2 = _build_pairs(np.asarray(project.obs_pt))
        self.n_pairs = len(i1)
        obs_img_np = np.asarray(project.obs_img, dtype=np.int64)
        key = obs_img_np[i1] * project.n_img + obs_img_np[i2]
        order = np.argsort(key, kind="stable")
        i1, i2, key = i1[order], i2[order], key[order]
        ukey, cp_of_pair = np.unique(key, return_inverse=True)
        self.n_campair = len(ukey)
        self._pair_plan = PairBucketPlan(
            i1, i2, cp_of_pair.reshape(-1), self.n_campair, self.n_obs,
            device=dev, nb=nb, dtype=self.dtype) if self.n_pairs else None

        d_y = nb * 3
        self._fb_u = FlatBilinear(2 * nb, 2 * nb, ata_terms(2, nb), nb * nb)
        self._fb_v = FlatBilinear(6, 6, ata_terms(2, 3), 9)
        self._fb_w = FlatBilinear(2 * nb, 6, atb_terms(2, nb, 3), d_y)
        self._fb_y = FlatBilinear(d_y, 9, matmul_terms(nb, 3, 3), d_y)
        self._fb_pair = FlatBilinear(d_y, d_y, abt_terms(nb, 3, nb), nb * nb)

        self._seg_pt = SegSum(np.asarray(project.obs_pt), self.n_pt,
                              device=dev)
        self._seg_img = SegSum(np.asarray(project.obs_img), project.n_img,
                               device=dev)

        # Camera columns per image: x indices of the active [IO, EO]
        # columns, with fixed ones sent to the dump column nc.
        img_cols = np.concatenate(
            [np.asarray(spec.io_x), np.asarray(spec.eo_x)], axis=1
        ).astype(np.int64)[:, cam_active]
        icols = np.where(img_cols >= 0, img_cols, nc)
        self.icols = torch.as_tensor(icols, device=dev)  # (n_img, nb)
        # Scatter plans (SegScatter: each target written once, its
        # sources summed in a fixed order): per-image camera entries
        # into (nc+1,); per-image blocks into the flat (nc+1)^2 U; and
        # for S the per-image blocks, the camera-pair fill-in blocks and
        # their transposes, read from [Dimg; acc] in one plan.
        n1 = nc + 1
        self._cam_scatter = SegScatter(icols, device=dev)
        img_blk = (icols[:, :, None] * n1 + icols[:, None, :]).reshape(-1)
        self._u_scatter = SegScatter(img_blk, device=dev)
        c1 = icols[ukey // project.n_img]
        c2 = icols[ukey % project.n_img]
        cp_blk = (c1[:, :, None] * n1 + c2[:, None, :]).reshape(-1)
        cp_blk_t = (c2[:, None, :] * n1 + c1[:, :, None]).reshape(-1)
        n_img_blk = img_blk.size
        acc_src = n_img_blk + np.arange(cp_blk.size)
        self._s_scatter = SegScatter(
            np.concatenate([img_blk, cp_blk, cp_blk_t]),
            src=np.concatenate([np.arange(n_img_blk), acc_src, acc_src]),
            n_src=n_img_blk + cp_blk.size, device=dev)
        self._diag_idx = torch.arange(nc, device=dev) * (n1 + 1)
        #: host syncs made by the f32 jitter ladder (one per rung tried)
        self.host_syncs = 0

    # ------------------------------------------------------------------
    def _gather_pt(self, rows):
        """Expand (n_pt, d) rows to (n_obs, d) by obs_pt."""
        return rows[self.obs_pt]

    def _scatter_cam(self, vec_img):
        """(n_img, nb) per-image camera entries -> (nc,) by icols."""
        out = torch.zeros(self.n_c + 1, dtype=self.dtype, device=self.device)
        self._cam_scatter.add_into(out, vec_img.reshape(-1))
        return out[: self.n_c]

    # ------------------------------------------------------------------
    # x layout <-> (camera, padded point) split
    # ------------------------------------------------------------------
    def split_x(self, v):
        vc = v[: self.n_c]
        P = torch.where(self.op_xidx >= 0, v[self.op_xidx.clamp(min=0)],
                        torch.zeros((), dtype=v.dtype, device=v.device))
        return vc, P

    def join_x(self, vc, P):
        mask = self.op_xidx >= 0
        flat_idx = torch.where(mask, self.op_xidx, self.n_x).reshape(-1)
        v = torch.zeros(self.n_x + 1, dtype=self.dtype, device=self.device)
        v[flat_idx] = P.reshape(-1)
        v = v[: self.n_x]
        v[: self.n_c] = vc
        return v

    # ------------------------------------------------------------------
    # Assembly
    # ------------------------------------------------------------------
    def _assemble_impl(self, x):
        """(U, V, Wb, gc, gp, rw) of the Gauss-Newton system at x."""
        io, eo, op = self.params_of_x(x)
        op_obs = self._gather_pt(op)
        w = self.w_ip.unsqueeze(-1)
        if self._has_active_io:
            v, jio, jeo, jop = self._jac_fn(
                io[self.obs_img], eo[self.obs_img], op_obs,
                self.ip_px, self.px_obs)
            A = torch.cat([jio, jeo], 2)[:, :, self.cam_active] * w
        else:
            v, jeo, jop = self._jac_eo_op_fn(
                io[self.obs_img], eo[self.obs_img], op_obs,
                self.ip_px, self.px_obs)
            A = jeo * w
        # Fixed point coordinates masked out of B.
        B = jop * w * self._gather_pt(self.op_mask).unsqueeze(1)
        vw = v * self.w_ip

        nc, nb = self.n_c, self.n_cb
        n = A.shape[0]
        Af = A.reshape(n, 2 * nb)
        Bf = B.reshape(n, 6)

        # Per-image payload: U blocks + camera gradient; per-point
        # payload: V blocks + point gradient.
        gA = torch.einsum("nka,nk->na", A, vw)
        img_red = self._seg_img(torch.cat([self._fb_u(Af, Af), gA], 1))
        U = torch.zeros((nc + 1) ** 2, dtype=self.dtype, device=self.device)
        self._u_scatter.add_into(U, img_red[:, : nb * nb].reshape(-1))
        U = U.view(nc + 1, nc + 1)[:nc, :nc]
        gc = self._scatter_cam(img_red[:, nb * nb:])

        gB = torch.einsum("nka,nk->na", B, vw)
        pt_red = self._seg_pt(torch.cat([self._fb_v(Bf, Bf), gB], 1))
        V = pt_red[:, :9].reshape(-1, 3, 3)
        gp = pt_red[:, 9:]

        # W: per-observation camera-point cross blocks.
        Wb = self._fb_w(Af, Bf).reshape(n, nb, 3)

        # Priors.  Each x index has at most one prior observation (only
        # a parameter's leading entry carries it, core/serial.py), so
        # these accumulating writes have unique targets.
        r_pr = (x[self.prior_x] - self.prior_val) * self.prior_w
        if self.cam_prior_x.shape[0]:
            w_c = self.prior_w[self.cam_prior_sel]
            U.index_put_((self.cam_prior_x, self.cam_prior_x), w_c ** 2,
                         accumulate=True)
            gc.index_put_((self.cam_prior_x,),
                          w_c * r_pr[self.cam_prior_sel], accumulate=True)
        if self.op_prior_sel.shape[0]:
            w_o = self.prior_w[self.op_prior_sel]
            V.index_put_((self.op_prior_pt, self.op_prior_coord,
                          self.op_prior_coord), w_o ** 2, accumulate=True)
            gp.index_put_((self.op_prior_pt, self.op_prior_coord),
                          w_o * r_pr[self.op_prior_sel], accumulate=True)

        # Fixed coordinates: identity diagonal so 3x3 inverses exist.
        m = self.op_mask
        eye3 = torch.eye(3, dtype=self.dtype, device=self.device)
        V = V * m[:, :, None] * m[:, None, :] + eye3 * (1.0 - m)[:, :, None]
        gp = gp * m

        rw = torch.cat([vw.reshape(-1), r_pr])
        return U, V, Wb, gc, gp, rw

    # ------------------------------------------------------------------
    def _schur_S(self, U, Vinv, Wb, lam):
        """S = U + lam I - sum_pairs W_i1 Vinv_j W_i2'.

        Vinv_j = L_j L_j' (closed-form 3x3 Cholesky), Y_i = W_i L_j per
        observation.  Diagonal terms Y_i Y_i' aggregate per image; the
        strict pairs (i1 before i2) are summed per camera pair by
        kernel B and scattered into S twice, as the block and its
        transpose."""
        nc, nb = self.n_c, self.n_cb
        n1 = nc + 1
        Lvf = chol3x3(Vinv).reshape(-1, 9)
        Wf = Wb.reshape(-1, nb * 3)
        Yf = self._fb_y(Wf, self._gather_pt(Lvf))  # (n_obs, nb*3)

        Df = self._fb_pair(Yf, Yf)  # (n_obs, nb*nb)
        Dimg = self._seg_img(Df)

        S = torch.zeros(n1 * n1, dtype=self.dtype, device=self.device)
        S.view(n1, n1)[:nc, :nc] = U
        S[self._diag_idx] += lam
        parts = [Dimg.reshape(-1)]
        if self._pair_plan is not None:
            parts.append(self._pair_plan(Yf, self._fb_pair).reshape(-1))
        self._s_scatter.add_into(S, torch.cat(parts), alpha=-1.0)
        return S.view(n1, n1)[:nc, :nc]

    def _reduce_rhs(self, Vinv, Wb, rc, rp):
        """rc_tilde = rc - sum_i W_i (Vinv rp)_pt(i), per-image sums."""
        Vg = self._gather_pt(Vinv.reshape(-1, 9)).reshape(-1, 3, 3)
        t = torch.einsum("nab,nb->na", Vg, self._gather_pt(rp))
        contrib = torch.einsum("nab,nb->na", Wb, t)  # (n_obs, n_cb)
        return rc - self._scatter_cam(self._seg_img(contrib))

    def _cam_cols_per_obs(self, pc):
        """Per-observation camera-block entries of a camera vector pc."""
        pc_pad = torch.cat([pc, torch.zeros(1, dtype=pc.dtype,
                                            device=pc.device)])
        return pc_pad[self.icols][self.obs_img]

    def _backsub(self, Vinv, Wb, rp, pc):
        """pp = Vinv (rp - W' pc): batched 3x3 point back-substitution."""
        pcg = self._cam_cols_per_obs(pc)  # (n_obs, n_cb)
        down = torch.einsum("nab,na->nb", Wb, pcg)  # (n_obs, 3)
        rp_t = rp - self._seg_pt(down)
        return torch.einsum("nab,nb->na", Vinv, rp_t) * self.op_mask

    def _solve_impl(self, U, V, Wb, rhs, lam):
        """Solve N p = rhs (+ lam on the diagonal) via S.  Returns
        (p, L): L is the scaled Cholesky factor, all NaN when every
        jitter rung (f32) or the plain factorization (f64) failed."""
        nc = self.n_c
        rc, rp = self.split_x(rhs)
        eye3 = torch.eye(3, dtype=self.dtype, device=self.device)
        eyel = lam * eye3 * self.op_mask[:, :, None]
        f32 = self.dtype == torch.float32
        if f32:
            # Trace-relative floor on the point blocks: a degenerate
            # 2-ray point has cond(V) beyond f32, and the closed-form
            # inverse then loses definiteness at roundoff, which turns
            # chol3x3(Vinv) in _schur_S into NaN.
            tr = V[:, 0, 0] + V[:, 1, 1] + V[:, 2, 2]
            eyel = eyel + (1e-5 * tr)[:, None, None] * eye3 \
                * self.op_mask[:, :, None]
        Vinv = inv3x3(V + eyel)

        S = self._schur_S(U, Vinv, Wb, lam)
        rc_t = self._reduce_rhs(Vinv, Wb, rc, rp)

        # Jacobi-scaled Cholesky.  The scale is clamped to a relative
        # fraction of the largest diagonal: f32 cancellation can push a
        # weak column's diagonal to <= 0.
        diag = torch.diagonal(S)
        d = torch.sqrt(torch.maximum(diag, 1e-12 * diag.max()))
        d = torch.where(d > 0, d, torch.ones_like(d))
        Dinv = 1.0 / d
        Ss = S * Dinv[:, None] * Dinv[None, :]
        if f32:
            # The f32 S carries roundoff and can be indefinite at that
            # level: factor with the smallest jitter rung that succeeds;
            # refinement against the unjittered Ss recovers accuracy.
            eye = torch.eye(nc, dtype=self.dtype, device=self.device)
            for rung in JITTER_RUNGS:
                L, info = torch.linalg.cholesky_ex(Ss + rung * eye)
                self.host_syncs += 1
                if not bool((info != 0) | torch.isnan(L).any()):
                    break
            else:
                L = torch.full_like(Ss, float("nan"))
        else:
            L, info = torch.linalg.cholesky_ex(Ss)
            L = torch.where(info == 0, L, torch.full_like(L, float("nan")))

        def tri_solve(b):
            y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
            return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]

        b = Dinv * rc_t
        q = tri_solve(b)
        if f32:
            for _ in range(self.refine_iters):
                q = q + tri_solve(b - Ss @ q)
        pc = Dinv * q
        pp = self._backsub(Vinv, Wb, rp, pc)
        return self.join_x(pc, pp), L

    def _solve_pcg_impl(self, U, V, Wb, rhs, lam, tol=1e-10, maxiter=500):
        """Matrix-free PCG camera solve + point back-substitution
        (pcg.py): S is never formed.  Returns (p, (iterations,
        rel_residual))."""
        from .pcg import pcg_solve

        rc, rp = self.split_x(rhs)
        eye3 = torch.eye(3, dtype=self.dtype, device=self.device)
        Vinv = inv3x3(V + lam * eye3 * self.op_mask[:, :, None])
        rc_t = self._reduce_rhs(Vinv, Wb, rc, rp)
        pc, iters, rel = pcg_solve(self, U, Vinv, Wb, rc_t, lam,
                                   tol=tol, maxiter=maxiter)
        pp = self._backsub(Vinv, Wb, rp, pc)
        return self.join_x(pc, pp), (iters, rel)

    def _matvec_impl(self, U, V, Wb, p):
        """N p without forming N."""
        pc, P = self.split_x(p)
        pcg = self._cam_cols_per_obs(pc)
        yc = U @ pc
        up = torch.einsum("nab,nb->na", Wb, self._gather_pt(P))
        yc = yc + self._scatter_cam(self._seg_img(up))
        yp = torch.einsum("jab,jb->ja", V, P)
        yp = yp + self._seg_pt(torch.einsum("nab,na->nb", Wb, pcg))
        yp = yp * self.op_mask
        return self.join_x(yc, yp)

    # ------------------------------------------------------------------
    def normal(self, x):
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        return SchurNormalState(self, *self._assemble_impl(x))


class SchurNormalState:
    """Normal-equation state of the Schur backend (see normal_state.py):
    the assembled U, V, W blocks and gradients at one x."""

    def __init__(self, ops: SchurOps, U, V, Wb, gc, gp, rw):
        self.ops = ops
        self.U, self.V, self.Wb = U, V, Wb
        self.gc, self.gp = gc, gp
        self.rw = rw
        self.g = ops.join_x(gc, gp)
        self.n_x = ops.n_x

    def _diag_parts(self):
        dV = torch.diagonal(self.V, dim1=-2, dim2=-1) * self.ops.op_mask
        return torch.diagonal(self.U), dV

    def diag(self):
        dU, dV = self._diag_parts()
        return self.ops.join_x(dU, dV)

    def trace_diag(self):
        dU, dV = self._diag_parts()
        return float(dU.sum() + dV.sum())

    def matvec(self, p):
        return self.ops._matvec_impl(self.U, self.V, self.Wb, p)

    def solve(self, rhs, lam: float = 0.0):
        sol, L = self.ops._solve_impl(self.U, self.V, self.Wb, rhs, lam)
        return sol, bool(torch.isnan(L).any())
