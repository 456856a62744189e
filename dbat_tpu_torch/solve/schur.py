"""Schur-complement reduced camera system (counterpart of
dbat_tpu/solve/schur.py).

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

Every per-observation step is a method of an observation set `ob`
(`_obs_*`): on one device the ops themselves, on the JAX package's
legacy mesh path (`SchurOps(mesh=, pair_chunk=)`, which builds a
parallel/obs_mesh.py ObsMeshSchurOps) each shard's slice of the
observations; `_obs_sum` adds a step's per-image or per-point sums
over the sets.

The JAX package has two more plans on one device: the packed per-point
fill-in for uniform ray counts (`_packed_R`, kernel A on each point's
packed Y rows, then a SegSum over camera pairs) and the `_img_block6`
windowed scatter for fixed IO.  This port takes the general path on
every network: it gives the same numbers, and on the H100 the packed
fill-in is the slower one (ROADMAP.md §2, follow-up 6).
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


def camera_plans(spec, cam_active, ukey, n_img: int, device):
    """The camera-side plans of the Schur backends (this module and
    parallel/sharded.py).

    icols (n_img, nb): x indices of each image's active [IO, EO]
    columns, fixed ones sent to the dump column nc.  Scatter plans
    (SegScatter: each target written once, its sources summed in a
    fixed order): per-image camera entries into (nc+1,); per-image
    blocks into the flat (nc+1)^2 U; and for S the per-image blocks,
    the blocks of the camera pairs `ukey` (img1 * n_img + img2) and
    their transposes, read from [Dimg; acc] in one plan.  Returns
    (icols tensor, camera scatter, U scatter, S scatter)."""
    nc = spec.n_io + spec.n_eo
    n1 = nc + 1
    img_cols = np.concatenate(
        [np.asarray(spec.io_x), np.asarray(spec.eo_x)], axis=1
    ).astype(np.int64)[:, cam_active]
    icols = np.where(img_cols >= 0, img_cols, nc)
    img_blk = (icols[:, :, None] * n1 + icols[:, None, :]).reshape(-1)
    c1, c2 = icols[ukey // n_img], icols[ukey % n_img]
    cp_blk = (c1[:, :, None] * n1 + c2[:, None, :]).reshape(-1)
    cp_blk_t = (c2[:, None, :] * n1 + c1[:, :, None]).reshape(-1)
    acc_src = img_blk.size + np.arange(cp_blk.size)
    s_scatter = SegScatter(
        np.concatenate([img_blk, cp_blk, cp_blk_t]),
        src=np.concatenate([np.arange(img_blk.size), acc_src, acc_src]),
        n_src=img_blk.size + cp_blk.size, device=device)
    return (torch.as_tensor(icols, device=device),
            SegScatter(icols, device=device),
            SegScatter(img_blk, device=device), s_scatter)


class SchurOps(BundleOps):
    """BundleOps with a Schur-complement normal backend.

    refine_iters: iterative-refinement steps of the f32 reduced solve.
    mesh, pair_chunk: with a mesh, `SchurOps(...)` builds the legacy
    mesh path's ObsMeshSchurOps (parallel/obs_mesh.py, see __new__);
    unused on one device."""

    #: the mesh of the legacy mesh path; None on one device
    mesh = None

    def __new__(cls, *args, mesh=None, **kwargs):
        if mesh is not None and cls is SchurOps:
            from ..parallel.obs_mesh import ObsMeshSchurOps

            cls = ObsMeshSchurOps
        return super().__new__(cls)

    def __init__(self, project, spec, dtype=torch.float64, device=None,
                 refine_iters: int = 2, mesh=None, pair_chunk: int = 32768):
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

        d_y = nb * 3
        self._fb_u = FlatBilinear(2 * nb, 2 * nb, ata_terms(2, nb), nb * nb)
        self._fb_v = FlatBilinear(6, 6, ata_terms(2, 3), 9)
        self._fb_w = FlatBilinear(2 * nb, 6, atb_terms(2, nb, 3), d_y)
        self._fb_y = FlatBilinear(d_y, 9, matmul_terms(nb, 3, 3), d_y)
        self._fb_pair = FlatBilinear(d_y, d_y, abt_terms(nb, 3, nb), nb * nb)

        self._obs_plans(project, i1, i2, cp_of_pair.reshape(-1))
        self.icols, self._cam_scatter, self._u_scatter, self._s_scatter = \
            camera_plans(spec, cam_active, ukey, project.n_img, dev)
        self._diag_idx = torch.arange(nc, device=dev) * (nc + 2)
        #: host syncs made by the f32 jitter ladder (one per rung tried)
        self.host_syncs = 0

    def _obs_plans(self, project, i1, i2, cp):
        """The per-observation plans: the point and image SegSums, and
        kernel B's plan of the observation pairs (i1, i2) with camera
        pairs cp."""
        dev = self.device
        self._pair_plan = PairBucketPlan(
            i1, i2, cp, self.n_campair, self.n_obs, device=dev,
            nb=self.n_cb, dtype=self.dtype) if self.n_pairs else None
        self._seg_pt = SegSum(np.asarray(project.obs_pt), self.n_pt,
                              device=dev)
        self._seg_img = SegSum(np.asarray(project.obs_img), project.n_img,
                               device=dev)

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
    def _obs_sum(self, fn, Wb, *args):
        """fn(ob, Wb, *args): one per-observation step's per-image or
        per-point sums over the observation set ob, here the ops
        themselves (the mesh path adds them over its shards)."""
        return fn(self, Wb, *args)

    def _obs_normal(self, ob, io, eo, op, op_mask):
        """Over ob's observations: per-image sums of the U blocks and
        the camera gradient, per-point sums of the V blocks and the point
        gradient, the W blocks and the weighted residuals."""
        op_obs = op[ob.obs_pt]
        w = ob.w_ip.unsqueeze(-1)
        if self._has_active_io:
            v, jio, jeo, jop = self._jac_fn(
                io[ob.obs_img], eo[ob.obs_img], op_obs,
                ob.ip_px, ob.px_obs)
            A = torch.cat([jio, jeo], 2)[:, :, ob.cam_active] * w
        else:
            v, jeo, jop = self._jac_eo_op_fn(
                io[ob.obs_img], eo[ob.obs_img], op_obs,
                ob.ip_px, ob.px_obs)
            A = jeo * w
        # Fixed point coordinates masked out of B.
        B = jop * w * op_mask[ob.obs_pt].unsqueeze(1)
        vw = v * ob.w_ip

        nb = self.n_cb
        n = A.shape[0]
        Af = A.reshape(n, 2 * nb)
        Bf = B.reshape(n, 6)
        gA = torch.einsum("nka,nk->na", A, vw)
        img_red = ob._seg_img(torch.cat([self._fb_u(Af, Af), gA], 1))
        gB = torch.einsum("nka,nk->na", B, vw)
        pt_red = ob._seg_pt(torch.cat([self._fb_v(Bf, Bf), gB], 1))
        # W: per-observation camera-point cross blocks.
        Wb = self._fb_w(Af, Bf).reshape(n, nb, 3)
        return img_red, pt_red, Wb, vw

    def _assemble_impl(self, x):
        """(U, V, Wb, gc, gp, rw) of the Gauss-Newton system at x."""
        io, eo, op = self.params_of_x(x)
        img_red, pt_red, Wb, vw = self._obs_normal(self, io, eo, op,
                                                   self.op_mask)
        return self._normal_system(x, img_red, pt_red, Wb, vw.reshape(-1))

    def _normal_system(self, x, img_red, pt_red, Wb, vw):
        """(U, V, Wb, gc, gp, rw) from the observations' per-image sums
        img_red (U blocks, camera gradient), per-point sums pt_red (V
        blocks, point gradient) and weighted residuals vw: the camera
        scatters, the priors and the fixed point coordinates."""
        nc, nb = self.n_c, self.n_cb
        U = torch.zeros((nc + 1) ** 2, dtype=self.dtype, device=self.device)
        self._u_scatter.add_into(U, img_red[:, : nb * nb].reshape(-1))
        U = U.view(nc + 1, nc + 1)[:nc, :nc]
        gc = self._scatter_cam(img_red[:, nb * nb:])
        V = pt_red[:, :9].reshape(-1, 3, 3)
        gp = pt_red[:, 9:]

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

        rw = torch.cat([vw, r_pr])
        return U, V, Wb, gc, gp, rw

    # ------------------------------------------------------------------
    def _schur_S(self, U, Vinv, Wb, lam):
        """S = U + lam I - sum_pairs W_i1 Vinv_j W_i2'.

        Vinv_j = L_j L_j' (closed-form 3x3 Cholesky), Y_i = W_i L_j per
        observation.  Diagonal terms Y_i Y_i' aggregate per image; the
        strict pairs (i1 before i2) are summed per camera pair and
        scattered into S twice, as the block and its transpose."""
        nc = self.n_c
        n1 = nc + 1
        Lvf = chol3x3(Vinv).reshape(-1, 9)
        fill = self._fill_in(Lvf, Wb)
        S = torch.zeros(n1 * n1, dtype=self.dtype, device=self.device)
        S.view(n1, n1)[:nc, :nc] = U
        S[self._diag_idx] += lam
        self._s_scatter.add_into(S, fill, alpha=-1.0)
        return S.view(n1, n1)[:nc, :nc]

    def _obs_Y(self, ob, Wb, Lvf):
        """Y_i = W_i L_pt(i) (flat) over ob's observations, and their
        per-image sums of Y_i Y_i'."""
        Yf = self._fb_y(Wb.reshape(-1, self.n_cb * 3), Lvf[ob.obs_pt])
        return Yf, ob._seg_img(self._fb_pair(Yf, Yf))

    def _fill_in(self, Lvf, Wb):
        """[per-image Y Y' sums; per-camera-pair sums of Y_i1 Y_i2'],
        flat, as _s_scatter reads them; the pair sums by kernel B."""
        Yf, Dimg = self._obs_Y(self, Wb, Lvf)
        parts = [Dimg.reshape(-1)]
        if self._pair_plan is not None:
            parts.append(self._pair_plan(Yf, self._fb_pair).reshape(-1))
        return torch.cat(parts)

    def _obs_rhs(self, ob, Wb, Vinv, rp):
        """Per-image sums of W_i (Vinv rp)_pt(i) over ob's observations."""
        Vg = Vinv.reshape(-1, 9)[ob.obs_pt].reshape(-1, 3, 3)
        t = torch.einsum("nab,nb->na", Vg, rp[ob.obs_pt])
        return ob._seg_img(torch.einsum("nab,nb->na", Wb, t))

    def _obs_up(self, ob, Wb, P):
        """Per-image sums of W_i P_pt(i) over ob's observations."""
        return ob._seg_img(torch.einsum("nab,nb->na", Wb, P[ob.obs_pt]))

    def _obs_down(self, ob, Wb, pcc):
        """Per-point sums of W_i' pc over ob's observations; pcc: each
        image's camera-block entries of pc (_pc_cols)."""
        return ob._seg_pt(torch.einsum("nab,na->nb", Wb, pcc[ob.obs_img]))

    def _pc_cols(self, pc):
        """(n_img, n_cb) camera-block entries of a camera vector pc."""
        pc_pad = torch.cat([pc, torch.zeros(1, dtype=pc.dtype,
                                            device=pc.device)])
        return pc_pad[self.icols]

    def _reduce_rhs(self, Vinv, Wb, rc, rp):
        """rc_tilde = rc - sum_i W_i (Vinv rp)_pt(i), per-image sums."""
        return rc - self._scatter_cam(self._obs_sum(self._obs_rhs, Wb,
                                                    Vinv, rp))

    def _backsub(self, Vinv, Wb, rp, pc):
        """pp = Vinv (rp - W' pc): batched 3x3 point back-substitution."""
        rp_t = rp - self._obs_sum(self._obs_down, Wb, self._pc_cols(pc))
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
        yc = U @ pc
        yc = yc + self._scatter_cam(self._obs_sum(self._obs_up, Wb, P))
        yp = torch.einsum("jab,jb->ja", V, P)
        yp = yp + self._obs_sum(self._obs_down, Wb, self._pc_cols(pc))
        yp = yp * self.op_mask
        return self.join_x(yc, yp)

    def _diag_parts(self, U, V):
        return torch.diagonal(U), \
            torch.diagonal(V, dim1=-2, dim2=-1) * self.op_mask

    def _diag(self, U, V):
        """diag(N) as an x vector."""
        return self.join_x(*self._diag_parts(U, V))

    def _trace_diag(self, U, V) -> float:
        """trace(N) (the LM lambda scale); one host read."""
        dU, dV = self._diag_parts(U, V)
        return float(dU.sum() + dV.sum())

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

    def diag(self):
        return self.ops._diag(self.U, self.V)

    def trace_diag(self):
        return self.ops._trace_diag(self.U, self.V)

    def matvec(self, p):
        return self.ops._matvec_impl(self.U, self.V, self.Wb, p)

    def solve(self, rhs, lam: float = 0.0):
        sol, L = self.ops._solve_impl(self.U, self.V, self.Wb, rhs, lam)
        return sol, bool(torch.isnan(L).any())
