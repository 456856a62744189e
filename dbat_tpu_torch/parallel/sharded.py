"""Point-partitioned sharded Schur backend (counterpart of
dbat_tpu/parallel/sharded.py).

Object points, and with them their observations, are cut into
contiguous shards over a 1-D mesh (parallel/mesh.py), so that

  * every per-point quantity (V blocks, point gradient, 3x3 back-
    substitution, the pair products of the S fill-in) is computed on the
    shard's device with no communication, through the same SegSum plans
    and kernels as the single-device path (kernel A for every block
    product, kernel B for each shard's own observation pairs); and
  * the small replicated camera system (U, the reduced S, the camera
    gradient) is formed from per-shard partial sums that the mesh adds
    in global shard order (Mesh.sum_shards, the JAX package's psum).
    The S fill-in is summed over the shards per camera pair (a table of
    every shard's camera pairs) and scattered into S once, as on one
    device; the JAX package scatters each shard's blocks into a full
    partial S and psums those.

The JAX package runs each shard under `jax.shard_map`; here a Python
loop over the shards this process owns runs each shard's work on its
device, and the loop ends in a shard sum.

Partitioning happens once on the host (numpy), as in the JAX package:
the cut balances observations, shards are padded to a common size
(S_obs observations, S_pt points), and padded observations carry image
0, local point 0 and weight 0, outside every segment plan, so they add
exactly nothing.  Per-point results are lists with one (S_pt, ...)
tensor per owned shard, per-observation results one (S_obs, ...)
tensor per shard; x vectors and the camera system are whole tensors on
the mesh's reducing device.  Camera pairs are not padded: each shard's
kernel-B plan holds its own pairs only and writes them to their rows of
the camera-pair table, so the JAX package's dump row of `img_cols` has
no counterpart here.

The reduced solve is the JAX package's sharded one, not SchurOps's: a
fixed Cholesky jitter (1e-3 of the scaled diagonal in f32, none in
f64), no jitter ladder, two refinement steps in f32 and one in f64.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..solve.flatsel import FlatBilinear, abt_terms, ata_terms, atb_terms, \
    matmul_terms
from ..solve.kernels import PairBucketPlan
from ..solve.ops import BundleOps
from ..solve.schur import SchurOps, _build_pairs, camera_plans
from ..solve.segsum import SegSum
from ..solve.smallblas import chol3x3, inv3x3


def _pad(a, value, width: int):
    """Host array a padded along its leading axis to `width` rows."""
    a = np.asarray(a)
    return np.pad(a, [(0, width - len(a))] + [(0, 0)] * (a.ndim - 1),
                  constant_values=value)


def point_partition(obs_pt, n_pt: int, n_sh: int):
    """Contiguous point shards that balance observations.

    Returns (order, pt_cut, obs_cut): the stable point-sorted
    observation order, and the (n_sh+1,) point and sorted-observation
    offsets of the shards."""
    obs_pt = np.asarray(obs_pt)
    order = np.argsort(obs_pt, kind="stable")
    counts = np.bincount(obs_pt, minlength=n_pt)
    cum = np.concatenate([[0], np.cumsum(counts)])
    targets = (np.arange(1, n_sh) * len(obs_pt)) / n_sh
    pt_cut = np.concatenate([[0], np.searchsorted(cum, targets), [n_pt]])
    return order, pt_cut, cum[pt_cut]


class ShardedSchurOps(BundleOps):
    """Schur reduced-camera backend over a Mesh.

    The API of solve.schur.SchurOps that the host solvers (`normal(x)`)
    and the device loops of fused.py (`_assemble_impl`, `_solve_impl`,
    `_matvec_impl`, `join_x`, `weighted_residual`) use.  The point axis
    is padded to n_sh * S_pt rows; split_x/join_x translate between the
    global x vector and the padded per-shard point rows, and the
    residual vectors carry n_sh * S_obs padded observation rows
    (unshard_obs_rows takes them back to the project's order)."""

    def __init__(self, project, spec, mesh, dtype=torch.float64,
                 cap: int = 64, device=None):
        super().__init__(project, spec, dtype=dtype,
                         device=mesh.resolve(device))
        self.mesh = mesh
        self._project = project
        self._cov_ops = None
        self.host_syncs = 0  # the solve has no jitter ladder
        n_sh = self.n_sh = mesh.n_shards
        p = project
        nc = self.n_c = spec.n_io + spec.n_eo
        self.n_pt = p.n_op
        n_img = p.n_img
        dt = self.dtype

        io_active = np.flatnonzero(np.asarray(p.est_io).any(axis=0))
        cam_active = np.concatenate([io_active, p.NC + np.arange(6)])
        nb = self.n_cb = len(cam_active)
        self._has_active_io = len(io_active) > 0
        if not self._has_active_io:
            from ..models.residuals import make_obs_jacobian_fn

            self._jac_eo_op_fn = make_obs_jacobian_fn(
                self.model, self.nK, self.nP, with_io=False)

        # Flat-lane block products (kernel A), shared by the shards.
        d_y = nb * 3
        self._fb_u = FlatBilinear(2 * nb, 2 * nb, ata_terms(2, nb), nb * nb)
        self._fb_v = FlatBilinear(6, 6, ata_terms(2, 3), 9)
        self._fb_w = FlatBilinear(2 * nb, 6, atb_terms(2, nb, 3), d_y)
        self._fb_y = FlatBilinear(d_y, 9, matmul_terms(nb, 3, 3), d_y)
        self._fb_pair = FlatBilinear(d_y, d_y, abt_terms(nb, 3, nb), nb * nb)

        # ---- Host partition: points -> contiguous shards. -------------
        order, pt_cut, obs_cut = point_partition(p.obs_pt, self.n_pt, n_sh)
        pt_start, pt_cnt = pt_cut[:-1], np.diff(pt_cut)
        self.S_pt = S_pt = max(int(pt_cnt.max()) if self.n_pt else 0, 1)
        self.S_obs = S_obs = max(int(np.diff(obs_cut).max())
                                 if self.n_obs else 0, 1)
        obs_pt_s = np.asarray(p.obs_pt)[order]
        obs_img_s = np.asarray(p.obs_img)[order]
        ip_px = np.asarray(p.ip_px, np.float64)[order]
        px_obs = np.asarray(p.sensor_px_size[:, 0], np.float64)[obs_img_s]
        w_ip = 1.0 / (np.asarray(p.ip_std_px, np.float64)[order]
                      * px_obs[:, None])

        # Priors: camera priors on the reducing device; OP priors routed
        # to the shard that owns their point.
        pr_x = self.prior_x_np
        cam_sel = np.flatnonzero(pr_x < nc)
        self.cam_prior_x = torch.as_tensor(pr_x[cam_sel], device=self.device)
        self.cam_prior_sel = torch.as_tensor(cam_sel, device=self.device)
        op_sel = np.flatnonzero(pr_x >= nc)
        op_x = np.asarray(spec.op_x, np.int64)
        inv = np.full(spec.n_x + 1, -1, np.int64)
        flat = op_x.reshape(-1)
        inv[flat[flat >= 0]] = np.flatnonzero(flat >= 0)
        op_pr_flat = inv[pr_x[op_sel]]
        op_pr_pt, op_pr_coord = op_pr_flat // 3, op_pr_flat % 3
        shard_of = np.searchsorted(pt_cut, op_pr_pt, side="right") - 1
        prior_val = self.prior_val.cpu().numpy()
        prior_w = self.prior_w.cpu().numpy()

        # Padded point-axis maps (n_sh, S_pt, 3); pads map nowhere.
        pad_map = np.full((n_sh, S_pt, 3), -1, np.int64)
        base_op = np.zeros((n_sh, S_pt, 3))
        for k in range(n_sh):
            c = slice(pt_start[k], pt_start[k] + pt_cnt[k])
            pad_map[k, :pt_cnt[k]] = op_x[c]
            base_op[k, :pt_cnt[k]] = np.asarray(p.op)[c]
        # join_x: x index of every estimated padded point coordinate.
        valid = pad_map.reshape(-1) >= 0
        self._join_src = torch.as_tensor(np.flatnonzero(valid),
                                         device=self.device)
        self._join_tgt = torch.as_tensor(pad_map.reshape(-1)[valid],
                                         device=self.device)

        def on(dev, a, dtype=None):
            t = torch.as_tensor(np.asarray(a), device=dev)
            return t if dtype is None else t.to(dtype)

        # ---- Strict observation pairs within each shard's points,
        # grouped by (global) camera pair (img(i1), img(i2)). ----------
        pairs = []
        for k in range(n_sh):
            a, b = obs_cut[k], obs_cut[k + 1]
            lpt, limg = obs_pt_s[a:b] - pt_start[k], obs_img_s[a:b]
            i1, i2 = _build_pairs(lpt)
            key = limg[i1].astype(np.int64) * n_img + limg[i2]
            ko = np.argsort(key, kind="stable")
            ukey, cp = np.unique(key[ko], return_inverse=True)
            pairs.append((i1[ko], i2[ko], ukey, cp.reshape(-1)))
        # Every shard's camera pairs: the camera-side plans of SchurOps
        # over their union, on the reducing device.
        ukey = np.unique(np.concatenate([q[2] for q in pairs]))
        self.n_campair = len(ukey)
        self.icols, self._cam_scatter, self._u_scatter, self._s_scatter = \
            camera_plans(spec, cam_active, ukey, n_img, self.device)
        self._diag_idx = torch.arange(nc, device=self.device) * (nc + 2)
        icols = self.icols.cpu().numpy()

        # ---- Per-shard constants and plans, on each owned shard's
        # device. ----------------------------------------------------
        self.shards = []
        for k in mesh.owned:
            dev = mesh.devices[k]
            a, b = obs_cut[k], obs_cut[k + 1]
            m = b - a
            lpt = obs_pt_s[a:b] - pt_start[k]
            limg = obs_img_s[a:b]
            src = np.arange(m)
            sh = SimpleNamespace(dev=dev)
            img_pad = _pad(limg, 0, S_obs)
            sh.img = on(dev, img_pad)
            sh.lpt = on(dev, _pad(lpt, 0, S_obs))
            sh.ip = on(dev, _pad(ip_px[a:b], 0.0, S_obs), dt)
            sh.w = on(dev, _pad(w_ip[a:b], 0.0, S_obs), dt)
            sh.px = on(dev, _pad(px_obs[a:b], 1.0, S_obs), dt)
            sh.obs_cols = on(dev, icols[img_pad])
            sh.seg_pt = SegSum(lpt, S_pt, cap, device=dev, src=src,
                               n_src=S_obs)
            sh.seg_img = SegSum(limg, n_img, cap, device=dev, src=src,
                                n_src=S_obs)
            # Kernel B's plan over the shard's own pairs (pad pairs index
            # S_obs, outside Y), and the rows of its camera pairs in the
            # global camera-pair table.
            i1, i2, cp_key, cp = pairs[k]
            sh.pair_plan = PairBucketPlan(
                i1, i2, cp, len(cp_key), S_obs, device=dev, nb=nb,
                dtype=dt) if len(i1) else None
            sh.cp_rows = on(dev, np.searchsorted(ukey, cp_key))
            sh.xidx = on(dev, pad_map[k])
            sh.mask = (sh.xidx >= 0).to(dt)
            sh.base_pad = on(dev, base_op[k], dt)
            mine = shard_of == k
            sh.pr_lpt = on(dev, op_pr_pt[mine] - pt_start[k])
            sh.pr_coord = on(dev, op_pr_coord[mine])
            sel = op_sel[mine]
            sh.pr_x = on(dev, pr_x[sel])
            sh.pr_val = on(dev, prior_val[sel], dt)
            sh.pr_w = on(dev, prior_w[sel], dt)
            sh.base_io, sh.base_eo = self.base_io.to(dev), \
                self.base_eo.to(dev)
            sh.io_x, sh.eo_x = (m_.to(dev) for m_ in self._x_maps[:2])
            sh.cam_active = torch.as_tensor(cam_active, device=dev)
            sh.eye3 = torch.eye(3, dtype=dt, device=dev)
            self.shards.append(sh)
        self.op_mask = [sh.mask for sh in self.shards]

        # Host bookkeeping for de-padding (bundle post-processing).
        self._obs_order = order
        self._obs_cut = obs_cut

    # ------------------------------------------------------------------
    def unshard_obs_rows(self, stacked):
        """(n_sh*S_obs, d) padded/sorted rows -> (n_obs, d) in the
        project's original observation order (host-side)."""
        stacked = np.asarray(stacked).reshape(self.n_sh, self.S_obs, -1)
        parts = [stacked[k, : self._obs_cut[k + 1] - self._obs_cut[k]]
                 for k in range(self.n_sh)]
        sorted_rows = np.concatenate(parts, axis=0)
        out = np.empty_like(sorted_rows)
        out[self._obs_order] = sorted_rows
        return out

    # x layout <-> (camera, padded point rows) -------------------------
    def split_x(self, v):
        """(v[:n_c], [(S_pt, 3) point rows of each owned shard])."""
        P = []
        for sh in self.shards:
            vk = v.to(sh.dev)
            P.append(torch.where(sh.xidx >= 0, vk[sh.xidx.clamp(min=0)],
                                 torch.zeros((), dtype=v.dtype,
                                             device=sh.dev)))
        return v[: self.n_c], P

    def join_x(self, vc, P):
        """The x vector of camera part vc and per-shard point rows P,
        on the reducing device (every shard's rows, all-gathered across
        processes)."""
        rows = torch.cat([r.reshape(-1) for r in self.mesh.gather_shards(P)])
        v = torch.zeros(self.n_x, dtype=self.dtype, device=self.device)
        v[self._join_tgt] = rows[self._join_src]
        v[: self.n_c] = vc
        return v

    # ------------------------------------------------------------------
    def _local_AB(self, sh, x):
        """The shard's weighted Jacobian blocks A (S_obs, 2, nb), B
        (S_obs, 2, 3) and weighted residuals (S_obs, 2) at x (on the
        shard's device)."""
        Xrows = torch.where(sh.xidx >= 0, x[sh.xidx.clamp(min=0)],
                            sh.base_pad)
        io = torch.where(sh.io_x >= 0, x[sh.io_x.clamp(min=0)], sh.base_io)
        eo = torch.where(sh.eo_x >= 0, x[sh.eo_x.clamp(min=0)], sh.base_eo)
        X = Xrows[sh.lpt]
        w = sh.w.unsqueeze(-1)
        if self._has_active_io:
            v, jio, jeo, jop = self._jac_fn(io[sh.img], eo[sh.img], X,
                                            sh.ip, sh.px)
            A = torch.cat([jio, jeo], 2)[:, :, sh.cam_active] * w
        else:
            v, jeo, jop = self._jac_eo_op_fn(io[sh.img], eo[sh.img], X,
                                             sh.ip, sh.px)
            A = jeo * w
        B = jop * w * sh.mask[sh.lpt].unsqueeze(1)
        return A, B, v * sh.w

    # The camera-side steps are SchurOps's.
    _scatter_cam = SchurOps._scatter_cam
    _diag = SchurOps._diag
    normal = SchurOps.normal

    # ------------------------------------------------------------------
    def _assemble_impl(self, x):
        """(U, V, Wb, gc, gp, rw) at x: U, gc and rw whole on the
        reducing device, V, Wb and gp one tensor per owned shard."""
        nb, nc = self.n_cb, self.n_c
        img_parts, V, Wb, gp, vw = [], [], [], [], []
        for sh in self.shards:
            xk = x.to(sh.dev)
            A, B, vwk = self._local_AB(sh, xk)
            n = A.shape[0]
            Af, Bf = A.reshape(n, 2 * nb), B.reshape(n, 6)
            gA = torch.einsum("nka,nk->na", A, vwk)
            img_parts.append(sh.seg_img(torch.cat([self._fb_u(Af, Af), gA],
                                                  1)))
            gB = torch.einsum("nka,nk->na", B, vwk)
            pt_red = sh.seg_pt(torch.cat([self._fb_v(Bf, Bf), gB], 1))
            Vk = pt_red[:, :9].reshape(-1, 3, 3)
            gpk = pt_red[:, 9:]
            Wb.append(self._fb_w(Af, Bf).reshape(n, nb, 3))
            if sh.pr_x.shape[0]:
                # Each x index has at most one prior: unique targets.
                r_o = (xk[sh.pr_x] - sh.pr_val) * sh.pr_w
                Vk.index_put_((sh.pr_lpt, sh.pr_coord, sh.pr_coord),
                              sh.pr_w ** 2, accumulate=True)
                gpk.index_put_((sh.pr_lpt, sh.pr_coord), sh.pr_w * r_o,
                               accumulate=True)
            m = sh.mask
            V.append(Vk * m[:, :, None] * m[:, None, :]
                     + sh.eye3 * (1.0 - m)[:, :, None])
            gp.append(gpk * m)
            vw.append(vwk.reshape(-1))

        img_red = self.mesh.sum_shards(img_parts)
        U = torch.zeros((nc + 1) ** 2, dtype=self.dtype, device=self.device)
        self._u_scatter.add_into(U, img_red[:, : nb * nb].reshape(-1))
        U = U.view(nc + 1, nc + 1)[:nc, :nc]
        gc = self._scatter_cam(img_red[:, nb * nb:])
        r_pr = (x[self.prior_x] - self.prior_val) * self.prior_w
        if self.cam_prior_x.shape[0]:
            w_c = self.prior_w[self.cam_prior_sel]
            U.index_put_((self.cam_prior_x, self.cam_prior_x), w_c ** 2,
                         accumulate=True)
            gc.index_put_((self.cam_prior_x,),
                          w_c * r_pr[self.cam_prior_sel], accumulate=True)
        rw = torch.cat(self.mesh.gather_shards(vw) + [r_pr])
        return U, V, Wb, gc, gp, rw

    # ------------------------------------------------------------------
    def _schur_S(self, U, Vinv, Wb, lam):
        """S = U + lam I - sum_pairs W_i1 Vinv_j W_i2', from per-shard
        sums: each shard's per-image diagonal blocks (kernel A) and its
        camera-pair fill-in (kernel B, written into its rows of the
        global camera-pair table), both summed over the shards, then
        scattered into S once."""
        nb, nc = self.n_cb, self.n_c
        n1 = nc + 1
        d_parts, acc_parts = [], []
        for sh, Vi, W in zip(self.shards, Vinv, Wb):
            Lv = chol3x3(Vi).reshape(-1, 9)
            Yf = self._fb_y(W.reshape(-1, nb * 3), Lv[sh.lpt])
            d_parts.append(sh.seg_img(self._fb_pair(Yf, Yf)))
            acc = torch.zeros((self.n_campair, nb * nb), dtype=self.dtype,
                              device=sh.dev)
            if sh.pair_plan is not None:
                acc[sh.cp_rows] = sh.pair_plan(Yf, self._fb_pair)
            acc_parts.append(acc)
        S = torch.zeros(n1 * n1, dtype=self.dtype, device=self.device)
        S.view(n1, n1)[:nc, :nc] = U
        S[self._diag_idx] += lam
        self._s_scatter.add_into(S, torch.cat([
            self.mesh.sum_shards(d_parts).reshape(-1),
            self.mesh.sum_shards(acc_parts).reshape(-1)]), alpha=-1.0)
        return S.view(n1, n1)[:nc, :nc]

    def _reduce_rhs(self, Vinv, Wb, rc, rp):
        """rc_tilde = rc - sum_i W_i (Vinv rp)_pt(i), per-image sums."""
        parts = []
        for sh, Vi, W, r in zip(self.shards, Vinv, Wb, rp):
            t = torch.einsum("jab,jb->ja", Vi, r)[sh.lpt]
            parts.append(sh.seg_img(torch.einsum("nab,nb->na", W, t)))
        return rc - self._scatter_cam(self.mesh.sum_shards(parts))

    def _cam_cols_of(self, sh, pc):
        """Per-observation camera-block entries of pc on shard sh."""
        pc_pad = torch.cat([pc.to(sh.dev), pc.new_zeros(1, device=sh.dev)])
        return pc_pad[sh.obs_cols]

    def _backsub(self, Vinv, Wb, rp, pc):
        """pp = Vinv (rp - W' pc), per shard."""
        out = []
        for sh, Vi, W, r in zip(self.shards, Vinv, Wb, rp):
            down = torch.einsum("nab,na->nb", W, self._cam_cols_of(sh, pc))
            rp_t = r - sh.seg_pt(down)
            out.append(torch.einsum("jab,jb->ja", Vi, rp_t) * sh.mask)
        return out

    def _solve_impl(self, U, V, Wb, rhs, lam):
        """Solve N p = rhs (+ lam on the diagonal) via S, as the JAX
        package's sharded solve does (module docstring).  Returns (p, L):
        L is all NaN when the factorization failed."""
        nc = self.n_c
        rc, rp = self.split_x(rhs)
        Vinv = [inv3x3(Vk + lam * sh.eye3 * sh.mask[:, :, None])
                for sh, Vk in zip(self.shards, V)]
        S = self._schur_S(U, Vinv, Wb, lam)
        rc_t = self._reduce_rhs(Vinv, Wb, rc, rp)

        d = torch.sqrt(torch.clamp(torch.diagonal(S), min=0.0))
        d = torch.where(d > 0, d, torch.ones_like(d))
        Dinv = 1.0 / d
        Ss = S * Dinv[:, None] * Dinv[None, :]
        f32 = self.dtype == torch.float32
        eye = torch.eye(nc, dtype=self.dtype, device=self.device)
        L, info = torch.linalg.cholesky_ex(Ss + (1e-3 if f32 else 0.0) * eye)
        L = torch.where(info == 0, L, torch.full_like(L, float("nan")))

        def tri_solve(b):
            y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
            return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]

        b = Dinv * rc_t
        q = tri_solve(b)
        for _ in range(2 if f32 else 1):
            q = q + tri_solve(b - Ss @ q)
        pc = Dinv * q
        return self.join_x(pc, self._backsub(Vinv, Wb, rp, pc)), L

    def _matvec_impl(self, U, V, Wb, pv):
        """N p without forming N."""
        pc, P = self.split_x(pv)
        up_parts, yp = [], []
        for sh, Vk, W, Pk in zip(self.shards, V, Wb, P):
            up = torch.einsum("nab,nb->na", W, Pk[sh.lpt])
            up_parts.append(sh.seg_img(up))
            down = torch.einsum("nab,na->nb", W, self._cam_cols_of(sh, pc))
            yk = torch.einsum("jab,jb->ja", Vk, Pk) + sh.seg_pt(down)
            yp.append(yk * sh.mask)
        yc = U @ pc + self._scatter_cam(self.mesh.sum_shards(up_parts))
        return self.join_x(yc, yp)

    # -- residuals (sharded evaluation) --------------------------------
    def _sharded_v(self, x, weighted):
        """Every shard's (S_obs*2,) residual rows, gathered in shard
        order on the reducing device; padded rows are zero."""
        parts = []
        for sh in self.shards:
            xk = x.to(sh.dev)
            Xrows = torch.where(sh.xidx >= 0, xk[sh.xidx.clamp(min=0)],
                                sh.base_pad)
            io = torch.where(sh.io_x >= 0, xk[sh.io_x.clamp(min=0)],
                             sh.base_io)
            eo = torch.where(sh.eo_x >= 0, xk[sh.eo_x.clamp(min=0)],
                             sh.base_eo)
            v = self._res_fn(io[sh.img], eo[sh.img], Xrows[sh.lpt], sh.ip,
                             sh.px)
            # w == 0 marks the padded rows.
            v = v * sh.w if weighted else v * (sh.w > 0)
            parts.append(v.reshape(-1))
        return torch.cat(self.mesh.gather_shards(parts))

    def weighted_residual(self, x):
        r_pr = (x[self.prior_x] - self.prior_val) * self.prior_w
        return torch.cat([self._sharded_v(x, True), r_pr])

    def residuals(self, x):
        """The unweighted residual vector with padded observation rows
        (unshard_obs_rows restores the project's order)."""
        r_pr = x[self.prior_x] - self.prior_val
        return torch.cat([self._sharded_v(x, False), r_pr])

    # ------------------------------------------------------------------
    def _diag_parts(self, U, V):
        return torch.diagonal(U), [
            torch.diagonal(Vk, dim1=-2, dim2=-1) * sh.mask
            for sh, Vk in zip(self.shards, V)]

    def _trace_diag(self, U, V) -> float:
        dU, dV = self._diag_parts(U, V)
        return float(dU.sum() + self.mesh.sum_shards([d.sum() for d in dV]))

    # ------------------------------------------------------------------
    def covariance_ops(self):
        """Unsharded SchurOps over the same project and spec, on the
        reducing device, for the posterior covariance and the report.

        The covariance extracts blocks of N^-1 from the camera Schur
        complement of the same normal equations this backend assembled,
        so delegating to the single-device extraction is equivalent;
        the COP chunk loop itself runs over the shards
        (Covariance.cop(mesh=...))."""
        if self._cov_ops is None:
            self._cov_ops = SchurOps(self._project, self.spec,
                                     dtype=self.dtype, device=self.device)
        return self._cov_ops
