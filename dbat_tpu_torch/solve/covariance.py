"""Posterior covariance of bundle results (counterpart of
dbat_tpu/solve/covariance.py; ref code/bundle/bundle_cov.m).

The reference computes a permuted Cholesky of J'J with OP-first
ordering and extracts CIO/CEO/COP blocks from the factor
(bundle_cov.m:83-99), with the vectorized 3x3-block OP covariance
(`VectorizedCOP`, bundle_cov.m:316-478) as the fast path.  Through the
Schur complement:

    [N^-1]_cc        = S^-1                      (camera/IO blocks)
    [N^-1]_pp,j diag = V_j^-1 + V_j^-1 (Ncp_j' S^-1 Ncp_j) V_j^-1

The second line is one reduced-system solve against the (n_c x 3)
column block of each point plus a batched 3x3 Gram product, run over
fixed-size point chunks (DBAT's 256 MB blocking, bundle_cov.m:397-401).

Where the work runs:
  * on the device of the bundle's ops, in f64: the assembly, the S
    build (both kernels), the triangular solves, the Ncp scatters and
    the Gram products (TF32 off, device.highest_precision);
  * on the host in f64, as in the JAX package: the inverse of the 3x3
    point blocks (a relative floor for exactly singular ones) and the
    Cholesky of the Jacobi-scaled S with the jitter ladder JITTER.  A
    raw f32 Cholesky of S breaks down at C5 scale and gives NaN and
    negative variances.

The extraction runs in f64 whatever the bundle's dtype: an f32 bundle's
ops are rebuilt in f64 on the same device, at the same x and in the
same frame (bundle.ops_f64), as bundle()'s f64 polish does.  The JAX
package extracts in the ops' dtype (a TPU has no fast f64), but an f32
S carries rounding of ~1e-5 of its scaled diagonal (S = U - sum W V^-1
W' cancels decades), while the scaled S of a self-calibrating ring
network has eigenvalues down to ~1e-7: the std of an f32 extraction
are then off by up to 116% at the C5 shape (PERF.md), and by more than
1e-2 in the JAX package's own f32 extraction on a 12-image ring
(tests/test_torch_covariance.py).

Every scatter-add here has repeated targets (all images share the IO
columns), so it runs through a SegScatter plan: in a fixed order
without atomics on the card, so f32 results repeat bit for bit.

All covariances are scaled by sigma0^2 (bundle_cov.m:213).

After a bundle on a mesh (parallel/), the extraction runs on an
unsharded SchurOps on the mesh's reducing device (bundle.ops_f64, the
JAX package's covariance_ops), and `cop(mesh=...)` deals the point
chunks to the shards: each shard runs its chunks on its device against
copies of the factor, and the blocks come back in point order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.serial import serialize
from ..device import highest_precision
from .bundle import ops_f64
from .schur import SchurOps
from .segsum import SegScatter

#: Jitter rungs (relative to the unit diagonal of the Jacobi-scaled S)
#: of the host f64 Cholesky, tried in order.
JITTER = (0.0, 1e-10, 1e-8, 1e-6, 1e-4)


def _ncp_scatter(cam_cols, local_pt, width, n_c, src_rows, n_src_rows,
                 nb, device):
    """SegScatter of per-observation (nb, 3) coupling blocks into a
    flat (n_c, width, 3) Ncp: observation i's block goes to camera
    columns cam_cols[i] of point column local_pt[i]; its source is row
    src_rows[i] of an (n_src_rows, nb, 3) array.  Fixed camera columns
    (index n_c) are dropped."""
    a = np.arange(3)
    tgt = (cam_cols[:, :, None] * width + local_pt[:, None, None]) * 3 \
        + a[None, None, :]
    src = (src_rows[:, None, None] * nb + np.arange(nb)[None, :, None]) \
        * 3 + a[None, None, :]
    keep = np.broadcast_to(cam_cols[:, :, None] < n_c, tgt.shape)
    return SegScatter(tgt[keep], src=src[keep], n_src=n_src_rows * nb * 3,
                      device=device)


class Covariance:
    """Posterior covariance extractor; factorizes once, serves blocks.

    The analog of bundle_cov(...,'prepare') caching E.final.factorized
    (bundle_cov.m:57-117).  Runs on `info.ops.device`, in f64 (see the
    module docstring)."""

    def __init__(self, project, info):
        self.project = project
        self.info = info
        self.ops = ops_f64(project, info)
        self.spec = info.spec
        self.s0_2 = info.sigma0**2
        self._x = None
        self._dense_inv = None
        self._schur = None
        self._cop_plan_cache = None
        self._cop_shard_cache = None
        #: rung of JITTER the Schur factorization used
        self.jitter = None

    # ------------------------------------------------------------------
    def _final_x(self):
        if self._x is None:
            # The solver's converged x lives in the ops frame (which may
            # be centroid-shifted for f32 solves, bundle(center=...)).
            fx = getattr(self.info, "final_x", None)
            if fx is None:
                p = self.project
                fx = serialize(self.spec, p.io, p.eo, p.op)
            self._x = torch.as_tensor(np.array(fx), device=self.ops.device
                                      ).to(self.ops.dtype)
        return self._x

    def factorize(self):
        highest_precision()
        x = self._final_x()
        ops = self.ops
        if isinstance(ops, SchurOps):
            if self._schur is None:
                U, V, Wb, _gc, _gp, _rw = ops._assemble_impl(x)
                # 3x3 point-block inverses in f64 on the host: the
                # closed-form f32 inverse loses the diagonal sign for
                # ill-conditioned blocks (near-parallel rays).  Exactly
                # singular blocks get a relative floor that is
                # negligible (1e-12) for healthy blocks.
                V_h = V.cpu().numpy().astype(np.float64)
                try:
                    Vinv_h = np.linalg.inv(V_h)
                except np.linalg.LinAlgError:
                    tr = np.einsum("jii->j", V_h)
                    V_h = V_h + (1e-12 * np.maximum(tr, 1.0))[
                        :, None, None] * np.eye(3)
                    Vinv_h = np.linalg.inv(V_h)
                Vinv = torch.as_tensor(Vinv_h, device=ops.device).to(
                    ops.dtype)
                S = ops._schur_S(U, Vinv, Wb, 0.0)
                # Jacobi-scaled S factored in f64 on the host with the
                # jitter ladder; extraction scales its right-hand sides
                # by Dinv: S^-1 = Dinv Ss^-1 Dinv.
                S_h = S.cpu().numpy().astype(np.float64)
                S_h = 0.5 * (S_h + S_h.T)
                dd = np.sqrt(np.clip(np.diag(S_h), 1e-300, None))
                Ss = S_h / np.outer(dd, dd)
                eye = np.eye(len(Ss))
                for rung in JITTER:
                    try:
                        L_h = np.linalg.cholesky(Ss + rung * eye)
                        break
                    except np.linalg.LinAlgError:
                        continue
                else:
                    raise np.linalg.LinAlgError(
                        "reduced camera system is numerically singular")
                self.jitter = rung

                def dev(a):
                    return torch.as_tensor(a, device=ops.device).to(
                        ops.dtype)

                self._schur = {"Vinv": Vinv, "Wb": Wb, "L": dev(L_h),
                               "Dinv": dev(1.0 / dd)}
        elif self._dense_inv is None:
            self._dense_inv = torch.linalg.inv(ops.normal(x).N).cpu().numpy()
        return self

    # ------------------------------------------------------------------
    def _cam_inv_block(self, idx):
        """[N^-1] block for x indices idx (all < n_c for Schur)."""
        self.factorize()
        if self._dense_inv is not None:
            return self._dense_inv[np.ix_(idx, idx)]
        L = self._schur["L"]
        Dinv = self._schur["Dinv"]
        it = torch.as_tensor(np.asarray(idx, np.int64), device=L.device)
        rhs = torch.zeros((L.shape[0], len(idx)), dtype=L.dtype,
                          device=L.device)
        # One entry per column: the targets (idx[k], k) are unique.
        rhs[it, torch.arange(len(idx), device=L.device)] = Dinv[it]
        y = torch.linalg.solve_triangular(L, rhs, upper=False)
        blk = Dinv[:, None] * torch.linalg.solve_triangular(
            L.mT, y, upper=True)
        return blk[it].cpu().numpy()

    def _gather_block(self, x_idx_row):
        """(k,k) covariance for one entity; zeros at fixed params."""
        nc = len(x_idx_row)
        out = np.zeros((nc, nc))
        est = x_idx_row >= 0
        if est.any():
            sub = self._cam_inv_block(x_idx_row[est])
            out[np.ix_(est, est)] = sub
        return out * self.s0_2

    # ------------------------------------------------------------------
    def cio(self):
        """(n_img, NC, NC) per-camera posterior covariance blocks."""
        iox = np.asarray(self.spec.io_x)
        return np.stack([self._gather_block(iox[i]) for i in range(len(iox))])

    def ceo(self):
        """(n_img, 6, 6) per-station posterior covariance blocks."""
        eox = np.asarray(self.spec.eo_x)
        return np.stack([self._gather_block(eox[i]) for i in range(len(eox))])

    def cio_full(self):
        """Full IO covariance over all estimated IO params (CIOF)."""
        iox = np.asarray(self.spec.io_x).reshape(-1)
        idx = iox[iox >= 0]
        return self._cam_inv_block(idx) * self.s0_2

    def ceo_full(self):
        eox = np.asarray(self.spec.eo_x).reshape(-1)
        idx = eox[eox >= 0]
        return self._cam_inv_block(idx) * self.s0_2

    def ciof(self):
        """CIOF over *leading* estimated IO entries (bundle_cov.m:93-99
        mode CIOF; high_io_correlations.m zeroes non-leading rows so
        block-shared duplicates do not report corr == 1).

        Returns (C, entries) with entries an (n,2) array of
        (image, io_column) for each row of C."""
        lead = np.asarray(self.spec.io_leading)
        iox = np.asarray(self.spec.io_x)
        imgs, cols = np.nonzero(lead & (iox >= 0))
        C = self._cam_inv_block(iox[imgs, cols]) * self.s0_2
        return C, np.stack([imgs, cols], axis=1)

    def ceof(self):
        """CEOF over leading estimated EO entries; returns (C, entries)
        with (image, eo_column) rows (bundle_cov.m CEOF mode)."""
        lead = np.asarray(self.spec.eo_leading)
        eox = np.asarray(self.spec.eo_x)
        imgs, cols = np.nonzero(lead & (eox >= 0))
        C = self._cam_inv_block(eox[imgs, cols]) * self.s0_2
        return C, np.stack([imgs, cols], axis=1)

    def copf(self, pts=None, max_params: int = 12000):
        """Full OP covariance (mode COPF, bundle_cov.m:93-99): the dense
        (3k, 3k) posterior covariance over the selected points
        (default: all), including cross-point blocks.

        COPF_{ij} = delta_ij V_i^-1 + (V^-1 Ncp_i') S^-1 (Ncp_j V^-1),
        computed as B'B with B = L^-1 Dinv (Ncp V^-1): one triangular
        solve against 3k columns.  Guarded by `max_params` (the
        reference's dense COPF is likewise only feasible on small
        networks)."""
        self.factorize()
        p = self.project
        opx = np.asarray(self.spec.op_x)
        if pts is None:
            pts = np.arange(p.n_op)
        pts = np.asarray(pts)
        k = len(pts)
        if 3 * k > max_params:
            raise ValueError(
                f"COPF over {k} points = {3*k} params exceeds guard "
                f"{max_params}; pass pts= or raise max_params")

        if self._dense_inv is not None:
            out = np.zeros((3 * k, 3 * k))
            flat = opx[pts].reshape(-1)
            est = flat >= 0
            out[np.ix_(est, est)] = self._dense_inv[
                np.ix_(flat[est], flat[est])]
            return out * self.s0_2

        ops = self.ops
        L, Dinv = self._schur["L"], self._schur["Dinv"]
        n_c, nb = ops.n_c, ops.n_cb
        obs_pt = np.asarray(p.obs_pt)
        in_sel = np.full(p.n_op, -1, np.int64)
        in_sel[pts] = np.arange(k)
        sel = np.flatnonzero(in_sel[obs_pt] >= 0)
        icols = ops.icols.cpu().numpy()
        plan = _ncp_scatter(icols[np.asarray(p.obs_img)[sel]],
                            in_sel[obs_pt[sel]], k, n_c, sel, ops.n_obs, nb,
                            ops.device)
        Ncp = torch.zeros(n_c * k * 3, dtype=L.dtype, device=L.device)
        plan.add_into(Ncp, self._schur["Wb"].reshape(-1))
        # Right-multiply each point column block by V_j^-1.
        Vs = self._schur["Vinv"][torch.as_tensor(pts, device=L.device)]
        NV = torch.einsum("cja,jab->cjb", Ncp.view(n_c, k, 3), Vs)
        y = torch.linalg.solve_triangular(
            L, Dinv[:, None] * NV.reshape(n_c, 3 * k), upper=False)
        out = (y.mT @ y).cpu().numpy()  # (3k, 3k)
        ar = np.arange(k)
        out4 = out.reshape(k, 3, k, 3)
        out4[ar, :, ar, :] += Vs.cpu().numpy()
        out = out4.reshape(3 * k, 3 * k)
        est = (opx[pts] >= 0).reshape(-1)
        out[~est, :] = 0.0
        out[:, ~est] = 0.0
        return out * self.s0_2

    # ------------------------------------------------------------------
    def cop(self, chunk: int = 4096, mesh=None):
        """(n_op, 3, 3) per-point posterior covariance blocks.

        Schur path: V^-1 + y'y per point with y = L^-1 Dinv (Ncp V^-1),
        a loop over chunks of `chunk` points on the device (the
        icpc_mex equivalent).  With a mesh (passed, or the one the
        bundle's ops ran on) the chunks are dealt to its shards
        (_cop_sharded)."""
        self.factorize()
        p = self.project
        opx = np.asarray(self.spec.op_x)

        if self._dense_inv is not None:
            out = np.zeros((p.n_op, 3, 3))
            for j in range(p.n_op):
                est = opx[j] >= 0
                if est.any():
                    idx = opx[j][est]
                    out[j][np.ix_(est, est)] = self._dense_inv[
                        np.ix_(idx, idx)]
            return out * self.s0_2

        if mesh is None:
            mesh = getattr(self.info.ops, "mesh", None)
        if mesh is not None:
            out = self._cop_sharded(chunk, mesh)
        else:
            # Plans are cached per (instance, chunk): repeat calls (the
            # report's covariance sections, posterior_std) pay only the
            # chunk loop.
            if self._cop_plan_cache is None \
                    or self._cop_plan_cache[0] != chunk:
                bounds = np.append(np.arange(0, p.n_op, chunk), p.n_op)
                self._cop_plan_cache = (chunk, self._folded_coupling(),
                                        self._chunk_plans(bounds,
                                                          self.ops.device))
            _chunk, Wv, plans = self._cop_plan_cache
            sc = self._schur
            out = self._cop_chunks(Wv, sc["L"], sc["Dinv"], sc["Vinv"],
                                   plans).cpu().numpy()

        # Zero rows/cols of fixed coordinates (they carry the identity
        # placeholder in V).
        est = opx >= 0
        mask = est[:, :, None] & est[:, None, :]
        return np.where(mask, out, 0.0) * self.s0_2

    def _cop_sharded(self, chunk: int, mesh):
        """The COP chunk loop dealt over a mesh's shards: the chunk count
        rounded up to a multiple of the shard count, each shard a
        contiguous run of chunks (`span` points), run on its device
        against copies of the factor; the blocks are all-gathered in
        shard order, so they come back in point order."""
        n_op, n_sh = self.project.n_op, mesh.n_shards
        chunk = min(chunk, max(-(-n_op // n_sh), 1))
        n_chunks = -(-n_op // chunk)
        span = -(-n_chunks // n_sh) * chunk
        if self._cop_shard_cache is None \
                or self._cop_shard_cache[0] != (chunk, mesh):
            sc = self._schur
            factors = zip(*(mesh.replicated(t) for t in (
                self._folded_coupling(), sc["L"], sc["Dinv"], sc["Vinv"])))
            runs = []
            for k, factor in zip(mesh.owned, factors):
                lo, hi = min(k * span, n_op), min((k + 1) * span, n_op)
                bounds = np.append(np.arange(lo, hi, chunk), hi)
                runs.append((lo, hi, factor + (self._chunk_plans(
                    bounds, mesh.devices[k]),)))
            self._cop_shard_cache = ((chunk, mesh), runs)
        parts = []
        for lo, hi, args in self._cop_shard_cache[1]:
            blk = self._cop_chunks(*args)
            parts.append(torch.cat([blk, blk.new_zeros(
                (span - (hi - lo), 3, 3))]))
        out = torch.cat(mesh.gather_shards(parts))[:n_op]
        return out.cpu().numpy()

    def _folded_coupling(self):
        """Wv (flat): each observation's V^-1-folded coupling block
        W_i V_j^-1, in the ops' dtype on their device.  The fold makes
        each point block the Gram y'y plus V^-1, whose diagonal is a sum
        of squares, non-negative in f32 by construction (the V^-1 G V^-1
        triple product is not)."""
        sc = self._schur
        return torch.einsum("kab,kbc->kac", sc["Wb"],
                            self.ops._gather_pt(sc["Vinv"])).reshape(-1)

    def _cop_chunks(self, Wv, L, Dinv, Vinv, plans):
        """(hi - lo, 3, 3) blocks of the points [lo, hi) that `plans`
        cover, V^-1 + y'y per point, one chunk at a time."""
        n_c = self.ops.n_c
        blks = []
        for lo, hi, plan in plans:
            w = hi - lo
            Ncp = torch.zeros(n_c * w * 3, dtype=L.dtype, device=L.device)
            plan.add_into(Ncp, Wv)
            y = torch.linalg.solve_triangular(
                L, Dinv[:, None] * Ncp.view(n_c, w * 3), upper=False)
            y = y.view(n_c, w, 3)
            blks.append(Vinv[lo:hi] + torch.einsum("cja,cjb->jab", y, y))
        if not blks:
            return Vinv.new_zeros((0, 3, 3))
        return torch.cat(blks)

    def _chunk_plans(self, bounds, device):
        """The COP chunk loop's plans on `device`, [(lo, hi, scatter),
        ...] for the chunks [bounds[k], bounds[k+1]) of points: each
        chunk scatters Wv into its (n_c, hi - lo, 3) Ncp with its own
        SegScatter (all rays of a point add into the same IO-column
        rows)."""
        ops = self.ops
        p = self.project
        obs_pt = np.asarray(p.obs_pt)
        icols = ops.icols.cpu().numpy()
        cam_cols = icols[np.asarray(p.obs_img)]
        order = np.argsort(obs_pt, kind="stable")
        cuts = np.searchsorted(obs_pt[order], bounds)
        plans = []
        for k in range(len(bounds) - 1):
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            sel = order[cuts[k]:cuts[k + 1]]
            plans.append((lo, hi, _ncp_scatter(
                cam_cols[sel], obs_pt[sel] - lo, hi - lo, ops.n_c, sel,
                ops.n_obs, ops.n_cb, device)))
        return plans

    # ------------------------------------------------------------------
    def posterior_std(self):
        """Posterior standard deviations scattered into IO/EO/OP shapes
        (NaN where fixed) — the post.std analog."""
        cio = self.cio()
        ceo = self.ceo()
        cop = self.cop()
        iox = np.asarray(self.spec.io_x)
        eox = np.asarray(self.spec.eo_x)
        opx = np.asarray(self.spec.op_x)

        def stds(blocks, xmap):
            d = np.sqrt(np.maximum(np.einsum("nii->ni", blocks), 0.0))
            d[xmap < 0] = np.nan
            return d

        return stds(cio, iox), stds(ceo, eox), stds(cop, opx)
