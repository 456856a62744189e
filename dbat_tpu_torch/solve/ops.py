"""Bundle operators: residual vector, problem structure and the dense
normal equations (counterpart of dbat_tpu/solve/ops.py).

Per-observation residuals and Jacobian blocks come from
models/residuals.py; the Jacobian itself is never materialized: the
weighted outer products of the per-observation blocks are scattered
straight into N = J'WJ and g = J'Wr.  The residual-vector order matches
the reference ([image x/y per obs; IO priors; EO priors; OP priors],
core/serial.py), so sigma0 and per-observation residuals are
element-comparable with DBAT reports.

The dense N is exact and is the oracle for the Schur path in schur.py;
bundle() takes it for networks of at most 2000 unknowns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.serial import SerialSpec, deserialize, serialize
from ..device import as_dtype, np_dtype, resolve_device
from ..models.residuals import make_obs_jacobian_fn, make_obs_residual_fn
from .segsum import SegScatter


class BundleOps:
    """Static structure of one bundle problem on one device; every
    public method is a function of the unknown vector x only.

    device: where the tensors live and the work runs; default CUDA,
    which raises on a machine without a card (see device.py)."""

    def __init__(self, project, spec: SerialSpec, dtype=torch.float64,
                 device=None):
        self.device = resolve_device(device)
        self.dtype = as_dtype(dtype)
        self.spec = spec
        self.n_x = spec.n_x
        p = project

        self.model = int(np.unique(np.atleast_1d(p.dist_model))[0])
        self.nK, self.nP = p.nK, p.nP

        obs_img_np = np.asarray(p.obs_img)
        obs_pt_np = np.asarray(p.obs_pt)
        px_size_np = np.asarray(p.sensor_px_size[:, 0], np.float64)
        px_obs_np = px_size_np[obs_img_np]
        # Weights: IP std given in px, residuals in mm (buildweightmatrix.m).
        w_ip_np = 1.0 / (np.asarray(p.ip_std_px) * px_obs_np[:, None])

        # Column maps (n_obs, NC+6+3), -1 for fixed parameters.
        self.cols_np = np.concatenate(
            [
                np.asarray(spec.io_x, np.int32)[obs_img_np],
                np.asarray(spec.eo_x, np.int32)[obs_img_np],
                np.asarray(spec.op_x, np.int32)[obs_pt_np],
            ],
            axis=1,
        )

        # Prior observations: x index, value, sqrt-weight; IO, EO, OP
        # order (post.res.ix, buildserialindices.m:148-159).
        def prior(vals, stds, src, obs_x):
            vals = np.asarray(vals).reshape(-1)
            stds = np.asarray(stds).reshape(-1)
            return np.asarray(obs_x, np.int64), vals[src], 1.0 / stds[src]

        pio = prior(p.prior_io_val, p.prior_io_std,
                    spec.io_obs_src, spec.io_obs_x)
        peo = prior(p.prior_eo_val, p.prior_eo_std,
                    spec.eo_obs_src, spec.eo_obs_x)
        pop = prior(p.prior_op_val, p.prior_op_std,
                    spec.op_obs_src, spec.op_obs_x)
        self.prior_x_np = np.concatenate([pio[0], peo[0], pop[0]])
        prior_val_np = np.concatenate([pio[1], peo[1], pop[1]])
        prior_w_np = np.concatenate([pio[2], peo[2], pop[2]])

        # Host copies for x0(): serialization is host bookkeeping.
        nd = np_dtype(self.dtype)
        self._base_io_np = np.asarray(p.io, nd)
        self._base_eo_np = np.asarray(p.eo, nd)
        self._base_op_np = np.asarray(p.op, nd)

        dev, dt = self.device, self.dtype

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev
                                   ).to(dt)

        def i(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        self.base_io = f(p.io)
        self.base_eo = f(p.eo)
        self.base_op = f(p.op)
        self._x_maps = tuple(i(m) for m in (spec.io_x, spec.eo_x, spec.op_x))
        self.obs_img = i(obs_img_np)
        self.obs_pt = i(obs_pt_np)
        self.ip_px = f(p.ip_px)
        self.px_obs = f(px_obs_np)
        self.w_ip = f(w_ip_np)  # (n_obs, 2); sqrt-weights
        self.prior_x = i(self.prior_x_np)
        self.prior_val = f(prior_val_np)
        self.prior_w = f(prior_w_np)

        self.n_obs = int(obs_img_np.shape[0])
        self.n_res = 2 * self.n_obs + int(self.prior_x_np.shape[0])

        self._res_fn = make_obs_residual_fn(self.model, self.nK, self.nP)
        self._jac_fn = make_obs_jacobian_fn(self.model, self.nK, self.nP)

    # -- parameter handling -------------------------------------------------
    def params_of_x(self, x):
        return deserialize(self.spec, x, self.base_io, self.base_eo,
                           self.base_op, maps=self._x_maps)

    def x0(self):
        return torch.as_tensor(serialize(
            self.spec, self._base_io_np, self._base_eo_np,
            self._base_op_np), device=self.device)

    # -- residuals ----------------------------------------------------------
    def _ip_residual(self, io, eo, op):
        return self._res_fn(
            io[self.obs_img], eo[self.obs_img], op[self.obs_pt],
            self.ip_px, self.px_obs,
        )

    def residuals(self, x):
        """Full unweighted residual vector (n_res,)."""
        io, eo, op = self.params_of_x(x)
        r_ip = self._ip_residual(io, eo, op).reshape(-1)
        r_pr = x[self.prior_x] - self.prior_val
        return torch.cat([r_ip, r_pr])

    def weighted_residual(self, x):
        io, eo, op = self.params_of_x(x)
        r_ip = (self._ip_residual(io, eo, op) * self.w_ip).reshape(-1)
        r_pr = (x[self.prior_x] - self.prior_val) * self.prior_w
        return torch.cat([r_ip, r_pr])

    # -- normal equations ---------------------------------------------------
    def _dense_plans(self):
        """Scatter plans of the per-observation blocks into the flat
        (n_x+1)^2 N and the (n_x+1,) g; fixed columns go to the scratch
        index n_x.  Built at the first dense assembly: the Schur
        subclass never needs them."""
        plans = getattr(self, "_dense_scatter", None)
        if plans is None:
            nx = self.n_x
            idx = np.where(self.cols_np >= 0, self.cols_np, nx).astype(
                np.int64)
            n_blk = (idx[:, :, None] * (nx + 1) + idx[:, None, :])
            plans = (SegScatter(n_blk, device=self.device),
                     SegScatter(idx, device=self.device))
            self._dense_scatter = plans
        return plans

    def _normal(self, x):
        """Dense weighted normal equations.

        Returns (N, g, rw) with N = J'WJ (n_x,n_x), g = J'Wr (n_x,),
        rw the weighted residual vector.  Fixed-parameter columns are
        routed to a scratch row that is sliced away."""
        n_plan, g_plan = self._dense_plans()
        io, eo, op = self.params_of_x(x)
        v, jio, jeo, jop = self._jac_fn(
            io[self.obs_img], eo[self.obs_img], op[self.obs_pt],
            self.ip_px, self.px_obs,
        )
        J = torch.cat([jio, jeo, jop], 2)  # (n, 2, nb)
        Jw = J * self.w_ip[:, :, None]
        vw = v * self.w_ip

        nx = self.n_x
        dev, dt = self.device, self.dtype
        blocks = torch.einsum("nki,nkj->nij", Jw, Jw)
        N = n_plan.add_into(torch.zeros((nx + 1) ** 2, dtype=dt, device=dev),
                            blocks.reshape(-1)).view(nx + 1, nx + 1)
        g = g_plan.add_into(torch.zeros(nx + 1, dtype=dt, device=dev),
                            torch.einsum("nki,nk->ni", Jw, vw).reshape(-1))

        # Prior rows: unit Jacobian at prior_x scaled by prior_w.  Each
        # x index has at most one prior observation (core/serial.py), so
        # these accumulating writes have unique targets.
        r_pr = (x[self.prior_x] - self.prior_val) * self.prior_w
        N.index_put_((self.prior_x, self.prior_x), self.prior_w ** 2,
                     accumulate=True)
        g.index_put_((self.prior_x,), self.prior_w * r_pr, accumulate=True)

        rw = torch.cat([vw.reshape(-1), r_pr])
        return N[:nx, :nx], g[:nx], rw

    def normal(self, x):
        """Normal-equation state at x (see normal_state.py)."""
        from .normal_state import DenseNormalState

        N, g, rw = self._normal(torch.as_tensor(x, device=self.device)
                                .to(self.dtype))
        return DenseNormalState(N, g, rw)

    # -- structural rank ----------------------------------------------------
    def _column_matching(self) -> np.ndarray:
        """Maximum bipartite matching of the Jacobian pattern's columns
        (host scipy), one entry per unknown, -1 where unmatched.
        Cached: the pattern is static."""
        cached = getattr(self, "_match", None)
        if cached is not None:
            return cached
        import scipy.sparse as sp
        from scipy.sparse.csgraph import maximum_bipartite_matching

        cols = self.cols_np
        n, nb = cols.shape
        rows_i = np.concatenate(
            [np.repeat(2 * np.arange(n), nb),
             np.repeat(2 * np.arange(n) + 1, nb),
             2 * n + np.arange(self.prior_x_np.size)]
        )
        cols_i = np.concatenate(
            [cols.reshape(-1), cols.reshape(-1), self.prior_x_np]
        )
        keep = cols_i >= 0
        A = sp.csr_matrix(
            (np.ones(keep.sum(), dtype=np.int8), (rows_i[keep], cols_i[keep])),
            shape=(self.n_res, self.n_x),
        )
        self._match = maximum_bipartite_matching(A, perm_type="row")
        return self._match

    def unmatched_columns(self) -> np.ndarray:
        """Unknowns left unmatched by a maximum bipartite matching of
        the Jacobian pattern: the suspects of a structural rank
        deficiency (bundle.m:370-400)."""
        return np.flatnonzero(self._column_matching() < 0)

    def structural_rank(self) -> int:
        """sprank of the Jacobian pattern (replaces the reference's
        sprank check, gauss_newton_armijo.m:130-142)."""
        return self.n_x - len(self.unmatched_columns())
