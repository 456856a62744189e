"""The legacy mesh path: SchurOps over observation shards (counterpart
of the JAX package's `SchurOps(mesh=, pair_chunk=)`, its GSPMD backend,
kept for the matrix-free PCG tier; bundle(mesh=) runs the
point-partitioned backend of sharded.py instead).

`SchurOps(project, spec, mesh=mesh, pair_chunk=c)` builds this class
(SchurOps.__new__).  As the JAX package's `_apply_mesh` does, the
per-observation arrays (image and point ids, image points, pixel sizes,
weights) are cut into contiguous slices of the project's observation
order over the shards; each shard holds its slice on its device with
its own point and image SegSums, and the whole arrays are not kept.
Every per-observation step of SchurOps (`_obs_*`) runs shard by shard
on the shard's slice, so the Jacobians, the W blocks (one tensor per
shard) and the residuals never exist whole; the per-image and
per-point sums are added over the shards in global shard order
(Mesh.sum_shards, where GSPMD inserts a psum).  The point blocks,
x and the camera system are whole on the reducing device, replicated as
in the JAX package.

The S fill-in runs over the observation pairs in chunks of
`pair_chunk` (padded at the scratch observation n_obs and the dump
camera pair n_campair), each chunk's pairs cut into contiguous slices
over the shards (the JAX package shards the within-chunk axis): the Y
rows are all-gathered (Mesh.gather_rows, GSPMD's all-gather), each
shard sums its slice's pair products per camera pair with a SegSum,
the shards are added in order, then the chunks in order.  No
`index_add_`, no atomics, and no kernel B: the JAX mesh path folds the
pairs by hand, and here kernel A forms the products.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..solve.schur import SchurOps
from ..solve.segsum import SegSum
from .mesh import shard_bounds

#: the per-observation arrays that BundleOps holds whole and a shard
#: holds as its slice
OBS_ARRAYS = ("obs_img", "obs_pt", "ip_px", "px_obs", "w_ip")


class ObsMeshSchurOps(SchurOps):
    """SchurOps on observation shards of a Mesh (module docstring).
    `shards`: one namespace per owned shard with its device `dev`, its
    slice of OBS_ARRAYS, `cam_active` and its `_seg_pt`/`_seg_img`
    SegSums; W blocks are lists with one tensor per owned shard."""

    def __init__(self, project, spec, dtype=torch.float64, device=None,
                 refine_iters: int = 2, mesh=None, pair_chunk: int = 32768):
        self.mesh = mesh
        self.pair_chunk = int(pair_chunk)
        super().__init__(project, spec, dtype=dtype,
                         device=mesh.resolve(device),
                         refine_iters=refine_iters)

    def _obs_plans(self, project, i1, i2, cp):
        mesh = self.mesh
        obs_img = np.asarray(project.obs_img)
        obs_pt = np.asarray(project.obs_pt)
        b = shard_bounds(self.n_obs, mesh.n_shards)
        self.shards = []
        for k in mesh.owned:
            dev, lo, hi = mesh.devices[k], b[k], b[k + 1]
            sh = SimpleNamespace(dev=dev, cam_active=self.cam_active.to(dev))
            for nm in OBS_ARRAYS:
                setattr(sh, nm, getattr(self, nm)[lo:hi].to(dev))
            sh._seg_pt = SegSum(obs_pt[lo:hi], self.n_pt, device=dev)
            sh._seg_img = SegSum(obs_img[lo:hi], project.n_img, device=dev)
            self.shards.append(sh)
        for nm in OBS_ARRAYS:
            setattr(self, nm, None)

        # Pair chunks; chunk c's slice cb[k]:cb[k+1] runs on shard k.
        pc = self.pair_chunk
        pad = (-len(i1)) % pc
        i1, i2 = (np.concatenate([a, np.full(pad, self.n_obs)])
                  .reshape(-1, pc) for a in (i1, i2))
        cp = np.concatenate([cp, np.full(pad, self.n_campair)]) \
            .reshape(-1, pc)
        cb = shard_bounds(pc, mesh.n_shards)
        self._chunks = []
        for c in range(cp.shape[0]):
            parts = []
            for k in mesh.owned:
                dev, s = mesh.devices[k], slice(cb[k], cb[k + 1])
                parts.append((torch.as_tensor(i1[c, s], device=dev),
                              torch.as_tensor(i2[c, s], device=dev),
                              SegSum(cp[c, s], self.n_campair + 1,
                                     device=dev)))
            self._chunks.append(parts)

    def _on_shards(self, *tensors):
        """Each owned shard with the tensors on its device."""
        return [(sh, *(t.to(sh.dev) for t in tensors))
                for sh in self.shards]

    def _obs_sum(self, fn, Wb, *args):
        return self.mesh.sum_shards([
            fn(sh, W, *a) for (sh, *a), W in zip(self._on_shards(*args), Wb)])

    # ------------------------------------------------------------------
    def _assemble_impl(self, x):
        io, eo, op = self.params_of_x(x)
        img, pt, Wb, vw = zip(*(self._obs_normal(*a) for a in
                                self._on_shards(io, eo, op, self.op_mask)))
        mesh = self.mesh
        return self._normal_system(
            x, mesh.sum_shards(img), mesh.sum_shards(pt), list(Wb),
            mesh.gather_rows(vw, self.n_obs).reshape(-1))

    def _fill_in(self, Lvf, Wb):
        Ys, D = zip(*(self._obs_Y(sh, W, L) for (sh, L), W in
                      zip(self._on_shards(Lvf), Wb)))
        parts = [self.mesh.sum_shards(D).reshape(-1)]
        if self.n_pairs:
            Y = self.mesh.gather_rows(Ys, self.n_obs)
            Ypad = self.mesh.replicated(torch.cat([Y, Y.new_zeros(
                (1, Y.shape[1]))]))
            acc = None
            for chunk in self._chunks:
                part = self.mesh.sum_shards([
                    seg(self._fb_pair(Yk[j1], Yk[j2]))
                    for (j1, j2, seg), Yk in zip(chunk, Ypad)])
                acc = part if acc is None else acc + part
            parts.append(acc[: self.n_campair].reshape(-1))
        return torch.cat(parts)

    # -- residuals, shard by shard --------------------------------------
    def _obs_residual(self, x, weighted: bool):
        io, eo, op = self.params_of_x(x)
        parts = []
        for sh, iok, eok, opk in self._on_shards(io, eo, op):
            v = self._res_fn(iok[sh.obs_img], eok[sh.obs_img],
                             opk[sh.obs_pt], sh.ip_px, sh.px_obs)
            parts.append(v * sh.w_ip if weighted else v)
        return self.mesh.gather_rows(parts, self.n_obs).reshape(-1)

    def residuals(self, x):
        return torch.cat([self._obs_residual(x, False),
                          x[self.prior_x] - self.prior_val])

    def weighted_residual(self, x):
        return torch.cat([self._obs_residual(x, True),
                          (x[self.prior_x] - self.prior_val)
                          * self.prior_w])
