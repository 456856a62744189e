"""Serialize/deserialize maps between the unknown vector x and the
parameter arrays (counterpart of dbat_tpu/core/serial.py).

Mirror of code/misc/buildserialindices.m: the unknown vector is ordered
[IO params; EO params; OP params]; within each section, image-major
(the reference's column-major find over its (NC, n_img) arrays equals
row-major over our (n_img, NC) arrays).  Parameter blocks shared across
images (block-variant cameras) contribute one unknown per block; the
first ("leading") image of each block carries it.

The residual vector is ordered [image points (2 per obs); IO prior
observations; EO prior observations; OP prior observations], matching
post.res.ix (buildserialindices.m:148-159).  Prior observation rows are
x - prior with unit Jacobian rows (code/bundle/lsa/prior_obs.m).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SerialSpec:
    # x index for every (entity, param), or -1 if fixed. Shared params
    # point at the same x entry.
    io_x: np.ndarray  # (n_img, NC) int32
    eo_x: np.ndarray  # (n_img, 6) int32
    op_x: np.ndarray  # (n_op, 3) int32
    # leading masks: True where this entry owns its x entry
    io_leading: np.ndarray
    eo_leading: np.ndarray
    op_leading: np.ndarray
    n_io: int
    n_eo: int
    n_op: int
    n_x: int
    # prior observations, each as (flat entity-array index, x index)
    io_obs_src: np.ndarray  # flat indices into io array
    io_obs_x: np.ndarray
    eo_obs_src: np.ndarray
    eo_obs_x: np.ndarray
    op_obs_src: np.ndarray
    op_obs_x: np.ndarray

    @property
    def n_prior(self) -> int:
        return len(self.io_obs_x) + len(self.eo_obs_x) + len(self.op_obs_x)


def _serialize_block(block: np.ndarray, est: np.ndarray, use: np.ndarray,
                     offset: int):
    """Per-section x numbering (ref buildserialindices.m:162-221).

    block: (n, m) int sharing ids per (entity,param); est: bool; use:
    prior-observation flags.  Returns (x_idx (n,m), leading (n,m),
    n_params, obs_src flat indices, obs_x).
    """
    n, m = block.shape
    blk = block.copy()
    blk[~est] = 0  # fixed entries do not get unknowns

    # Fast path: no sharing (every nonzero block id unique within its
    # column) — covers OP always and EO/IO in image-variant projects.
    simple = True
    for j in range(m):
        col = blk[:, j]
        nz = col[col != 0]
        if len(np.unique(nz)) != len(nz):
            simple = False
            break

    if simple:
        est_nz = blk != 0
        leading = est_nz
        x_idx = np.full((n, m), -1, dtype=np.int64)
        flat = est_nz.reshape(-1)
        x_idx.reshape(-1)[flat] = offset + np.arange(flat.sum())
        counter = int(flat.sum())
        use_flat = (use & leading).reshape(-1)
        obs_src = np.flatnonzero(use_flat)
        obs_x = x_idx.reshape(-1)[obs_src]
        return x_idx, leading, counter, obs_src, obs_x

    # General path (shared blocks): small arrays, plain loop.
    x_idx = np.full((n, m), -1, dtype=np.int64)
    leading = np.zeros((n, m), dtype=bool)
    counter = 0
    seen = [dict() for _ in range(m)]
    order = []  # (i, j) of leading entries in enumeration order
    for i in range(n):
        for j in range(m):
            b = blk[i, j]
            if b == 0:
                continue
            if b in seen[j]:
                x_idx[i, j] = seen[j][b]
            else:
                xi = offset + counter
                seen[j][b] = xi
                x_idx[i, j] = xi
                leading[i, j] = True
                order.append((i, j))
                counter += 1

    # Prior observations: only leading entries, in enumeration order.
    obs_src, obs_x = [], []
    for (i, j) in order:
        if use[i, j]:
            obs_src.append(i * m + j)
            obs_x.append(x_idx[i, j])
    return (
        x_idx,
        leading,
        counter,
        np.array(obs_src, dtype=np.int64),
        np.array(obs_x, dtype=np.int64),
    )


def build_serial(project) -> SerialSpec:
    """Build the full x map from a Project's blocks/est/prior masks."""
    n_op = project.n_op
    op_block = np.tile(
        np.arange(1, n_op + 1)[:, None], (1, 3)
    )  # all OP distinct (buildserialindices.m:99)

    io_x, io_lead, n_io, io_src, io_obs_x = _serialize_block(
        project.io_block, project.est_io, project.prior_io_use, 0
    )
    eo_x, eo_lead, n_eo, eo_src, eo_obs_x = _serialize_block(
        project.eo_block, project.est_eo, project.prior_eo_use, n_io
    )
    op_x, op_lead, n_opx, op_src, op_obs_x = _serialize_block(
        op_block, project.est_op, project.prior_op_use, n_io + n_eo
    )
    return SerialSpec(
        io_x=io_x.astype(np.int32),
        eo_x=eo_x.astype(np.int32),
        op_x=op_x.astype(np.int32),
        io_leading=io_lead,
        eo_leading=eo_lead,
        op_leading=op_lead,
        n_io=n_io,
        n_eo=n_eo,
        n_op=n_opx,
        n_x=n_io + n_eo + n_opx,
        io_obs_src=io_src,
        io_obs_x=io_obs_x,
        eo_obs_src=eo_src,
        eo_obs_x=eo_obs_x,
        op_obs_src=op_src,
        op_obs_x=op_obs_x,
    )


def serialize(spec: SerialSpec, io, eo, op):
    """Gather x from parameter arrays (numpy or torch).

    Host (numpy) inputs stay on the host: serialization is one-time
    bookkeeping, and the solvers move x to the device themselves.
    Tensor inputs give a tensor on their device."""
    if all(isinstance(a, np.ndarray) for a in (io, eo, op)):
        x = np.zeros(spec.n_x, dtype=io.dtype)
        for arr, x_map, lead in (
            (io, spec.io_x, spec.io_leading),
            (eo, spec.eo_x, spec.eo_leading),
            (op, spec.op_x, spec.op_leading),
        ):
            idx = x_map[lead]
            vals = arr[lead]
            m = idx >= 0
            x[idx[m]] = vals[m]
        return x
    x = torch.zeros(spec.n_x, dtype=io.dtype, device=io.device)
    for arr, x_map, lead in (
        (io, spec.io_x, spec.io_leading),
        (eo, spec.eo_x, spec.eo_leading),
        (op, spec.op_x, spec.op_leading),
    ):
        lead_t = torch.as_tensor(lead, device=io.device)
        idx = torch.as_tensor(x_map[lead], dtype=torch.int64,
                              device=io.device)
        x.index_put_((idx,), arr[lead_t])
    return x


def deserialize(spec: SerialSpec, x, io, eo, op, maps=None):
    """Scatter x into parameter tensors; fixed entries keep their value.

    `maps`: optional (io_x, eo_x, op_x) int64 tensors on x's device, so
    a hot loop does not upload the maps on every call."""
    if maps is None:
        maps = tuple(torch.as_tensor(m, dtype=torch.int64, device=x.device)
                     for m in (spec.io_x, spec.eo_x, spec.op_x))

    def put(arr, x_idx):
        gathered = x[x_idx.clamp(min=0)]
        return torch.where(x_idx >= 0, gathered, arr)

    return tuple(put(a, m) for a, m in zip((io, eo, op), maps))
