"""Precomputed segment reductions and scatters (counterpart of
dbat_tpu/solve/segsum.py), summed in an order fixed at setup.

`SegSum` reduces (n_items, ...) rows to (n_seg, ...) by segment ids
known at setup:

  * ids == repeat(arange(n_seg), R)  ->  reshape + axis-sum;
  * otherwise: the sorted ids are bucketed into fixed-cap rows (the
    JAX package's plan), one gather + dense row-sum, then the rows of
    each segment are summed.

`SegScatter` adds static sources into a flat output whose indices
repeat (shared IO columns map many images and camera pairs onto one
entry of U, S and the camera gradient).

Two orders, one per device, both fixed:

  * CPU tensors (`sequential`): `index_add_`, which on the CPU adds the
    sources one at a time in index order, as the JAX package's scatters
    do on the CPU;
  * CUDA tensors (`ordered`): no atomics.  A segment's rows are summed
    by further bucket levels until it has one row, and a scatter target
    hit once takes its source as it is while the sources of a repeated
    target are summed by a SegSum first; every output entry is then
    written once.  Results repeat bit for bit from run to run.  They
    are not bitwise equal to the CPU's, which adds in another order.
"""

from __future__ import annotations

import numpy as np
import torch


def _buckets(order, sid, cap: int, n_pad: int):
    """Rows of up to `cap` consecutive items of one segment.

    order: (n,) source positions, sorted by segment; sid: (n,) their
    sorted segment ids.  Returns (gidx (n_rows, cap), row_seg (n_rows,)):
    row r gathers its items from the sources, the tail of a segment's
    last row points at the zero pad row `n_pad`."""
    n = len(sid)
    starts = np.flatnonzero(np.diff(sid, prepend=-1))
    lens = np.diff(np.append(starts, n))
    n_rows_per = -(-lens // cap)
    n_rows = int(n_rows_per.sum())
    row_seg_idx = np.repeat(np.arange(len(starts)), n_rows_per)
    off = (np.arange(n_rows) - np.repeat(np.cumsum(n_rows_per)
                                         - n_rows_per, n_rows_per)) * cap
    pos = off[:, None] + np.arange(cap)[None, :]
    valid = pos < lens[row_seg_idx][:, None]
    src = starts[row_seg_idx][:, None] + pos
    gidx = np.where(valid, order[np.where(valid, src, 0)], n_pad)
    return gidx, sid[starts][row_seg_idx]


def _gather_sum(data, gidx):
    """Row sums of data gathered by gidx, the pad index reading zeros."""
    pad = torch.zeros((1,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return torch.cat([data, pad], 0)[gidx].sum(1)


class SegSum:
    """Reduction of (n_items, ...) data to (n_seg, ...) by static ids.

    `src`/`n_src` (bucket mode only): item i is row src[i] of data with
    n_src rows, so a subset of the rows (in any order, a row more than
    once) can be reduced without gathering it first."""

    def __init__(self, ids, n_seg: int, cap: int = 64, device="cpu",
                 src=None, n_src: int | None = None):
        ids = np.asarray(ids)
        n_items = len(ids)
        self.n_seg = int(n_seg)
        self.n_items = n_items

        R = n_items // n_seg if n_seg and n_items % n_seg == 0 else 0
        if src is None and R and np.array_equal(
                ids, np.repeat(np.arange(n_seg), R)):
            self.mode = "reshape"
            self.R = R
            return

        self.mode = "bucket"
        src = np.arange(n_items) if src is None else np.asarray(src)
        n_src = n_items if n_src is None else int(n_src)
        order = np.argsort(ids, kind="stable")
        gidx, row_seg = _buckets(src[order], ids[order], cap, n_src)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.gidx = t(gidx)
        self.row_seg = t(row_seg)

        # Segments of several rows: sum their rows by further bucket
        # levels.  Each level's rows are sorted by segment; a segment
        # left with one row is final there.
        levels, finals, seg = [], [], row_seg
        while True:
            first = np.flatnonzero(np.diff(seg, prepend=-1))
            lens = np.diff(np.append(first, len(seg)))
            single = lens == 1
            finals.append((first[single], seg[first[single]]))
            multi = np.flatnonzero(np.repeat(~single, lens))
            if not len(multi):
                break
            gidx_k, seg = _buckets(multi, seg[multi],
                                   int(min(cap, lens.max())), len(seg))
            levels.append(t(gidx_k))
        self._levels = levels
        self._final_rows = [t(rows) for rows, _ in finals]
        final_seg = np.concatenate([s for _, s in finals])
        # Every segment one row, in order, at level 1: the rows are the
        # output (per-point sums with fewer items than cap).
        self._rows_are_output = (not levels and np.array_equal(
            final_seg, np.arange(self.n_seg)))
        self._final_seg = t(final_seg)

    def __call__(self, data):
        if data.device.type == "cpu":
            return self.sequential(data)
        return self.ordered(data)

    def _reshape_sum(self, data):
        return data.reshape((self.n_seg, self.R) + data.shape[1:]).sum(1)

    def sequential(self, data):
        """The CPU's order: row sums added to their segments in row
        order by `index_add_`."""
        if self.mode == "reshape":
            return self._reshape_sum(data)
        out = torch.zeros((self.n_seg,) + data.shape[1:], dtype=data.dtype,
                          device=data.device)
        return out.index_add_(0, self.row_seg, _gather_sum(data, self.gidx))

    def ordered(self, data):
        """Without atomics, the card's order (any device)."""
        if self.mode == "reshape":
            return self._reshape_sum(data)
        rows = _gather_sum(data, self.gidx)
        if self._rows_are_output:
            return rows
        parts = [rows[self._final_rows[0]]]
        for gidx_k, fin in zip(self._levels, self._final_rows[1:]):
            rows = _gather_sum(rows, gidx_k)
            parts.append(rows[fin])
        out = torch.zeros((self.n_seg,) + data.shape[1:], dtype=data.dtype,
                          device=data.device)
        out[self._final_seg] = torch.cat(parts, 0)  # unique segments
        return out


class SegScatter:
    """out[targets[i]] += alpha * data[src[i]] over a static flat index
    map whose targets repeat.

    Virtual source i reads row src[i] of the data (default i).
    `add_into(out, data, alpha)` adds in place.  On the CPU it is one
    `index_add_` over the sources in order.  Elsewhere (`ordered`) a
    target hit once takes its source as it is, the sources of a
    repeated target are summed by a SegSum first, and every target in
    `self.targets` (each once) is written once."""

    def __init__(self, targets, src=None, n_src: int | None = None,
                 device="cpu"):
        targets = np.asarray(targets, np.int64).reshape(-1)
        src = np.arange(len(targets)) if src is None \
            else np.asarray(src, np.int64).reshape(-1)
        n_src = len(targets) if n_src is None else int(n_src)
        self._identity = np.array_equal(src, np.arange(n_src))
        self._all_t = torch.as_tensor(targets, device=device)
        self._all_src = torch.as_tensor(src, device=device)
        _, inv, counts = np.unique(targets, return_inverse=True,
                                   return_counts=True)
        rep = counts[inv.reshape(-1)] > 1
        many_t, many_inv = np.unique(targets[rep], return_inverse=True)
        self._one_src = torch.as_tensor(src[~rep], device=device)
        self._many = SegSum(many_inv.reshape(-1), len(many_t), device=device,
                            src=src[rep], n_src=n_src) \
            if rep.any() else None
        self.targets = torch.as_tensor(
            np.concatenate([targets[~rep], many_t]), device=device)

    def add_into(self, out, data, alpha: float = 1.0):
        """out (flat) += alpha * the scattered sources of data."""
        if data.device.type == "cpu":
            return self.add_sequential(out, data, alpha)
        return self.add_ordered(out, data, alpha)

    def add_sequential(self, out, data, alpha: float = 1.0):
        """The CPU's order: one `index_add_` over the sources."""
        vals = data if self._identity else data[self._all_src]
        return out.index_add_(0, self._all_t, vals, alpha=alpha)

    def add_ordered(self, out, data, alpha: float = 1.0):
        """The card's order (any device): each target written once."""
        t = self.targets
        out[t] = out[t] + alpha * self.ordered(data)
        return out

    def ordered(self, data):
        """The sums at `self.targets`, without atomics (any device)."""
        one = data[self._one_src]
        if self._many is None:
            return one
        return torch.cat([one, self._many.ordered(data)], 0)
