"""The port's CUDA kernels: wrappers, plain PyTorch versions and the
pair-bucket plan (counterpart of dbat_tpu/solve/pallas_kernels.py).

Kernel A, `fused_bilinear`  (csrc/fused_bilinear.cu):
    out[n, o] = sum_j A[n, ia(o,j)] * B[n, ib(o,j)]      (flatsel.py)
Kernel B, `pair_bucket_acc` (csrc/pair_bucket.cu):
    out[c] = sum over the bucketed observation pairs (i1, i2) of camera
    pair c of the flat product Y[i1] (x) Y[i2]           (S fill-in)

Each wrapper runs its plain PyTorch version for tensors on the CPU and
only then; for CUDA tensors it launches the kernel (on the current
stream, after checking device, dtype, shape and contiguity) or raises.
Each wrapper counts its launches in `.launches`, and per dtype in
`.launches_by_dtype`; `reset_counts()` zeroes both.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_KERNEL_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU; False when every one
    lies on one CUDA device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(name, t, dtype, ndim):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-D, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _current_stream(index: int) -> int:
    """The raw handle of the current CUDA stream of device `index`."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(fn, device, *args):
    """Call launcher `fn` with the current stream of `device` appended,
    switching the current device only when it is another one; raise on
    a CUDA error code."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(fn, device, *args)
    rc = fn(*args, _current_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")


class _Kernel:
    """Launch counter and the launchers of one kernel, bound once."""

    prefix = ""

    def __init__(self):
        self._fns = {}
        self.reset_counts()

    def reset_counts(self):
        self.launches = 0
        self.launches_by_dtype = {}

    def _count(self, dtype):
        self.launches += 1
        self.launches_by_dtype[dtype] = \
            self.launches_by_dtype.get(dtype, 0) + 1

    def _fn(self, dtype):
        fn = self._fns.get(dtype)
        if fn is None:
            from .. import build

            fn = getattr(build.load(),
                         f"{self.prefix}_{_KERNEL_DTYPES[dtype]}")
            self._fns[dtype] = fn
        return fn


# ---------------------------------------------------------------------------
# Kernel A
# ---------------------------------------------------------------------------

def fused_bilinear_plain(Af, Bf, table, d_out: int, g: int):
    """Plain version of kernel A: gather, multiply, then sum each
    output's g products in term order (a reduction such as `sum(-1)`
    leaves the order, and so the rounding, to the backend)."""
    ia = table[..., 0].reshape(-1).long()
    ib = table[..., 1].reshape(-1).long()
    prod = (Af[:, ia] * Bf[:, ib]).reshape(Af.shape[0], d_out, g)
    out = prod[..., 0]
    for j in range(1, g):
        out = out + prod[..., j]
    return out


class FusedBilinear(_Kernel):
    """Wrapper of kernel A.  `table` is the (d_out, g, 2) int32 (ia, ib)
    table of a FlatBilinear, on the operands' device."""

    name = "fused_bilinear"
    source = "dbat_tpu_torch/csrc/fused_bilinear.cu"
    replaces = "dbat_tpu/solve/pallas_kernels.py:84"
    prefix = "dbat_fused_bilinear"

    def __call__(self, Af, Bf, table, d_out: int, g: int):
        if _on_cpu(Af, Bf, table):
            return fused_bilinear_plain(Af, Bf, table, d_out, g)
        dtype = Af.dtype
        if dtype not in _KERNEL_DTYPES:
            raise TypeError(f"fused_bilinear: unsupported dtype {dtype}")
        _check("A", Af, dtype, 2)
        _check("B", Bf, dtype, 2)
        _check("table", table, torch.int32, 3)
        n = Af.shape[0]
        if Bf.shape[0] != n or table.shape != (d_out, g, 2):
            raise ValueError(
                f"fused_bilinear: shapes A {tuple(Af.shape)}, B "
                f"{tuple(Bf.shape)}, table {tuple(table.shape)} for "
                f"d_out={d_out}, g={g}")
        out = torch.empty((n, d_out), dtype=dtype, device=Af.device)
        if n == 0:
            return out
        _launch(self._fn(dtype), Af.device, Af.data_ptr(), Bf.data_ptr(),
                table.data_ptr(), out.data_ptr(), n, Af.shape[1],
                Bf.shape[1], d_out, g)
        self._count(dtype)
        return out


fused_bilinear = FusedBilinear()


# ---------------------------------------------------------------------------
# Kernel B
# ---------------------------------------------------------------------------

def pair_bucket_acc_plain(Yf, i1, i2, row_ptr, table, d_out: int, g: int,
                          cap: int):
    """Plain version of kernel B: gather the pair rows (pad indices hit
    an appended zero row), flat products, bucket-row sums, then a
    segment sum of the rows into camera pairs."""
    n_y = Yf.shape[0]
    Yz = torch.cat([Yf, torch.zeros((1, Yf.shape[1]), dtype=Yf.dtype,
                                    device=Yf.device)], 0)
    pad = torch.full_like(i1, n_y)

    def rows(idx):
        ok = (idx >= 0) & (idx < n_y)
        return Yz[torch.where(ok, idx, pad).long()]

    prod = fused_bilinear_plain(rows(i1), rows(i2), table, d_out, g)
    rowsum = prod.reshape(-1, cap, d_out).sum(1)
    n_campair = row_ptr.shape[0] - 1
    row_seg = torch.repeat_interleave(
        torch.arange(n_campair, device=Yf.device),
        (row_ptr[1:] - row_ptr[:-1]).long())
    out = torch.zeros((n_campair, d_out), dtype=Yf.dtype, device=Yf.device)
    return out.index_add_(0, row_seg, rowsum)


#: widest camera block kernel B takes (its tiles pad nb to 8, 16 or 32)
PAIR_BUCKET_MAX_NB = 32
#: the most pairs per bucket row kernel B takes (one index per lane)
PAIR_BUCKET_MAX_CAP = 16


class PairBucketAcc(_Kernel):
    """Wrapper of kernel B.  i1/i2: (n_rows*cap,) int32 pair operands
    (an index outside [0, n_obs) is a pad pair); row_ptr:
    (n_campair+1,) int32 offsets of each camera pair's bucket rows;
    chunk_ptr: (n_chunks+1,) int32 camera-pair offsets of the chunks,
    one per warp (PairBucketPlan), needed on the card only.  The term
    table must be abt_terms(nb, 3, nb): the one product that reaches
    kernel B, which it computes with a fixed tiling."""

    name = "pair_bucket_acc"
    source = "dbat_tpu_torch/csrc/pair_bucket.cu"
    replaces = "dbat_tpu/solve/pallas_kernels.py:129"
    prefix = "dbat_pair_bucket_acc"

    def __init__(self):
        super().__init__()
        self._tables_ok = {}  # data_ptr -> (table, _version) checked

    def _check_table(self, table, nb: int):
        """Raise unless `table` is abt_terms(nb, 3, nb); a table already
        checked and not modified since is not read again."""
        seen = self._tables_ok.get(table.data_ptr())
        if seen is not None and seen[0] is table \
                and seen[1] == table._version:
            return
        from .flatsel import abt_terms

        ref = abt_terms(nb, 3, nb)[:, :2].reshape(nb * nb, 3, 2)
        if not np.array_equal(table.cpu().numpy(), ref):
            raise ValueError(
                f"pair_bucket_acc: the table is not abt_terms({nb}, 3, {nb})")
        self._tables_ok[table.data_ptr()] = (table, table._version)

    def resident_warps(self, device, dtype, nb: int, cap: int) -> int:
        """Warps of the kernel for (dtype, nb, cap) that `device` holds
        at once, from the launcher's occupancy query."""
        if dtype not in _KERNEL_DTYPES:
            raise TypeError(f"pair_bucket_acc: unsupported dtype {dtype}")
        from .. import build

        fn = getattr(build.load(), "dbat_pair_bucket_resident_warps_"
                     + _KERNEL_DTYPES[dtype])
        with torch.cuda.device(device):
            warps = fn(nb, cap)
        if warps <= 0:
            raise RuntimeError(
                f"pair_bucket_acc: no occupancy for nb={nb}, cap={cap} "
                f"(cudaError {-warps})")
        return warps

    def __call__(self, Yf, i1, i2, row_ptr, table, d_out: int, g: int,
                 cap: int, chunk_ptr=None):
        if _on_cpu(Yf, i1, i2, row_ptr, table,
                   *(() if chunk_ptr is None else (chunk_ptr,))):
            # The partition only schedules the card's warps.
            return pair_bucket_acc_plain(Yf, i1, i2, row_ptr, table, d_out,
                                         g, cap)
        dtype = Yf.dtype
        if dtype not in _KERNEL_DTYPES:
            raise TypeError(f"pair_bucket_acc: unsupported dtype {dtype}")
        _check("Y", Yf, dtype, 2)
        for nm, t in (("i1", i1), ("i2", i2), ("row_ptr", row_ptr)):
            _check(nm, t, torch.int32, 1)
        _check("table", table, torch.int32, 3)
        n_campair = row_ptr.shape[0] - 1
        nb = math.isqrt(d_out)
        if (i1.shape != i2.shape or not 1 <= cap <= PAIR_BUCKET_MAX_CAP
                or i1.shape[0] % cap or table.shape != (d_out, g, 2)
                or n_campair < 0):
            raise ValueError(
                f"pair_bucket_acc: shapes i1 {tuple(i1.shape)}, i2 "
                f"{tuple(i2.shape)}, row_ptr {tuple(row_ptr.shape)}, table "
                f"{tuple(table.shape)} for d_out={d_out}, g={g}, cap={cap}")
        if (nb * nb != d_out or g != 3 or Yf.shape[1] != 3 * nb
                or not 1 <= nb <= PAIR_BUCKET_MAX_NB):
            raise ValueError(
                f"pair_bucket_acc: takes abt_terms(nb, 3, nb) with nb <= "
                f"{PAIR_BUCKET_MAX_NB} on (n, 3 nb) rows; got d_out={d_out}, "
                f"g={g}, Y {tuple(Yf.shape)}")
        if chunk_ptr is None:
            raise ValueError("pair_bucket_acc: the card needs the plan's "
                             "chunk partition (chunk_ptr)")
        _check("chunk_ptr", chunk_ptr, torch.int32, 1)
        n_chunks = chunk_ptr.shape[0] - 1
        if n_chunks < 1:
            raise ValueError("pair_bucket_acc: chunk_ptr holds no chunk")
        self._check_table(table, nb)
        if Yf.data_ptr() % 16:  # the bulk copies' windows are 16-byte aligned
            raise ValueError("pair_bucket_acc: Y is not 16-byte aligned")
        out = torch.empty((n_campair, d_out), dtype=dtype, device=Yf.device)
        if n_campair == 0:
            return out
        _launch(self._fn(dtype), Yf.device, Yf.data_ptr(), Yf.shape[0], nb,
                i1.data_ptr(), i2.data_ptr(), row_ptr.data_ptr(),
                chunk_ptr.data_ptr(), n_chunks, out.data_ptr(), cap)
        self._count(dtype)
        return out


pair_bucket_acc = PairBucketAcc()

#: every kernel wrapper of the port
KERNELS = (fused_bilinear, pair_bucket_acc)


def balanced_chunks(row_ptr: np.ndarray, n_chunks: int) -> np.ndarray:
    """(k+1,) camera-pair offsets cutting the camera pairs into k <=
    n_chunks contiguous chunks of about equal bucket-row counts: each cut
    goes to the camera-pair boundary nearest its even share of the
    rows, so a chunk holds at most the mean plus the largest camera
    pair's rows.  Cuts never split a camera pair."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    n_cp = len(row_ptr) - 1
    k = max(1, min(int(n_chunks), n_cp))
    total = row_ptr[-1]
    target = total * np.arange(1, k) / k
    hi = np.clip(np.searchsorted(row_ptr, target, side="left"), 1, n_cp)
    lo = hi - 1
    cut = np.where(target - row_ptr[lo] <= row_ptr[hi] - target, lo, hi)
    return np.concatenate([[0], cut, [n_cp]]).astype(np.int32)


def default_chunks(device, dtype, nb: int | None, cap: int) -> int:
    """Chunks for kernel B's persistent grid on `device`: one per warp
    the card holds at once (the launcher's occupancy query for dtype,
    nb and cap).  On the CPU the plain version ignores the partition:
    one chunk."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    if nb is None:
        raise ValueError("PairBucketPlan: the card's partition needs nb "
                         "(or n_chunks)")
    return pair_bucket_acc.resident_warps(device, dtype, nb, cap)


class PairBucketPlan:
    """Host-side plan for the S fill-in: observation pairs sorted by
    camera pair, padded per camera pair to a multiple of `cap`, and the
    camera pairs cut into `n_chunks` contiguous chunks of about equal
    bucket rows (balanced_chunks), by default one per warp of kernel B
    that the card holds at once for Y rows of `dtype` and camera blocks
    of width `nb` (default_chunks).

    Pad pairs index n_obs (outside Y), so they contribute nothing.
    Unlike the TPU plan the bucket rows are not padded to a tile
    multiple: kernel B walks each camera pair's rows through row_ptr.
    Computed once in numpy and moved to `device` once.
    """

    def __init__(self, i1, i2, cp_sorted, n_campair: int, n_obs: int,
                 cap: int = 16, device="cpu", n_chunks: int | None = None,
                 nb: int | None = None, dtype=torch.float32):
        i1 = np.asarray(i1)
        i2 = np.asarray(i2)
        cp = np.asarray(cp_sorted)
        if np.any(np.diff(cp) < 0):
            raise ValueError("pairs must be sorted by camera pair")
        self.cap = cap
        counts = np.bincount(cp, minlength=n_campair)
        padded = -(-counts // cap) * cap
        n_pad_pairs = int(padded.sum())
        i1p = np.full(n_pad_pairs, n_obs, dtype=np.int32)
        i2p = np.full(n_pad_pairs, n_obs, dtype=np.int32)
        src0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
        dst0 = np.concatenate([[0], np.cumsum(padded)[:-1]])
        idx = np.arange(len(cp)) - src0[cp] + dst0[cp]
        i1p[idx] = i1
        i2p[idx] = i2
        row_ptr = np.concatenate([[0], np.cumsum(padded // cap)])
        chunk_ptr = balanced_chunks(
            row_ptr, default_chunks(device, dtype, nb, cap)
            if n_chunks is None else n_chunks)
        self.i1 = torch.as_tensor(i1p, device=device)
        self.i2 = torch.as_tensor(i2p, device=device)
        self.row_ptr = torch.as_tensor(row_ptr.astype(np.int32),
                                       device=device)
        self.chunk_ptr = torch.as_tensor(chunk_ptr, device=device)
        self.n_campair = n_campair
        self.n_chunks = len(chunk_ptr) - 1
        self.n_rows = n_pad_pairs // cap
        self.n_pairs = len(cp)
        self.pad_ratio = n_pad_pairs / max(len(cp), 1)

    def __call__(self, Yf, fb):
        """(n_campair, fb.d_out) fill-in sums of the flat product `fb`
        (a FlatBilinear) over each camera pair's observation pairs."""
        return pair_bucket_acc(Yf, self.i1, self.i2, self.row_ptr,
                               fb.table(Yf.device), fb.d_out, fb.g,
                               self.cap, self.chunk_ptr)
