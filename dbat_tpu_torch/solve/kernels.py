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
Each wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

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


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# Kernel A
# ---------------------------------------------------------------------------

def fused_bilinear_plain(Af, Bf, table, d_out: int, g: int):
    """Plain version of kernel A: gather, multiply, group sum."""
    ia = table[..., 0].reshape(-1).long()
    ib = table[..., 1].reshape(-1).long()
    prod = Af[:, ia] * Bf[:, ib]
    return prod.reshape(Af.shape[0], d_out, g).sum(-1)


class FusedBilinear:
    """Wrapper of kernel A.  `table` is the (d_out, g, 2) int32 (ia, ib)
    table of a FlatBilinear, on the operands' device."""

    name = "fused_bilinear"
    source = "dbat_tpu_torch/csrc/fused_bilinear.cu"
    replaces = "dbat_tpu/solve/pallas_kernels.py:84"

    def __init__(self):
        self.launches = 0

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
        from .. import build

        fn = getattr(build.load(),
                     f"dbat_fused_bilinear_{_KERNEL_DTYPES[dtype]}")
        with torch.cuda.device(Af.device):
            stream = torch.cuda.current_stream().cuda_stream
            _launch(fn, Af.data_ptr(), Bf.data_ptr(), table.data_ptr(),
                    out.data_ptr(), n, Af.shape[1], Bf.shape[1], d_out, g,
                    stream)
        self.launches += 1
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


class PairBucketAcc:
    """Wrapper of kernel B.  i1/i2: (n_rows*cap,) int32 pair operands
    (an index outside [0, n_obs) is a pad pair); row_ptr:
    (n_campair+1,) int32 offsets of each camera pair's bucket rows."""

    name = "pair_bucket_acc"
    source = "dbat_tpu_torch/csrc/pair_bucket.cu"
    replaces = "dbat_tpu/solve/pallas_kernels.py:129"

    def __init__(self):
        self.launches = 0

    def __call__(self, Yf, i1, i2, row_ptr, table, d_out: int, g: int,
                 cap: int):
        if _on_cpu(Yf, i1, i2, row_ptr, table):
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
        if (i1.shape != i2.shape or i1.shape[0] % cap
                or table.shape != (d_out, g, 2) or not 1 <= d_out <= 1024
                or n_campair < 0):
            raise ValueError(
                f"pair_bucket_acc: shapes i1 {tuple(i1.shape)}, i2 "
                f"{tuple(i2.shape)}, row_ptr {tuple(row_ptr.shape)}, table "
                f"{tuple(table.shape)} for d_out={d_out}, g={g}, cap={cap}")
        out = torch.empty((n_campair, d_out), dtype=dtype, device=Yf.device)
        if n_campair == 0:
            return out
        from .. import build

        fn = getattr(build.load(),
                     f"dbat_pair_bucket_acc_{_KERNEL_DTYPES[dtype]}")
        with torch.cuda.device(Yf.device):
            stream = torch.cuda.current_stream().cuda_stream
            _launch(fn, Yf.data_ptr(), Yf.shape[0], Yf.shape[1],
                    i1.data_ptr(), i2.data_ptr(), row_ptr.data_ptr(),
                    n_campair, table.data_ptr(), out.data_ptr(), d_out, g,
                    cap, stream)
        self.launches += 1
        return out


pair_bucket_acc = PairBucketAcc()

#: every kernel wrapper of the port
KERNELS = (fused_bilinear, pair_bucket_acc)


class PairBucketPlan:
    """Host-side plan for the S fill-in: observation pairs sorted by
    camera pair, padded per camera pair to a multiple of `cap`.

    Pad pairs index n_obs (outside Y), so they contribute nothing.
    Unlike the TPU plan the bucket rows are not padded to a tile
    multiple: kernel B walks each camera pair's rows through row_ptr.
    """

    def __init__(self, i1, i2, cp_sorted, n_campair: int, n_obs: int,
                 cap: int = 16, device="cpu"):
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
        self.i1 = torch.as_tensor(i1p, device=device)
        self.i2 = torch.as_tensor(i2p, device=device)
        self.row_ptr = torch.as_tensor(row_ptr.astype(np.int32),
                                       device=device)
        self.n_campair = n_campair
        self.n_rows = n_pad_pairs // cap
        self.n_pairs = len(cp)
        self.pad_ratio = n_pad_pairs / max(len(cp), 1)

    def __call__(self, Yf, fb):
        """(n_campair, fb.d_out) fill-in sums of the flat product `fb`
        (a FlatBilinear) over each camera pair's observation pairs."""
        return pair_bucket_acc(Yf, self.i1, self.i2, self.row_ptr,
                               fb.table(Yf.device), fb.d_out, fb.g,
                               self.cap)
