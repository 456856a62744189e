"""Flat-lane block algebra (counterpart of dbat_tpu/solve/flatsel.py).

Batched arrays of tiny blocks — (n, 2, nb) Jacobian blocks, (n, nb, nb)
outer products — are kept as flat (n, d) rows, and every small
bilinear block product is written as one term table:

    out[n, o] = sum_g  A[n, ia(o,g)] * B[n, ib(o,g)]

The JAX package evaluates it as two one-hot "select" matmuls for the
TPU's matrix unit; the port indexes the table directly, in kernel A
(solve/kernels.py) on the card and in its plain PyTorch version (a
gather, a product and a group sum) on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import fused_bilinear


class FlatBilinear:
    """out[n, iout] = sum over terms (ia, ib, iout): A[n,ia] * B[n,ib].

    `terms` is a (T, 3) int array of (ia, ib, iout) with every output
    index appearing the same number of times `g`, grouped contiguously
    (term t writes to iout = t // g).  Build with the *_terms helpers.
    """

    def __init__(self, d_a: int, d_b: int, terms: np.ndarray, d_out: int):
        terms = np.asarray(terms)
        T = len(terms)
        if T % d_out:
            raise ValueError("terms must divide evenly into outputs")
        g = T // d_out
        expect = np.repeat(np.arange(d_out), g)
        if not np.array_equal(terms[:, 2], expect):
            raise ValueError("terms must be grouped contiguously by iout")
        if (terms[:, :2].min(initial=0) < 0 or terms[:, 0].max() >= d_a
                or terms[:, 1].max() >= d_b):
            raise ValueError("term index outside the operand width")
        self.d_a, self.d_b = d_a, d_b
        self.d_out = d_out
        self.g = g
        #: (d_out, g, 2) int32 table of (ia, ib) per output and term
        self.table_np = np.ascontiguousarray(
            terms[:, :2].reshape(d_out, g, 2).astype(np.int32))
        self._tables = {}

    def table(self, device) -> torch.Tensor:
        """The term table as an int32 tensor on `device` (cached)."""
        key = str(torch.device(device))
        t = self._tables.get(key)
        if t is None:
            t = torch.as_tensor(self.table_np, device=device)
            self._tables[key] = t
        return t

    def __call__(self, Af, Bf):
        if Af.shape[1] != self.d_a or Bf.shape[1] != self.d_b:
            raise ValueError(
                f"operand widths {Af.shape[1]}, {Bf.shape[1]} != "
                f"{self.d_a}, {self.d_b}")
        return fused_bilinear(Af, Bf, self.table(Af.device), self.d_out,
                              self.g)


def matmul_terms(m: int, k: int, p: int):
    """Terms for flat C = A @ B with A (n, m, k), B (n, k, p) blocks:
    C[a,c] = sum_b A[a,b] B[b,c]; all flattened row-major."""
    a, c, b = np.meshgrid(np.arange(m), np.arange(p), np.arange(k),
                          indexing="ij")
    ia = (a * k + b).ravel()
    ib = (b * p + c).ravel()
    iout = (a * p + c).ravel()
    return np.stack([ia, ib, iout], axis=1)


def abt_terms(m: int, k: int, p: int):
    """Terms for flat C = A @ B^T with A (n, m, k), B (n, p, k) blocks:
    C[a,c] = sum_b A[a,b] B[c,b]; C flattened (m*p)."""
    a, c, b = np.meshgrid(np.arange(m), np.arange(p), np.arange(k),
                          indexing="ij")
    ia = (a * k + b).ravel()
    ib = (c * k + b).ravel()
    iout = (a * p + c).ravel()
    return np.stack([ia, ib, iout], axis=1)


def ata_terms(k: int, m: int):
    """Terms for flat C = A^T @ A with A (n, k, m) blocks, C (m*m):
    C[a,b] = sum_t A[t,a] A[t,b]."""
    a, b, t = np.meshgrid(np.arange(m), np.arange(m), np.arange(k),
                          indexing="ij")
    ia = (t * m + a).ravel()
    ib = (t * m + b).ravel()
    iout = (a * m + b).ravel()
    return np.stack([ia, ib, iout], axis=1)


def atb_terms(k: int, m: int, p: int):
    """Terms for flat C = A^T @ B with A (n, k, m), B (n, k, p):
    C[a,b] = sum_t A[t,a] B[t,b]; C flattened (m*p)."""
    a, b, t = np.meshgrid(np.arange(m), np.arange(p), np.arange(k),
                          indexing="ij")
    ia = (t * m + a).ravel()
    ib = (t * p + b).ravel()
    iout = (a * p + b).ravel()
    return np.stack([ia, ib, iout], axis=1)
