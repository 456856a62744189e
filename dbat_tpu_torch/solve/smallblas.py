"""Closed-form batched 3x3 kernels (counterpart of
dbat_tpu/solve/smallblas.py).

The point blocks V of the reduced system are 3x3.  Closed-form
adjugate inverse and Cholesky are pure elementwise arithmetic over the
batch, with no per-matrix library calls and no pivoting; they are what
the JAX package computes, so the two agree to roundoff.
"""

from __future__ import annotations

import torch


def inv3x3(V):
    """Batched inverse of (..., 3, 3) matrices via the adjugate."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    adj = torch.stack([A00, A01, A02, A10, A11, A12, A20, A21, A22], -1)
    return adj.reshape(V.shape) / det[..., None, None]


def chol3x3(V):
    """Batched lower Cholesky factor of SPD (..., 3, 3) matrices."""
    a, b, c = V[..., 0, 0], V[..., 1, 0], V[..., 2, 0]
    e, f, i = V[..., 1, 1], V[..., 2, 1], V[..., 2, 2]
    l11 = torch.sqrt(a)
    l21 = b / l11
    l31 = c / l11
    l22 = torch.sqrt(e - l21 * l21)
    l32 = (f - l31 * l21) / l22
    l33 = torch.sqrt(i - l31 * l31 - l32 * l32)
    z = torch.zeros_like(a)
    L = torch.stack([l11, z, z, l21, l22, z, l31, l32, l33], -1)
    return L.reshape(V.shape)
