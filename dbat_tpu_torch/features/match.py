"""Pairwise descriptor matching (counterpart of
dbat_tpu/features/match.py).

Unit descriptors make cosine similarity a single (max_kp x d) @
(d x max_kp) matmul per image pair (float32, TF32 off); mutual nearest
neighbours with a Lowe ratio test on the top-2 similarities.  All pairs
are matched in one batched call on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .detect import _tensor


def _match_sim(d1, v1, d2, v2, ratio):
    """Match batched descriptor set pairs d1 (m, k1, d), d2 (m, k2, d);
    returns (idx2 per kp1, ok mask, best similarity), each (m, k1)."""
    S = torch.bmm(d1, d2.transpose(1, 2))  # cosine similarity
    S = torch.where(v1[:, :, None] & v2[:, None, :], S,
                    torch.full_like(S, -2.0))
    # Lowe ratio on distance: d^2 = 2 - 2s  =>  require
    # (2-2*s1) < r^2 * (2-2*s2)  with s1 best, s2 runner-up.
    top2, idx = torch.topk(S, 2, dim=2)
    s1, s2 = top2[..., 0], top2[..., 1]
    best2 = idx[..., 0]
    d1sq = 2.0 - 2.0 * s1
    d2sq = 2.0 - 2.0 * s2
    pass_ratio = d1sq < (ratio * ratio) * d2sq
    # Mutual nearest: kp1 must also be kp2's best (the first maximum).
    back = torch.argmax(S, dim=1)  # (m, k2)
    mutual = torch.gather(back, 1, best2) == torch.arange(
        S.shape[1], device=S.device)
    ok = v1 & pass_ratio & mutual & (s1 > -1.0)
    return best2, ok, s1


def _inputs(desc, valid, device):
    return _tensor(desc, device, torch.float32), _tensor(valid, device)


def match_pair(desc1, valid1, desc2, valid2, ratio: float = 0.9,
               device=None):
    """Match two images' descriptors on `device` (default: the card).

    Returns (i1, i2) numpy index arrays of matched keypoint slots."""
    device = resolve_device(device)
    d1, v1 = _inputs(desc1, valid1, device)
    d2, v2 = _inputs(desc2, valid2, device)
    r = torch.tensor(ratio, dtype=torch.float32, device=device)
    best2, ok, _s = _match_sim(d1[None], v1[None], d2[None], v2[None], r)
    i1 = np.flatnonzero(ok[0].cpu().numpy())
    return i1, best2[0].cpu().numpy()[i1]


def match_all_pairs(desc, valid, pairs=None, ratio: float = 0.9,
                    device=None):
    """Match every image pair in one batched call on `device` (default:
    the card).

    desc (n, max_kp, d); valid (n, max_kp); pairs: optional (m, 2) int
    array (default: all n*(n-1)/2 combinations).  Returns a dict
    {(i, j): (i1, i2, sim)} of matched slot indices + similarity per
    pair (numpy)."""
    device = resolve_device(device)
    desc, valid = _inputs(desc, valid, device)
    n = desc.shape[0]
    if pairs is None:
        pi, pj = np.triu_indices(n, k=1)
        pairs = np.stack([pi, pj], axis=1)
    pairs = np.asarray(pairs)
    pi = torch.as_tensor(pairs[:, 0], dtype=torch.int64, device=device)
    pj = torch.as_tensor(pairs[:, 1], dtype=torch.int64, device=device)
    r = torch.tensor(ratio, dtype=torch.float32, device=device)
    best2, ok, s1 = _match_sim(desc[pi], valid[pi], desc[pj], valid[pj], r)
    best2 = best2.cpu().numpy()
    ok = ok.cpu().numpy()
    s1 = s1.cpu().numpy()
    out = {}
    for k, (i, j) in enumerate(pairs):
        i1 = np.flatnonzero(ok[k])
        if len(i1):
            out[(int(i), int(j))] = (i1, best2[k][i1], s1[k][i1])
    return out
