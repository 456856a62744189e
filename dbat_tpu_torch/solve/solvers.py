"""Solver status codes and result record (counterpart of the head of
dbat_tpu/solve/solvers.py).

Status codes follow the reference (gauss_newton_armijo.m:38-46):
0 OK / -1 too many iterations / -2 singular normal matrix / -3 line
search failed / -4 structurally rank-deficient Jacobian.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

OK = 0
TOO_MANY_ITERS = -1
SINGULAR = -2
LINESEARCH_FAILED = -3
STRUCT_RANK_DEFICIENT = -4

#: Linesearch failure with ||Jp|| within this factor of the
#: termination threshold counts as converged-at-the-numerical-floor.
FLOOR_FACTOR = 100.0


@dataclass
class SolveResult:
    x: np.ndarray
    code: int
    iters: int
    res_norms: list = field(default_factory=list)  # ||r_w|| per iteration
    trace: list = field(default_factory=list)  # successive x estimates
    damping: dict = field(default_factory=dict)
    final_rw: np.ndarray = None
    final_p: np.ndarray = None

    @property
    def ok(self) -> bool:
        return self.code == OK
