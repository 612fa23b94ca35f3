"""Tiny-matrix linear algebra, unrolled into elementwise arithmetic.

XLA lowers batched ``jnp.linalg.solve`` / ``cholesky`` on tiny matrices to
LAPACK-style loops or library calls with per-matrix overheads.  For the static, single-digit sizes of
this framework (nu <= 5, nx <= 9) a fully unrolled Cholesky factorization +
triangular solves compile to straight-line elementwise arithmetic that XLA
fuses into the surrounding scan step.

All functions take leading batch dimensions and a static trailing (n, n) /
(n, m) shape.
"""

from __future__ import annotations

import jax.numpy as jnp


def chol_solve_unrolled(A, B):
    """Solve A X = B for SPD A with static tiny n, unrolled.

    A: (..., n, n) symmetric positive definite;  B: (..., n, m).
    Returns X: (..., n, m).  Equivalent to jnp.linalg.solve (tested), but
    compiles to fused elementwise ops instead of a LAPACK call.
    """
    n = A.shape[-1]
    m = B.shape[-1]

    # Cholesky A = L L^T, scalar-unrolled
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]

    # forward substitution L Y = B
    Y = [[None] * m for _ in range(n)]
    for c in range(m):
        for i in range(n):
            s = B[..., i, c]
            for k in range(i):
                s = s - L[i][k] * Y[k][c]
            Y[i][c] = s / L[i][i]

    # back substitution L^T X = Y
    X = [[None] * m for _ in range(n)]
    for c in range(m):
        for i in reversed(range(n)):
            s = Y[i][c]
            for k in range(i + 1, n):
                s = s - L[k][i] * X[k][c]
            X[i][c] = s / L[i][i]

    return jnp.stack([jnp.stack([X[i][c] for c in range(m)], axis=-1)
                      for i in range(n)], axis=-2)
