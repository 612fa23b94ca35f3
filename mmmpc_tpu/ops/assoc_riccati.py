"""Associative-scan (parallel-prefix) Riccati backward pass.

The iLQR backward sweep is a sequential recursion in the horizon — fine at
N=20, but for long-horizon studies (N in the hundreds/thousands) the O(N)
depth itself becomes the bottleneck at small batch: every sequential step
is a dependent round while the rest of the device idles.  This module reformulates the backward pass as an
associative operation and evaluates it with jax.lax.associative_scan in
O(log N) depth — the control-horizon analogue of sequence parallelism
(SURVEY.md §5: the reference's horizon is a Python for-loop over CasADi
expressions, mpc_wholebody_qref.py:177-227).

Method (temporal parallelization of LQT, Särkkä & García-Fernández):
a conditional value-function element over an interval [i, j) is the
quadratic kernel

    V_{i->j}(x_i, x_j) = indicator(x_j = A x_i + b  +  "C-weighted slack")
                         + 1/2 x_iᵀ J x_i - ηᵀ x_i

parameterized by e = (A, b, C, η, J); composing two adjacent intervals is
associative:

    M  = (I + C₁ J₂)⁻¹
    A  = A₂ M A₁
    b  = A₂ M (b₁ + C₁ η₂') + b₂         with η₂' s.t. signs below
    C  = A₂ M C₁ A₂ᵀ + C₂
    η  = A₁ᵀ Mᵀ (η₂ - J₂ b₁) + η₁
    J  = A₁ᵀ Mᵀ J₂ A₁ + J₁

Stage elements come from the Gauss-Newton expansion after eliminating the
control and the cross term (complete the square in u); the terminal element
is (0, 0, 0, -g_N, H_N).  The suffix combination starting at k yields
V_k(δx) = 1/2 δxᵀ J δx - ηᵀ δx, i.e. Vxx_k = J_k, Vx_k = -η_k, after which
the per-stage gains are recovered for ALL stages in parallel.

Matches solver/al_ilqr.py::backward_scan to float tolerance (the sequential
sweep applies the Levenberg regularization only inside the gain solve; here
it also regularizes the u-elimination — identical as reg -> 0, asserted at
reg = 1e-8 in tests/test_assoc_riccati.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _combine(e1, e2):
    """Compose adjacent interval elements (earlier, later) — associative."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    nx = A1.shape[-1]
    I = jnp.eye(nx, dtype=A1.dtype)
    # (I + C1 J2)^-1 solved once, reused transposed
    M = jnp.linalg.solve(I + C1 @ J2, I)
    AM = A2 @ M
    A = AM @ A1
    b = AM @ (b1 + C1 @ eta2) + b2
    C = AM @ C1 @ jnp.swapaxes(A2, -1, -2) + C2
    AtMt = jnp.swapaxes(M @ A1, -1, -2)
    eta = AtMt @ (eta2 - J2 @ b1) + eta1
    J = AtMt @ J2 @ A1 + J1
    J = 0.5 * (J + jnp.swapaxes(J, -1, -2))
    return (A, b, C, eta, J)


def _combine_batched(e1, e2):
    return jax.vmap(_combine)(e1, e2)


def assoc_riccati_backward(lx, lu, lxx, luu, lux, A, B, term_g, term_H,
                           reg=0.0):
    """Backward pass in O(log N) depth.  Single scenario:

    lx (N,nx), lu (N,nu), lxx (N,nx,nx), luu (N,nu,nu), lux (N,nu,nx),
    A (N,nx,nx), B (N,nx,nu), term_g (nx,), term_H (nx,nx).
    Returns (kff (N,nu), K (N,nu,nx)) — same contract as backward_scan.
    """
    N, nx = lx.shape
    nu = lu.shape[-1]
    dtype = lx.dtype
    Iu = jnp.eye(nu, dtype=dtype)

    # eliminate u (and the cross term) stage-wise: all stages in parallel
    luu_r = luu + reg * Iu
    Kc = jnp.linalg.solve(luu_r, lux)                  # (N, nu, nx)
    kc = jnp.linalg.solve(luu_r, lu[..., None])[..., 0]  # (N, nu)
    F = A - jnp.einsum("kxu,kuy->kxy", B, Kc)
    b = -jnp.einsum("kxu,ku->kx", B, kc)
    C = jnp.einsum("kxu,kuy->kxy", B,
                   jnp.linalg.solve(luu_r, jnp.swapaxes(B, -1, -2)))
    lx_eff = lx - jnp.einsum("kux,ku->kx", Kc, lu)
    lxx_eff = lxx - jnp.einsum("kux,kuy->kxy", Kc, lux)
    lxx_eff = 0.5 * (lxx_eff + jnp.swapaxes(lxx_eff, -1, -2))

    # elements: stages 0..N-1 then the terminal element
    zx = jnp.zeros((1, nx, nx), dtype)
    elems = (
        jnp.concatenate([F, zx], axis=0),
        jnp.concatenate([b, jnp.zeros((1, nx), dtype)], axis=0),
        jnp.concatenate([C, zx], axis=0),
        jnp.concatenate([-lx_eff, -term_g[None]], axis=0),
        jnp.concatenate([lxx_eff, term_H[None]], axis=0),
    )
    # suffix combinations: reverse, scan, reverse back
    rev = jax.tree.map(lambda a: a[::-1], elems)

    def comb(ea, eb):
        # associative_scan composes left-to-right on the reversed sequence,
        # i.e. later intervals first — swap back to (earlier, later)
        return _combine_batched(eb, ea)

    suffix = jax.lax.associative_scan(comb, rev)
    _, _, _, eta_s, J_s = jax.tree.map(lambda a: a[::-1], suffix)
    # V at stage k+1 for k = 0..N-1 is the suffix starting at k+1
    Vx = -eta_s[1:]                                     # (N, nx)
    Vxx = J_s[1:]                                       # (N, nx, nx)

    # gains for every stage in parallel (same formulas as backward_scan)
    Bt = jnp.swapaxes(B, -1, -2)
    Qu = lu + jnp.einsum("kux,kx->ku", Bt, Vx)
    VB = jnp.einsum("kxy,kyu->kxu", Vxx, B)
    Quu = luu + jnp.einsum("kux,kxv->kuv", Bt, VB)
    VA = jnp.einsum("kxy,kyz->kxz", Vxx, A)
    Qux = lux + jnp.einsum("kux,kxz->kuz", Bt, VA)
    sol = jnp.linalg.solve(Quu + reg * Iu,
                           jnp.concatenate([Qu[..., None], Qux], axis=-1))
    return -sol[..., 0], -sol[..., 1:]


def assoc_riccati_backward_batched(lx, lu, lxx, luu, lux, A, B,
                                   term_g, term_H, reg=0.0):
    """vmap over a leading batch axis (batch-major, like riccati_backward)."""
    return jax.vmap(
        lambda *a: assoc_riccati_backward(*a, reg=reg))(
            lx, lu, lxx, luu, lux, A, B, term_g, term_H)
