"""Associative-scan Riccati vs the sequential backward sweep."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmmpc_tpu.ops.assoc_riccati import (
    assoc_riccati_backward, assoc_riccati_backward_batched,
)
from mmmpc_tpu.solver.linalg_small import chol_solve_unrolled


def reference_backward(lx, lu, lxx, luu, lux, A, Bm, tg, tH, reg):
    """Same recursion as solver/al_ilqr.py's bwd scan (batch-major)."""
    nu = lu.shape[-1]
    eye_u = jnp.eye(nu, dtype=lx.dtype)

    def single(lx, lu, lxx, luu, lux, A, Bm, tg, tH):
        def step(carry, inp):
            Vx, Vxx = carry
            lx_k, lu_k, lxx_k, luu_k, lux_k, A_k, B_k = inp
            Qx = lx_k + A_k.T @ Vx
            Qu = lu_k + B_k.T @ Vx
            Qxx = lxx_k + A_k.T @ Vxx @ A_k
            Quu = luu_k + B_k.T @ Vxx @ B_k
            Qux = lux_k + B_k.T @ Vxx @ A_k
            sol = chol_solve_unrolled(
                Quu + reg * eye_u,
                jnp.concatenate([Qu[:, None], Qux], axis=1))
            kff = -sol[:, 0]
            K = -sol[:, 1:]
            Vx_n = Qx + K.T @ Quu @ kff + K.T @ Qu + Qux.T @ kff
            Vxx_n = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
            Vxx_n = 0.5 * (Vxx_n + Vxx_n.T)
            return (Vx_n, Vxx_n), (kff, K)

        (_, _), (kffs, Ks) = jax.lax.scan(
            step, (tg, tH),
            jax.tree.map(lambda a: a[::-1], (lx, lu, lxx, luu, lux, A, Bm)))
        return kffs[::-1], Ks[::-1]

    return jax.vmap(single)(lx, lu, lxx, luu, lux, A, Bm, tg, tH)

def make_problem(B, N, nx, nu, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return jnp.asarray(rng.standard_normal(s))

    lx, lu = mk(B, N, nx), mk(B, N, nu)
    lxx = mk(B, N, nx, nx)
    lxx = lxx @ jnp.swapaxes(lxx, -1, -2) + 5 * jnp.eye(nx)
    luu = mk(B, N, nu, nu)
    luu = luu @ jnp.swapaxes(luu, -1, -2) + 5 * jnp.eye(nu)
    lux = 0.3 * mk(B, N, nu, nx)
    A = mk(B, N, nx, nx) * 0.1 + jnp.eye(nx)
    Bm = mk(B, N, nx, nu) * 0.1
    tg = mk(B, nx)
    tH = mk(B, nx, nx)
    tH = tH @ jnp.swapaxes(tH, -1, -2) + 5 * jnp.eye(nx)
    return lx, lu, lxx, luu, lux, A, Bm, tg, tH


def test_assoc_matches_sequential():
    args = make_problem(B=4, N=16, nx=9, nu=5)
    reg = 1e-8
    kff_ref, K_ref = reference_backward(*args, reg)
    kff, K = assoc_riccati_backward_batched(*args, reg=reg)
    np.testing.assert_allclose(np.asarray(kff), np.asarray(kff_ref),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(K), np.asarray(K_ref),
                               rtol=1e-6, atol=1e-7)


def test_assoc_long_horizon():
    """N = 512: the sequential sweep's depth-bound regime; results must stay
    finite and match the sequential recursion."""
    args = make_problem(B=2, N=512, nx=4, nu=2, seed=3)
    reg = 1e-8
    kff_ref, K_ref = reference_backward(*args, reg)
    kff, K = assoc_riccati_backward_batched(*args, reg=reg)
    np.testing.assert_allclose(np.asarray(kff), np.asarray(kff_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(K), np.asarray(K_ref),
                               rtol=1e-5, atol=1e-6)


def test_assoc_single_scenario_jits():
    args = make_problem(B=1, N=8, nx=3, nu=2, seed=5)
    single = jax.tree.map(lambda a: a[0], tuple(args))
    kff, K = jax.jit(lambda *a: assoc_riccati_backward(*a, reg=1e-8))(
        *single)
    kff_ref, K_ref = reference_backward(*args, 1e-8)
    np.testing.assert_allclose(np.asarray(kff), np.asarray(kff_ref[0]),
                               rtol=1e-6, atol=1e-7)


def test_solver_switch_end_to_end():
    """SolverConfig.use_assoc_scan must drive the full AL-iLQR solve through
    the parallel-prefix backward pass and land on the sequential path's
    solution (the long-horizon capability is reachable
    from the production entry point, not just a module)."""
    from tests.test_solver import make_demo_ocp
    from mmmpc_tpu.solver import al_ilqr_solve
    from mmmpc_tpu.utils.configs import SolverConfig

    N = 40
    ocp = make_demo_ocp(N=N)
    params = {"X_ref": jnp.tile(jnp.array([3.0, 0.0]), (N + 1, 1)),
              "U_ref": jnp.zeros((N, 1))}
    x0 = jnp.array([0.0, 0.0])
    U0 = jnp.zeros((N, 1))
    cfg_seq = SolverConfig(al_iters=6, ilqr_iters=10)
    cfg_par = SolverConfig(al_iters=6, ilqr_iters=10, use_assoc_scan=True)
    res_seq = al_ilqr_solve(ocp, x0, U0, params, cfg_seq)
    res_par = al_ilqr_solve(ocp, x0, U0, params, cfg_par)
    assert bool(res_par.converged)
    np.testing.assert_allclose(np.asarray(res_par.U), np.asarray(res_seq.U),
                               atol=1e-6)
    np.testing.assert_allclose(float(res_par.cost), float(res_seq.cost),
                               rtol=1e-8)


def test_assoc_scan_auto_selection():
    """The scan-vs-assoc choice: "auto" is the sequential scan (no crossover
    measured on the GPU), True and False force a path, and a misspelt mode
    is an error rather than a silent choice."""
    from mmmpc_tpu.solver.al_ilqr import resolve_assoc_scan
    from mmmpc_tpu.utils.configs import SolverConfig

    auto = SolverConfig()                      # default "auto"
    assert auto.use_assoc_scan == "auto"
    assert not resolve_assoc_scan(auto)
    assert not resolve_assoc_scan(SolverConfig(use_assoc_scan=False))
    assert resolve_assoc_scan(SolverConfig(use_assoc_scan=True))
    with pytest.raises(ValueError):
        resolve_assoc_scan(SolverConfig(use_assoc_scan="Auto"))
