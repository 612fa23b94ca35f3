"""AL-iLQR solver validation against analytic LQR and the scipy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmmpc_tpu.models import point_mass_step, base_step
from mmmpc_tpu.ocp import OCP
from mmmpc_tpu.solver import al_ilqr_solve, rollout
from mmmpc_tpu.utils.configs import SolverConfig
from mmmpc_tpu.utils.math import safe_dist
from mmmpc_tpu.verify import scipy_solve

DT = 0.1


def make_demo_ocp(N=10, vlim=(-1.0, 1.0), alim=(-5.0, 5.0)):
    """The reference's 1-D demo MPC (controllers/mpc_demo.py): double
    integrator, Q=diag(1,0), R=diag(0.1), P=Q, velocity box as a hard state
    constraint, acceleration box on the input."""
    Q = jnp.diag(jnp.array([1.0, 0.0]))
    R = jnp.diag(jnp.array([0.1]))

    def stage(x, u, k, p):
        ex = x - p["X_ref"][k]
        eu = u - p["U_ref"][k]
        return ex @ Q @ ex + eu @ R @ eu

    def term(x, p):
        ex = x - p["X_ref"][N]
        return ex @ Q @ ex

    def stage_ineq(x, u, k, p):
        return jnp.stack([x[1] - vlim[1], vlim[0] - x[1]])

    def term_ineq(x, p):
        return jnp.stack([x[1] - vlim[1], vlim[0] - x[1]])

    return OCP(nx=2, nu=1, N=N,
               dynamics=lambda x, u: point_mass_step(x, u, DT),
               stage_cost=stage, terminal_cost=term,
               stage_ineq=stage_ineq, terminal_ineq=term_ineq,
               u_lower=jnp.array([alim[0]]), u_upper=jnp.array([alim[1]]))


def test_lqr_exactness():
    """Unconstrained linear-quadratic problem: iLQR must match the Riccati
    solution computed independently by dynamic programming in numpy."""
    N = 15
    A = np.array([[1.0, DT], [0.0, 1.0]])
    B = np.array([[0.0], [DT]])
    Q = np.diag([1.0, 0.0])
    R = np.diag([0.1])
    x0 = np.array([2.0, -1.0])

    # numpy Riccati recursion (tracking 0)
    P = Q.copy()
    Ks = []
    for _ in range(N):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P = Q + A.T @ P @ (A - B @ K)
        Ks.append(K)
    Ks = Ks[::-1]
    xs = [x0]
    us = []
    for k in range(N):
        u = -Ks[k] @ xs[-1]
        us.append(u)
        xs.append(A @ xs[-1] + B @ u)
    U_np = np.array(us)

    def stage(x, u, k, p):
        return x @ jnp.asarray(Q) @ x + u @ jnp.asarray(R) @ u

    def term(x, p):
        return x @ jnp.asarray(Q) @ x

    ocp = OCP(nx=2, nu=1, N=N,
              dynamics=lambda x, u: point_mass_step(x, u, DT),
              stage_cost=stage, terminal_cost=term)
    res = al_ilqr_solve(ocp, jnp.asarray(x0), jnp.zeros((N, 1)), {},
                        SolverConfig(al_iters=1, ilqr_iters=5))
    np.testing.assert_allclose(np.asarray(res.U), U_np, atol=1e-8)


def test_demo_mpc_matches_scipy_oracle():
    """Velocity-limited point-to-point move: the JAX solver and scipy
    trust-constr must find the same control sequence."""
    N = 10
    ocp = make_demo_ocp(N=N)
    params = {"X_ref": jnp.tile(jnp.array([3.0, 0.0]), (N + 1, 1)),
              "U_ref": jnp.zeros((N, 1))}
    x0 = jnp.array([0.0, 0.0])
    U0 = jnp.zeros((N, 1))

    res = al_ilqr_solve(ocp, x0, U0, params,
                        SolverConfig(al_iters=8, ilqr_iters=15))
    U_oracle, X_oracle, cost_oracle, sres = scipy_solve(ocp, x0, U0, params)

    assert bool(res.converged)
    # same objective to 1e-6 relative, controls within 2e-3
    np.testing.assert_allclose(float(res.cost), cost_oracle,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(res.U), np.asarray(U_oracle),
                               atol=2e-3)
    # velocity limit actually active and respected
    assert float(jnp.max(res.X[:, 1])) <= 1.0 + 1e-5
    assert float(jnp.max(res.X[:, 1])) > 0.9


def make_base_obstacle_ocp(N=12):
    """Diff-drive base point-tracking with one ground obstacle as the exact
    slack penalty (the reference MPCBase formulation, mpc_base.py)."""
    Q = jnp.diag(jnp.array([5.0, 5.0, 0.0, 0.0, 0.0, 1.0]))
    R = jnp.diag(jnp.array([1.0, 1.0]))
    M = 1e5
    obs = jnp.array([1.0, 0.05, 0.3])   # x, y, radius
    base_radius = 0.4

    def slack_pen(x):
        g = (obs[2] + base_radius) - safe_dist(x[0] - obs[0], x[1] - obs[1])
        return M * jnp.maximum(0.0, g) ** 2

    def stage(x, u, k, p):
        ex = x - p["X_ref"][k]
        eu = u - p["U_ref"][k]
        return ex @ Q @ ex + eu @ R @ eu + slack_pen(x)

    def term(x, p):
        ex = x - p["X_ref"][N]
        return ex @ Q @ ex + slack_pen(x)

    vlim = 2.0

    def stage_ineq(x, u, k, p):
        return jnp.stack([x[3] - vlim, -vlim - x[3],
                          x[4] - vlim, -vlim - x[4],
                          x[5] - jnp.pi, -jnp.pi - x[5]])

    def term_ineq(x, p):
        return stage_ineq(x, None, None, p)

    return OCP(nx=6, nu=2, N=N,
               dynamics=lambda x, u: base_step(x, u, DT),
               stage_cost=stage, terminal_cost=term,
               stage_ineq=stage_ineq, terminal_ineq=term_ineq,
               u_lower=jnp.array([-2.0, -jnp.pi]),
               u_upper=jnp.array([2.0, jnp.pi]))


def test_base_obstacle_matches_scipy_oracle():
    N = 12
    ocp = make_base_obstacle_ocp(N=N)
    x_ref = jnp.tile(jnp.array([2.0, 0.0, 0.0, 0.0, 0.0, 0.0]), (N + 1, 1))
    params = {"X_ref": x_ref, "U_ref": jnp.zeros((N, 2))}
    x0 = jnp.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    U0 = jnp.zeros((N, 2))

    res = al_ilqr_solve(ocp, x0, U0, params,
                        SolverConfig(al_iters=8, ilqr_iters=20))
    U_oracle, X_oracle, cost_oracle, sres = scipy_solve(
        ocp, x0, U0, params, maxiter=3000)

    np.testing.assert_allclose(float(res.cost), cost_oracle,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.U), np.asarray(U_oracle),
                               atol=5e-3)


def test_terminal_equality():
    """The FSM-injected hard terminal equality (interface:167) must be
    enforced when its runtime mask is on and ignored when off."""
    N = 10
    base = make_demo_ocp(N=N)

    def term_eq(x, p):
        return p["eq_mask"] * (x[:1] - p["X_ref"][N, :1])

    ocp = OCP(nx=2, nu=1, N=N, dynamics=base.dynamics,
              stage_cost=base.stage_cost, terminal_cost=base.terminal_cost,
              stage_ineq=base.stage_ineq, terminal_ineq=base.terminal_ineq,
              terminal_eq=term_eq, u_lower=base.u_lower, u_upper=base.u_upper)
    params = {"X_ref": jnp.tile(jnp.array([0.8, 0.0]), (N + 1, 1)),
              "U_ref": jnp.zeros((N, 1)), "eq_mask": jnp.array([1.0])}
    x0 = jnp.array([0.0, 0.0])
    res_on = al_ilqr_solve(ocp, x0, jnp.zeros((N, 1)), params,
                           SolverConfig(al_iters=10, ilqr_iters=15))
    assert abs(float(res_on.X[-1, 0]) - 0.8) < 1e-4

    params_off = dict(params, eq_mask=jnp.array([0.0]))
    res_off = al_ilqr_solve(ocp, x0, jnp.zeros((N, 1)), params_off,
                            SolverConfig(al_iters=10, ilqr_iters=15))
    # without the equality the tracking solution stops short
    assert float(res_off.X[-1, 0]) < 0.8 - 1e-3


def test_solver_is_jittable_and_vmappable():
    N = 10
    ocp = make_demo_ocp(N=N)
    params = {"X_ref": jnp.tile(jnp.array([3.0, 0.0]), (N + 1, 1)),
              "U_ref": jnp.zeros((N, 1))}

    solve = jax.jit(lambda x0, U0, p: al_ilqr_solve(
        ocp, x0, U0, p, SolverConfig(al_iters=4, ilqr_iters=8)))
    res1 = solve(jnp.array([0.0, 0.0]), jnp.zeros((N, 1)), params)

    B = 5
    x0s = jnp.stack([jnp.array([0.1 * i, 0.0]) for i in range(B)])
    batched = jax.jit(jax.vmap(
        lambda x0: al_ilqr_solve(ocp, x0, jnp.zeros((N, 1)), params,
                                 SolverConfig(al_iters=4, ilqr_iters=8))))
    resB = batched(x0s)
    assert resB.U.shape == (B, N, 1)
    # batch element 0 equals the single solve
    np.testing.assert_allclose(np.asarray(resB.U[0]), np.asarray(res1.U),
                               atol=1e-10)


def test_chol_solve_unrolled_matches_lapack():
    from mmmpc_tpu.solver.linalg_small import chol_solve_unrolled
    rng = np.random.default_rng(9)
    for n, m, batch in [(5, 10, ()), (5, 6, (7,)), (9, 1, (4, 3)), (2, 2, ())]:
        A = rng.standard_normal(batch + (n, n))
        A = A @ np.swapaxes(A, -1, -2) + n * np.eye(n)
        B = rng.standard_normal(batch + (n, m))
        X = chol_solve_unrolled(jnp.asarray(A), jnp.asarray(B))
        X_ref = np.linalg.solve(A, B)
        np.testing.assert_allclose(np.asarray(X), X_ref, rtol=1e-9, atol=1e-9)


def test_lam0_zeros_equals_default():
    """Explicit zero dual warm start must take the exact same path as the
    default (cold) start."""
    N = 10
    ocp = make_demo_ocp(N=N)
    params = {"X_ref": jnp.tile(jnp.array([3.0, 0.0]), (N + 1, 1)),
              "U_ref": jnp.zeros((N, 1))}
    x0 = jnp.array([0.0, 0.0])
    cfg = SolverConfig(al_iters=4, ilqr_iters=8)
    res_none = al_ilqr_solve(ocp, x0, jnp.zeros((N, 1)), params, cfg)
    lam0 = (jnp.zeros((N, 2)), jnp.zeros((2,)), jnp.zeros((0,)))
    res_zero = al_ilqr_solve(ocp, x0, jnp.zeros((N, 1)), params, cfg,
                             lam0=lam0)
    np.testing.assert_array_equal(np.asarray(res_none.U),
                                  np.asarray(res_zero.U))


def test_dual_warm_start_stabilizes_rt_budget():
    """Receding-horizon dual carry (shift_multipliers with decay) must reach
    a tighter steady state than primal-only warm starts at an RT iteration
    budget, and must not wind up (fleet RT convergence).
    """
    from mmmpc_tpu.solver import shift_multipliers

    N = 12
    ocp = make_base_obstacle_ocp(N=N)
    x_ref = jnp.tile(jnp.array([2.0, 0.0, 0.0, 0.0, 0.0, 0.0]), (N + 1, 1))
    params = {"X_ref": x_ref, "U_ref": jnp.zeros((N, 2))}
    x0 = jnp.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    rt = SolverConfig(al_iters=2, ilqr_iters=4, ilqr_iters_later=3)

    solve = jax.jit(lambda U0, lam0: al_ilqr_solve(
        ocp, x0, U0, params, rt, lam0=lam0))

    def run_ticks(carry_duals, n=10):
        U = jnp.zeros((N, 2))
        lam = None
        viols, lam_mags = [], []
        for _ in range(n):
            res = solve(U, lam)
            U = res.U
            if carry_duals:
                lam = shift_multipliers(res.lam_stage, res.lam_term,
                                        res.lam_eq)
                lam_mags.append(float(jnp.max(res.lam_stage)))
            viols.append(float(res.max_violation))
        return viols, lam_mags

    v_dual, mags = run_ticks(True)
    v_prim, _ = run_ticks(False)
    # steady state at least as tight, and clearly small
    assert v_dual[-1] <= v_prim[-1] + 1e-9
    assert v_dual[-1] < 1e-4
    # no windup: multiplier magnitudes bounded across ticks
    assert mags[-1] < 10.0 * (mags[2] + 1.0)


def test_exact_hessian_psd_guard():
    """General-OCP fallback (no residual factorization -> exact AD Hessians)
    with a deliberately nonconvex cost: cos(x0) has an indefinite Hessian
    around the start state, which would feed sqrt(<0) = NaN into the unrolled
    Cholesky without the eigenvalue clamp in stage_derivs_exact /
    terminal_derivs."""
    N = 12

    def stage(x, u, k, p):
        # strongly nonconvex in x (negative curvature at x0=0), convex in u
        return 4.0 * jnp.cos(x[0]) + 0.2 * x[1] ** 2 + 0.1 * (u[0] ** 2)

    def term(x, p):
        return 4.0 * jnp.cos(x[0]) + 0.2 * x[1] ** 2

    ocp = OCP(nx=2, nu=1, N=N,
              dynamics=lambda x, u: point_mass_step(x, u, DT),
              stage_cost=stage, terminal_cost=term)
    assert ocp.stage_residuals is None  # must exercise the exact path
    cfg = SolverConfig(al_iters=2, ilqr_iters=15)
    x0 = jnp.array([0.4, 0.0])  # off the hilltop so descent is possible
    res = al_ilqr_solve(ocp, x0, jnp.zeros((N, 1)), {}, cfg)
    assert np.all(np.isfinite(np.asarray(res.U)))
    assert np.all(np.isfinite(np.asarray(res.X)))
    # it should actually make progress downhill from the cos() hilltop
    X0, _ = rollout(ocp, x0, jnp.zeros((N, 1)), {})
    cost0 = sum(float(stage(X0[k], jnp.zeros(1), k, {})) for k in range(N)) \
        + float(term(X0[N], {}))
    assert float(res.cost) < cost0 - 1.0
