"""CPU oracle: solve the same OCP with scipy's interior-point method.

Plays the role the CasADi/IPOPT stack plays for the reference (BASELINE.json:
"Control sequences must match the reference solver within tolerance").
CasADi is not available in this image, so the oracle is scipy
``trust-constr`` — an interior-point NLP method of the same family as IPOPT —
applied to the *same* OCP functions the JAX solver consumes, with exact
JAX-computed gradients/Jacobians.  Agreement between two unrelated solvers on
the same problem is the fidelity evidence; the formulation itself is tied to
the reference by construction (see ocp/spec.py and controllers/*).

Decision variables are the inputs only (single shooting): the dynamics are
eliminated by rollout, input boxes become scipy Bounds, remaining hard
constraints become NonlinearConstraint blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.optimize as sopt

from mmmpc_tpu.ocp.spec import OCP
from mmmpc_tpu.solver.al_ilqr import _objective


def _plain_rollout(ocp: OCP, x0, U):
    def step(x, u):
        x_next = ocp.dynamics(x, u)
        return x_next, x

    x_last, Xs = jax.lax.scan(step, x0, U)
    return jnp.concatenate([Xs, x_last[None, :]], axis=0)


# Compiled single-shooting objective/gradient per OCP.  The closed-loop
# fidelity harness calls the oracles once per tick with fresh (x0, params);
# making those traced ARGUMENTS of one cached jit (instead of closure
# captures of a fresh jit per call) turns 10 recompiles into 1.
_FNS_CACHE: dict = {}


def _shooting_fns(ocp: OCP):
    key = id(ocp)
    hit = _FNS_CACHE.get(key)
    if hit is not None and hit[0] is ocp:
        return hit[1], hit[2]

    def obj(z, x0, params):
        U = z.reshape(ocp.N, ocp.nu)
        X = _plain_rollout(ocp, x0, U)
        return _objective(ocp, X, U, params)

    obj_j = jax.jit(obj)
    grad_j = jax.jit(jax.grad(obj))
    _FNS_CACHE[key] = (ocp, obj_j, grad_j)   # strong ref pins the id
    return obj_j, grad_j


def scipy_solve(ocp: OCP, x0, U_init, params, maxiter: int = 1000,
                gtol: float = 1e-9, xtol: float = 1e-12):
    """Returns (U, X, cost, scipy_result)."""
    N, nu, nx = ocp.N, ocp.nu, ocp.nx
    x0 = jnp.asarray(x0, jnp.float64)
    ks = jnp.arange(N)

    def obj(z):
        U = z.reshape(N, nu)
        X = _plain_rollout(ocp, x0, U)
        return _objective(ocp, X, U, params)

    def cons_ineq(z):
        U = z.reshape(N, nu)
        X = _plain_rollout(ocp, x0, U)
        cs = jax.vmap(lambda x, u, k: ocp.stage_ineq(x, u, k, params))(
            X[:-1], U, ks).reshape(-1)
        ct = ocp.terminal_ineq(X[-1], params)
        return jnp.concatenate([cs, ct])

    def cons_eq(z):
        U = z.reshape(N, nu)
        X = _plain_rollout(ocp, x0, U)
        return ocp.terminal_eq(X[-1], params)

    obj_j = jax.jit(obj)
    grad_j = jax.jit(jax.grad(obj))
    z0 = np.asarray(U_init, dtype=np.float64).reshape(-1)

    constraints = []
    n_ineq = int(jax.eval_shape(cons_ineq, jnp.zeros(N * nu)).shape[0])
    if n_ineq:
        # Masked-out constraint rows are the constant -1e9 "satisfied by a
        # wide margin" sentinel (ocp/constraints.py); their zero Jacobian
        # rows make trust-constr's projections singular — drop them.
        c_probe = np.asarray(jax.jit(cons_ineq)(jnp.asarray(z0)))
        keep = np.where(c_probe > -1e8)[0]
        if keep.size:
            keep_j = jnp.asarray(keep)
            ci = jax.jit(lambda z: cons_ineq(z)[keep_j])
            Ji = jax.jit(jax.jacfwd(lambda z: cons_ineq(z)[keep_j]))
            constraints.append(sopt.NonlinearConstraint(
                lambda z: np.asarray(ci(z)), -np.inf, 0.0,
                jac=lambda z: np.asarray(Ji(z))))
    n_eq = int(jax.eval_shape(cons_eq, jnp.zeros(N * nu)).shape[0])
    if n_eq:
        ce = jax.jit(cons_eq)
        Je = jax.jit(jax.jacfwd(cons_eq))
        constraints.append(sopt.NonlinearConstraint(
            lambda z: np.asarray(ce(z)), 0.0, 0.0,
            jac=lambda z: np.asarray(Je(z))))

    bounds = None
    if ocp.u_lower is not None or ocp.u_upper is not None:
        lo = np.tile(np.asarray(ocp.u_lower, dtype=np.float64)
                     if ocp.u_lower is not None else -np.inf, N)
        hi = np.tile(np.asarray(ocp.u_upper, dtype=np.float64)
                     if ocp.u_upper is not None else np.inf, N)
        bounds = sopt.Bounds(lo, hi)

    res = sopt.minimize(
        lambda z: float(obj_j(z)), z0, jac=lambda z: np.asarray(grad_j(z)),
        method="trust-constr", bounds=bounds, constraints=constraints,
        options={"maxiter": maxiter, "gtol": gtol, "xtol": xtol})

    U = jnp.asarray(res.x.reshape(N, nu))
    X = _plain_rollout(ocp, x0, U)
    return U, X, float(obj_j(res.x)), res


def lbfgs_solve(ocp: OCP, x0, U_init, params, maxiter: int = 5000):
    """Second, independent oracle: L-BFGS-B on the single-shooting objective
    with the input box as bounds.

    Exact when no other hard constraint is active at the optimum (the
    objective already contains the reference's soft slack penalties); a lower
    bound (relaxation) otherwise, since state/rate boxes are ignored.
    Returns (U, X, cost, scipy_result).
    """
    N, nu = ocp.N, ocp.nu
    x0 = jnp.asarray(x0, jnp.float64)

    obj_j, grad_j = _shooting_fns(ocp)
    lo = np.tile(np.asarray(ocp.u_lower, dtype=np.float64)
                 if ocp.u_lower is not None else -np.inf, N)
    hi = np.tile(np.asarray(ocp.u_upper, dtype=np.float64)
                 if ocp.u_upper is not None else np.inf, N)
    res = sopt.minimize(
        lambda z: float(obj_j(z, x0, params)),
        np.asarray(U_init, dtype=np.float64).ravel(),
        jac=lambda z: np.asarray(grad_j(z, x0, params)), method="L-BFGS-B",
        bounds=sopt.Bounds(lo, hi),
        options={"maxiter": maxiter, "ftol": 1e-14, "gtol": 1e-12})
    U = jnp.asarray(res.x.reshape(N, nu))
    X = _plain_rollout(ocp, x0, U)
    return U, X, float(res.fun), res
