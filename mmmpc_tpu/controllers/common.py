"""Shared controller plumbing.

Every controller follows the reference's 3-method protocol
(__init__ / reset / solve, SURVEY.md §1 L3) but compiles its OCP once and
re-solves with runtime parameters — the analogue of the reference's
``opti.parameter`` mechanism that lets one built problem serve every control
tick and task phase without recompilation.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mmmpc_tpu.solver import al_ilqr_solve, shift_multipliers
from mmmpc_tpu.utils.configs import SolverConfig


def finite_bound_masks(lim):
    """Split a (2, n) [lower; upper] bound array into dense values + masks.

    Infinite entries are masked out (emitted as always-satisfied rows) so the
    constraint vector keeps a static shape.
    """
    lo = np.asarray(lim[0], dtype=float)
    hi = np.asarray(lim[1], dtype=float)
    mask_lo = np.isfinite(lo)
    mask_hi = np.isfinite(hi)
    lo = np.where(mask_lo, lo, 0.0)
    hi = np.where(mask_hi, hi, 0.0)
    return (jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(mask_lo), jnp.asarray(mask_hi))


def as_weight_matrix(value, n):
    """Accept scalars, diagonals, or full matrices (the reference passes
    np.diag(...) everywhere, including 1x1 'matrices' for scalar weights)."""
    v = np.asarray(value, dtype=float)
    if v.ndim == 0:
        return jnp.asarray(v * np.eye(n))
    if v.ndim == 1:
        return jnp.asarray(np.diag(v))
    return jnp.asarray(v)


def scalar_weight(value):
    """The reference's S / M slack weights arrive as np.diag([w])."""
    v = np.asarray(value, dtype=float)
    return jnp.asarray(v.reshape(-1)[0])


def weight_sqrt(W):
    """Symmetric PSD square root of a weight matrix (host-side).

    Used to factor quadratic costs into Gauss-Newton residuals:
    e @ W @ e == ||sqrt(W) @ e||^2.  Reference weights are diagonal, where
    this is just sqrt of the diagonal; the eigh path covers arbitrary PSD
    weights passed through setWeight."""
    W = np.asarray(W, dtype=float)
    d = np.diag(W)
    if np.allclose(W, np.diag(d)):
        return jnp.asarray(np.diag(np.sqrt(np.maximum(d, 0.0))))
    vals, vecs = np.linalg.eigh(W)
    return jnp.asarray(
        vecs @ np.diag(np.sqrt(np.maximum(vals, 0.0))) @ vecs.T)


def constraint_dims(ocp, params, dtype=jnp.float32):
    """(nc, nct, ne) — static constraint-group widths of an OCP."""
    zx = jnp.zeros(ocp.nx, dtype)
    zu = jnp.zeros(ocp.nu, dtype)
    nc = jax.eval_shape(ocp.stage_ineq, zx, zu, 0, params).shape[0]
    nct = jax.eval_shape(ocp.terminal_ineq, zx, params).shape[0]
    ne = jax.eval_shape(ocp.terminal_eq, zx, params).shape[0]
    return nc, nct, ne


class ControllerBase:
    """Warm-start bookkeeping + jitted solve shared by all controllers."""

    def __init__(self, ocp, solver_config: SolverConfig | None = None):
        self.ocp = ocp
        self.solver_config = solver_config or SolverConfig()
        self.N = ocp.N
        self.u_latest = None
        self.lam_latest = None
        self.last_result = None
        self._jit_solve = jax.jit(
            lambda x0, U0, params, lam0: al_ilqr_solve(
                self.ocp, x0, U0, params, self.solver_config, lam0=lam0))

    # -- functional access (batching / sharding layers build on these) -----
    def solve_fn(self):
        """(x0, U_warm, params) -> SolveResult, pure and jit/vmap-safe."""
        ocp, cfg = self.ocp, self.solver_config
        return lambda x0, U0, params: al_ilqr_solve(ocp, x0, U0, params, cfg)

    def batch_solve_fn(self):
        """(x0_b, U0_b, params) -> batched SolveResult.

        Uses the natively-batched solver (fused kernels on the GPU where
        the OCP provides them; vmap otherwise)."""
        from mmmpc_tpu.solver.batched import al_ilqr_solve_batched
        ocp, cfg = self.ocp, self.solver_config
        return lambda x0_b, U0_b, params: al_ilqr_solve_batched(
            ocp, x0_b, U0_b, params, cfg)

    def batch_solve_refined_fn(self, refine_cfg=None, refine_size=None):
        """(x0_b, U0_b, params) -> batched SolveResult with two-stage
        straggler refinement (solver/refine.py): the whole batch at this
        controller's schedule, then the ``refine_size`` worst scenarios
        re-solved warm-started with the AL penalty schedule continued."""
        from mmmpc_tpu.solver.refine import al_ilqr_solve_refined
        ocp, cfg = self.ocp, self.solver_config
        return lambda x0_b, U0_b, params: al_ilqr_solve_refined(
            ocp, x0_b, U0_b, params, cfg, refine_cfg=refine_cfg,
            refine_size=refine_size)

    def reset_warmstart(self):
        self.u_latest = None
        self.lam_latest = None

    def _solve_impl(self, x_init, params):
        if self.u_latest is None:
            self.u_latest = jnp.zeros((self.N, self.ocp.nu))
        params = dict(params, U_last=self.u_latest)
        if self.lam_latest is None:
            nc, nct, ne = constraint_dims(self.ocp, params)
            self.lam_latest = (jnp.zeros((self.N, nc)), jnp.zeros((nct,)),
                               jnp.zeros((ne,)))
        res = self._jit_solve(jnp.asarray(x_init), self.u_latest, params,
                              self.lam_latest)
        self.u_latest = res.U
        # carry the duals into the next tick (receding-horizon shift) —
        # this is what lets the RT config track the optimum in a handful
        # of sweeps instead of re-deriving multipliers from scratch
        self.lam_latest = shift_multipliers(
            res.lam_stage, res.lam_term, res.lam_eq)
        self.last_result = res
        return np.asarray(res.U[0])
