"""Batched closed-loop scenario engine — thousands of rollouts on device.

The reference runs exactly one closed-loop scenario per process
(interface_wholebody_qref.py).  This engine runs a *batch* of closed-loop
rollouts entirely on device: per tick it extracts each scenario's local
reference window (vectorized nearest-point search, the jnp twin of
runtime/reference.py), solves the batch of MPCs warm-started from the
previous tick, applies u[0] through the model plant (the reference's
physical_sim=False path), and carries per-scenario solver state through a
``lax.scan`` over control ticks.

Failure handling (SURVEY.md §5): a scenario whose solve comes back
non-finite or grossly infeasible does not poison the batch — its command
falls back to the previous control sequence shifted by one step, and the
event is counted in the returned metrics.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mmmpc_tpu.solver import al_ilqr_solve_batched, shift_multipliers
from mmmpc_tpu.utils.configs import SolverConfig


class RolloutLog(NamedTuple):
    X: jnp.ndarray           # (B, T+1, nx) closed-loop state trajectories
    U: jnp.ndarray           # (B, T, nu) applied commands
    cost: jnp.ndarray        # (B, T) per-tick MPC objective
    violation: jnp.ndarray   # (B, T) per-tick max constraint violation
    fallback: jnp.ndarray    # (B, T) bool: tick used the shifted fallback


def _local_window(traj_ref, u_ref, x, distance_index, N):
    """jnp twin of runtime/reference.local_ref_traj (single scenario)."""
    d = traj_ref[:, distance_index] - x[distance_index]
    min_idx = jnp.argmin(jnp.sum(d * d, axis=1))
    idx = jnp.minimum(min_idx + jnp.arange(N + 1), traj_ref.shape[0] - 1)
    idx_u = jnp.minimum(min_idx + jnp.arange(N), u_ref.shape[0] - 1)
    return traj_ref[idx], u_ref[idx_u]


def make_batch_closed_loop(ocp, cfg: SolverConfig, shared_params,
                           distance_index, n_ticks: int,
                           fallback_violation: float = 1.0):
    """Build a jittable batched closed-loop rollout.

    ocp: the controller's OCP (e.g. MPCWholeBody(...).ocp);
    shared_params: the controller's make_params(...) dict *minus* X_ref /
    U_ref / U_last, which are computed per scenario per tick;
    distance_index: state components used for the nearest-point search
    (e.g. [0, 1] for the move phase, [6, 7, 8] for manipulation).

    Returns run(x0_b, traj_ref_b, u_ref_b) -> RolloutLog where
    traj_ref_b: (B, T_ref+1, nx) global reference per scenario.
    """
    N = ocp.N
    dist_idx = jnp.asarray(distance_index)

    def post_solve(x, U_warm, lams, res):
        u_new = res.U
        ok = (jnp.all(jnp.isfinite(u_new))
              & (res.max_violation < fallback_violation))
        # shifted previous sequence as the fallback command
        u_shift = jnp.concatenate([U_warm[1:], U_warm[-1:]], axis=0)
        U_applied = jnp.where(ok, u_new, u_shift)
        # dual warm start for the next tick; a failed solve keeps its old
        # multipliers rather than inheriting garbage duals
        lam_new = shift_multipliers(res.lam_stage, res.lam_term, res.lam_eq)
        lam_next = jax.tree.map(
            lambda new, old: jnp.where(ok, new, old), lam_new, lams)
        x_next = ocp.dynamics(x, U_applied[0])
        return (x_next, U_applied, lam_next, U_applied[0], res.cost,
                res.max_violation, ~ok)

    def run(x0_b, traj_ref_b, u_ref_b):
        B = x0_b.shape[0]

        def tick(carry, _):
            x_b, U_b, lam_b = carry
            # per-robot reference windows (vmapped nearest-point search),
            # then ONE batched solve with per-robot params — on the GPU
            # the forward pass runs as the fused kernel
            # (ops/wholebody_fwd.py, X_ref / U_ref / U_last as batch-minor
            # lane operands) and the backward as the vmapped XLA expansion
            # plus backward_scan; al_ilqr_solve_batched's vmap path
            # computes the same per-robot solves elsewhere
            X_ref_b, U_ref_b = jax.vmap(
                lambda t, u, x: _local_window(t, u, x, dist_idx, N))(
                    traj_ref_b, u_ref_b, x_b)
            params_b = dict(shared_params,
                            X_ref=jnp.moveaxis(X_ref_b, 0, -1),
                            U_ref=jnp.moveaxis(U_ref_b, 0, -1),
                            U_last=jnp.moveaxis(U_b, 0, -1))
            res = al_ilqr_solve_batched(ocp, x_b, U_b, params_b, cfg,
                                        lam0_b=lam_b)
            (x_next, U_next, lam_next, u0, cost, viol, fb) = jax.vmap(
                post_solve)(x_b, U_b, lam_b, res)
            return (x_next, U_next, lam_next), (x_next, u0, cost, viol, fb)

        U0_b = jnp.zeros((B, N, ocp.nu), x0_b.dtype)
        sample_params = dict(
            shared_params,
            X_ref=jnp.zeros((N + 1, ocp.nx), x0_b.dtype),
            U_ref=jnp.zeros((N, ocp.nu), x0_b.dtype),
            U_last=jnp.zeros((N, ocp.nu), x0_b.dtype))
        zx = jnp.zeros(ocp.nx, x0_b.dtype)
        zu = jnp.zeros(ocp.nu, x0_b.dtype)
        nc = jax.eval_shape(ocp.stage_ineq, zx, zu, 0,
                            sample_params).shape[0]
        nct = jax.eval_shape(ocp.terminal_ineq, zx, sample_params).shape[0]
        ne = jax.eval_shape(ocp.terminal_eq, zx, sample_params).shape[0]
        lam0_b = (jnp.zeros((B, N, nc), x0_b.dtype),
                  jnp.zeros((B, nct), x0_b.dtype),
                  jnp.zeros((B, ne), x0_b.dtype))
        (_, _, _), (Xs, Us, costs, viols, fbs) = jax.lax.scan(
            tick, (x0_b, U0_b, lam0_b), None, length=n_ticks)
        X = jnp.concatenate([x0_b[:, None], jnp.moveaxis(Xs, 0, 1)], axis=1)
        return RolloutLog(X=X,
                          U=jnp.moveaxis(Us, 0, 1),
                          cost=jnp.moveaxis(costs, 0, 1),
                          violation=jnp.moveaxis(viols, 0, 1),
                          fallback=jnp.moveaxis(fbs, 0, 1))

    return run


def run_with_failure_report(run, *args, constraint_tol: float,
                            top_k: int = 3, file=None):
    """Host-side driver around a (possibly jitted) engine ``run``: executes
    the rollout and dumps the top-k worst scenarios to stderr whenever any
    tick violated ``constraint_tol`` or fell back to the shifted command —
    the batched analogue of the reference's failure dump
    (/root/reference/controllers/mpc_wholebody_qref.py:318-326)."""
    from mmmpc_tpu.utils.debugging import report_rollout_failures

    log = run(*args)
    report_rollout_failures(log, constraint_tol=constraint_tol, top_k=top_k,
                            file=file)
    return log
