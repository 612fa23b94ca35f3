"""Two-stage straggler refinement — batched solve at a cheap schedule, then
re-solve only the hardest scenarios warm-started.

Motivation (scripts/sweep_schedule.py): the 100%-convergence
frontier for a single uniform schedule is 7x(20,12) = 92 iLQR iterations —
every schedule in the 80-88-iteration range converges 99.84-99.99% of the
batch and fails on a 0.03-0.16% tail.  Paying 12 extra iterations on ALL
8192 scenarios to converge the last ~10 is the single-schedule tax.

The two-stage solve removes it: stage 1 runs the whole batch at a cheap
schedule; stage 2 gathers the ``refine_size`` worst scenarios (by hard-
constraint violation), re-solves them warm-started from their stage-1
primal/dual state with the AL penalty schedule CONTINUED where stage 1 left
off, and scatters back whichever result is better per scenario.  The refine
batch (REFINE_SIZE) is an eighth of the benchmark's stage-1 batch; the merge
is violation-monotone by construction, so two-stage convergence is >=
stage-1 convergence for every scenario.

This is the fixed-shape analogue of adaptive per-problem iteration
counts: the reference's IPOPT iterates each NLP until ITS OWN tolerance is
met (max_iter=2000, /root/reference/controllers/mpc_wholebody_qref.py:280-285);
a batched fixed-shape solver cannot early-exit per scenario, but it CAN
spend a second, smaller fixed-shape solve on the measured tail.  All
data-dependent control flow (top_k gather, scatter-merge) is inside jit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from mmmpc_tpu.ocp.spec import OCP
from mmmpc_tpu.solver.al_ilqr import SolveResult
from mmmpc_tpu.solver.batched import (
    _per_scenario_keys, al_ilqr_solve_batched,
)
from mmmpc_tpu.utils.configs import SolverConfig

# Scenarios re-solved in stage 2 unless the caller says otherwise: the
# worst 1024 of the benchmark's 8192 (scripts/sweep_refine.py).
REFINE_SIZE = 1024


def continue_mu(cfg: SolverConfig, al_rounds_done: int,
                **overrides) -> SolverConfig:
    """A config whose AL penalty schedule continues after ``al_rounds_done``
    rounds of ``cfg``: mu_at(0) of the result equals mu_at(al_rounds_done)
    of ``cfg`` (capped at mu_max), so a warm-started re-solve picks up the
    outer loop where the first solve stopped instead of re-annealing from
    mu_init (which would un-pin the active set the carried multipliers
    encode)."""
    mu0 = min(cfg.mu_init * cfg.mu_scale ** al_rounds_done, cfg.mu_max)
    return dataclasses.replace(cfg, mu_init=mu0, **overrides)


def default_refine_config(cfg: SolverConfig) -> SolverConfig:
    """Stage-2 default: three more AL rounds x 12 sweeps, mu continued."""
    return continue_mu(cfg, cfg.al_iters, al_iters=3, ilqr_iters=12,
                      ilqr_iters_later=12, ilqr_iters_final=None)


def al_ilqr_solve_refined(ocp: OCP, x0_b, U0_b, params,
                          cfg: SolverConfig = SolverConfig(),
                          refine_cfg: SolverConfig | None = None,
                          refine_size: int | None = None,
                          lam0_b=None) -> SolveResult:
    """Batched solve with straggler refinement (see module docstring).

    refine_size: scenarios re-solved in stage 2 — the ``refine_size`` worst
    by stage-1 violation (top_k; converged scenarios padding the gather are
    harmless — their re-solve keeps them converged and the merge only ever
    accepts strict improvement).  Defaults to REFINE_SIZE or the whole
    batch if smaller.

    Returns a SolveResult shaped exactly like al_ilqr_solve_batched's.
    """
    B = x0_b.shape[0]
    if refine_size is None:
        refine_size = min(B, REFINE_SIZE)
    refine_size = min(refine_size, B)
    if refine_cfg is None:
        refine_cfg = default_refine_config(cfg)

    res1 = al_ilqr_solve_batched(ocp, x0_b, U0_b, params, cfg, lam0_b)
    if refine_size <= 0 or refine_cfg.al_iters <= 0:
        return res1

    _, idx = jax.lax.top_k(res1.max_violation, refine_size)

    params_r = dict(params)
    for k in _per_scenario_keys(params):
        params_r[k] = params[k][..., idx]          # batch-minor trailing axis

    res2 = al_ilqr_solve_batched(
        ocp, x0_b[idx], res1.U[idx], params_r, refine_cfg,
        lam0_b=(res1.lam_stage[idx], res1.lam_term[idx], res1.lam_eq[idx]))

    # violation-monotone merge: accept the refined solve only where it
    # strictly reduced the hard-constraint violation
    better = res2.max_violation < res1.max_violation[idx]

    def merge(a, b):
        sel = better.reshape((-1,) + (1,) * (b.ndim - 1))
        return a.at[idx].set(jnp.where(sel, b, a[idx]))

    merged = jax.tree.map(merge, res1, res2)
    return merged._replace(
        converged=merged.max_violation < cfg.constraint_tol)
