"""Declarative optimal-control-problem spec.

Replaces the reference's imperative CasADi ``Opti()`` graph construction
(/root/reference/controllers/mpc_wholebody_qref.py:142-285).  An OCP is a
bundle of pure functions over (state, input, stage-index, params); the solver
differentiates them with jax.grad/jacfwd — no symbolic graph, one compiled
program per problem *shape*, with every runtime quantity (references,
weights, obstacle poses, constraint toggles) carried in ``params``.

Conventions
-----------
- ``dynamics(x, u) -> x_next``                      discrete step, dt closed over
- ``stage_cost(x, u, k, params) -> scalar``         includes the reference's
  slack terms as exact ``S * relu(max g)^2`` penalties (see note below)
- ``terminal_cost(x, params) -> scalar``
- ``stage_ineq(x, u, k, params) -> (nc,)``          hard constraints c <= 0,
  enforced by the solver's augmented-Lagrangian outer loop
- ``terminal_ineq(x, params) -> (nct,)``            hard terminal c <= 0
- ``terminal_eq(x, params) -> (ne,)``               h == 0 (maskable at runtime;
  the FSM's injected terminal equality, interface_wholebody_qref.py:167)
- ``u_lower/u_upper``                               static box used for input
  clamping in the forward rollout (the reference's ulim)

Slack-variable note
-------------------
The reference attaches one slack s_k per step with cost S*s_k^2 and
constraints g_i <= s_k (mpc_wholebody_qref.py:154,208-227).  At the optimum
s_k* = max(0, max_i g_i), so the slack block is *exactly* the penalty
S * relu(max_i g_i)^2 — a C^1 function we fold into the stage cost instead of
carrying slack decision variables.  This removes N+1 variables and all slack
rows from the KKT system while preserving the solution.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp


def _zero_vec(*_args):
    return jnp.zeros((0,))


@dataclasses.dataclass(frozen=True)
class OCP:
    """A fixed-shape optimal control problem over horizon N.

    ``stage_residuals`` / ``terminal_residuals`` are an optional
    sum-of-squares factorization of the costs: cost == sum(residuals**2)
    exactly.  When provided, the solver uses Gauss-Newton expansions
    (forward-only Jacobians, PSD Hessian by construction) instead of exact
    AD Hessians.  All reference
    formulations are sums of squares (quadratic tracking + relu^2 slack
    penalties), so every built-in controller supplies them.
    """

    nx: int
    nu: int
    N: int
    dynamics: Callable          # (x, u) -> x_next
    stage_cost: Callable        # (x, u, k, params) -> scalar
    terminal_cost: Callable     # (x, params) -> scalar
    stage_ineq: Callable = _zero_vec      # (x, u, k, params) -> (nc,)
    terminal_ineq: Callable = _zero_vec   # (x, params) -> (nct,)
    terminal_eq: Callable = _zero_vec     # (x, params) -> (ne,)
    u_lower: Optional[jnp.ndarray] = None   # (nu,) static clamp, -inf ok
    u_upper: Optional[jnp.ndarray] = None
    stage_residuals: Optional[Callable] = None     # (x, u, k, params) -> (nr,)
    terminal_residuals: Optional[Callable] = None  # (x, params) -> (nrt,)

    # Hand-assembled derivative path (fastest).  When ALL of these are
    # provided the solver skips AD entirely in its hot loop: the *_jac
    # callables return (value, jacobian-wrt-[x;u]) pairs with analytic /
    # minimal-AD Jacobians, and dynamics_jacobians returns closed-form
    # (A, B).  Correctness vs the AD paths is asserted in tests.
    stage_gn: Optional[Callable] = None        # (x,u,k,params) -> (r, J)
    terminal_gn: Optional[Callable] = None     # (x,params) -> (r, J)
    stage_ineq_jac: Optional[Callable] = None  # (x,u,k,params) -> (c, Jc)
    terminal_ineq_jac: Optional[Callable] = None   # (x,params) -> (c, Jc)
    terminal_eq_jac: Optional[Callable] = None     # (x,params) -> (h, Jh)
    dynamics_jacobians: Optional[Callable] = None  # (x,u) -> (A, B)

    # Optional fused forward line-search kernel factory for the batched
    # solver's lanes path (ops/wholebody_fwd.py).  Signature:
    # factory(cfg, interpret) -> fwd(X_bm, U_bm, kff_bm, K_bm, lam_bm,
    # lamt_bm, lame_bm, mu, params) -> (Xc, Uc, xlast, cc) on batch-minor
    # arrays, cc including the terminal AL cost.  When provided, the batched
    # solver runs its forward pass through it on the GPU.
    lanes_fwd_factory: Optional[Callable] = None
    # Params keys the kernel consumes per scenario (batch-minor trailing
    # axis).  The fleet task engine needs {"U_last", "X_ref", "U_ref", "Q",
    # "P", "eq_mask"} (each robot's phase owns its reference window,
    # weight-table row and terminal-equality mask).  Per-scenario Q/P must
    # be DIAGONAL — the kernel wrapper consumes only the diagonals.  Other
    # per-scenario keys route the solve to the vmapped path.
    lanes_per_scenario_keys: frozenset = frozenset()

    # Fully-structured AL expansion (fastest of all): the controller returns
    # the complete gradient/Hessian blocks of the scaled AL stage/terminal
    # cost directly — no residual Jacobian is ever materialized (the JtJ of
    # the quadratic tracking part is just the weight matrix, box rows are
    # diagonal, the slack row is a rank-1 outer product).
    # (x, u, k, params, lam_k, mu, inv_scale) -> (lx, lu, lxx, luu, lux)
    stage_al_expansion: Optional[Callable] = None
    # (x, params, lam_t, lam_e, mu, inv_scale) -> (gx, Hxx)
    terminal_al_expansion: Optional[Callable] = None

    @property
    def has_hand_jacobians(self) -> bool:
        return (self.stage_gn is not None and self.terminal_gn is not None
                and self.dynamics_jacobians is not None)

    @property
    def has_al_expansion(self) -> bool:
        return (self.stage_al_expansion is not None
                and self.terminal_al_expansion is not None
                and self.dynamics_jacobians is not None)

    def clamp_u(self, u):
        if self.u_lower is None and self.u_upper is None:
            return u
        lo = (None if self.u_lower is None
              else jnp.asarray(self.u_lower, u.dtype))
        hi = (None if self.u_upper is None
              else jnp.asarray(self.u_upper, u.dtype))
        return jnp.clip(u, lo, hi)
