"""Natively-batched AL-iLQR — the high-throughput path.

Same algorithm as al_ilqr_solve with the batch as a whole-array axis.  Two
paths, chosen from what the code can observe:

- **lanes path** (GPU, when the OCP provides a fused forward kernel via
  ``lanes_fwd_factory``): the inner loop is *batch-minor* — every array
  carries the batch as its LAST axis, the layout the kernel reads with
  contiguous loads — and the forward rollout + line search of an iLQR
  iteration is one kernel launch (ops/wholebody_fwd.py).  The backward half
  (AL expansion + Riccati sweep) is the same vmapped XLA code the vmap path
  runs.
- **vmap path**: ``vmap(al_ilqr_solve)`` everywhere else — CPU, OCPs
  without kernels, per-scenario params the kernels do not read, or
  ``SolverConfig.use_kernels=False``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mmmpc_tpu.ocp.spec import OCP
from mmmpc_tpu.solver.al_ilqr import (
    SolveResult, _al_penalty_eq, _al_penalty_ineq, _objective,
    al_ilqr_solve, build_core, rollout, run_al_rounds,
)
from mmmpc_tpu.utils.configs import SolverConfig


def _params_axes(params, batched_keys):
    """vmap in_axes tree over a params dict: -1 for per-scenario entries
    (trailing batch axis, batch-minor), None for shared ones."""
    return {k: (-1 if k in batched_keys else None) for k in params}


def _per_scenario_keys(params):
    """Params entries carrying a per-scenario trailing batch axis.

    Convention (fleet serving): relative to its shared shape, a
    per-scenario entry gains one trailing batch axis —
    ``U_last`` (N, nu, B) instead of (N, nu), ``X_ref`` (N+1, nx, B),
    ``Q``/``P`` (nx, nx, B) (diagonal per scenario), ``eq_mask`` (B,)
    instead of a scalar.
    """
    keys = set()
    for k in ("U_last", "X_ref", "U_ref", "Q", "P"):
        if jnp.ndim(params.get(k, 0)) == 3:
            keys.add(k)
    if jnp.ndim(params.get("eq_mask", 0)) == 1:
        keys.add("eq_mask")
    return keys


def kernel_path_applies(ocp: OCP, cfg: SolverConfig, params,
                        platform: str) -> bool:
    """Whether a batched solve on ``platform`` (``jax.default_backend()``)
    runs the fused kernel: only on the GPU, only for an OCP that provides
    one, and only when every per-scenario params entry is one the kernel
    reads per lane."""
    return (platform == "gpu" and cfg.use_kernels
            and ocp.lanes_fwd_factory is not None
            and _per_scenario_keys(params) <= ocp.lanes_per_scenario_keys)


def al_ilqr_solve_batched(ocp: OCP, x0_b, U0_b, params,
                          cfg: SolverConfig = SolverConfig(),
                          lam0_b=None) -> SolveResult:
    """Solve a batch of scenarios sharing ``params``.

    x0_b: (B, nx); U0_b: (B, N, nu).  lam0_b: optional batch-major multiplier
    warm start (lam_stage (B, N, nc), lam_term (B, nct), lam_eq (B, ne)) —
    the previous tick's SolveResult fields.  Returns a SolveResult with a
    leading batch axis on every field.
    """
    if kernel_path_applies(ocp, cfg, params, jax.default_backend()):
        return solve_batched_lanes(ocp, x0_b, U0_b, params, cfg, lam0_b)
    # per-scenario params entries map on their trailing (batch-minor) axis
    p_axes = _params_axes(params, _per_scenario_keys(params))
    if lam0_b is None:
        return jax.vmap(
            lambda x0, U0, p: al_ilqr_solve(ocp, x0, U0, p, cfg),
            in_axes=(0, 0, p_axes))(x0_b, U0_b, params)
    return jax.vmap(
        lambda x0, U0, ls, lt, le, p: al_ilqr_solve(
            ocp, x0, U0, p, cfg, lam0=(ls, lt, le)),
        in_axes=(0, 0, 0, 0, 0, p_axes))(x0_b, U0_b, *lam0_b, params)


def solve_batched_lanes(ocp: OCP, x0_b, U0_b, params,
                        cfg: SolverConfig = SolverConfig(), lam0_b=None,
                        interpret: bool = False) -> SolveResult:
    """The lanes path (see module doc), same contract as
    al_ilqr_solve_batched.  ``interpret`` runs the kernel through the
    Pallas interpreter, which is how CPU tests drive this path."""
    # the surrounding jnp algebra (candidate selection included) runs at
    # the same precision as al_ilqr_solve
    with jax.default_matmul_precision(cfg.matmul_precision):
        return _solve_batched_lanes(ocp, x0_b, U0_b, params, cfg, lam0_b,
                                    interpret)


def _solve_batched_lanes(ocp: OCP, x0_b, U0_b, params, cfg: SolverConfig,
                         lam0_b, interpret) -> SolveResult:
    B = x0_b.shape[0]
    dtype = jnp.result_type(x0_b)
    ps_keys = _per_scenario_keys(params)
    # core closures bind shared params; per-scenario entries get explicit
    # param-passing wrappers below (the kernels consume the batched arrays
    # directly) — the core sees scenario 0's values only for shape probing
    core_params = (params if not ps_keys
                   else dict(params,
                             **{k: params[k][..., 0] for k in ps_keys}))
    core = build_core(ocp, core_params, cfg, dtype)
    N, nc, nct, ne = core.N, core.nc, core.nct, core.ne
    fwd_ls = ocp.lanes_fwd_factory(cfg, interpret)
    alphas_idx = jnp.arange(cfg.n_alpha)
    inv_scale = 1.0 / cfg.cost_scale
    ks = jnp.arange(N)

    # ---- batch-minor vmapped building blocks --------------------------
    rollout_bm = jax.vmap(lambda x0, U: rollout(ocp, x0, U, params),
                          in_axes=(-1, -1), out_axes=-1)
    if ps_keys:
        p_axes = _params_axes(params, ps_keys)

        def al_total_p(X, U, lams, mu, p):
            ls, lt, le = lams

            def st(x, u, k, l):
                c = ocp.stage_cost(x, u, k, p) * inv_scale
                if nc:
                    c = c + _al_penalty_ineq(ocp.stage_ineq(x, u, k, p),
                                             l, mu)
                return c

            total = jnp.sum(jax.vmap(st)(X[:-1], U, ks, ls))
            term = ocp.terminal_cost(X[-1], p) * inv_scale
            if nct:
                term = term + _al_penalty_ineq(
                    ocp.terminal_ineq(X[-1], p), lt, mu)
            if ne:
                term = term + _al_penalty_eq(
                    ocp.terminal_eq(X[-1], p), le, mu)
            return total + term

        _al_total_v = jax.vmap(
            al_total_p, in_axes=(-1, -1, (-1, -1, -1), None, p_axes))

        def al_total_bm(X, U, lams, mu):
            return _al_total_v(X, U, lams, mu, params)
    else:
        al_total_bm = jax.vmap(core.al_total,
                               in_axes=(-1, -1, (-1, -1, -1), None))
    if ps_keys:
        def eval_con_p(X, U, p):
            cs = (jax.vmap(lambda x, u, k: ocp.stage_ineq(x, u, k, p))(
                X[:-1], U, ks) if nc else jnp.zeros((N, 0), dtype))
            ct = (ocp.terminal_ineq(X[-1], p) if nct
                  else jnp.zeros((0,), dtype))
            he = (ocp.terminal_eq(X[-1], p) if ne
                  else jnp.zeros((0,), dtype))
            return cs, ct, he

        _eval_con_v = jax.vmap(eval_con_p, in_axes=(-1, -1, p_axes),
                               out_axes=-1)

        def eval_con_bm(X, U):
            return _eval_con_v(X, U, params)
    else:
        eval_con_bm = jax.vmap(core.eval_constraints, in_axes=(-1, -1),
                               out_axes=-1)
    viol_bm = jax.vmap(core.violation, in_axes=(-1, -1, -1))

    p_axes_b = _params_axes(params, ps_keys)

    def backward_one(X, U, lam, lam_t, lam_e, mu, reg, p):
        """AL expansion + Riccati sweep of one scenario (batch-major)."""
        c = build_core(ocp, p, cfg, dtype)
        derivs = jax.vmap(c.stage_derivs, in_axes=(0, 0, 0, 0, None))(
            X[:-1], U, c.ks, lam, mu)
        term_g, term_H = c.terminal_derivs(X[-1], lam_t, lam_e, mu)
        return c.backward_scan(derivs, term_g, term_H, reg)

    backward_b = jax.vmap(backward_one,
                          in_axes=(0, 0, 0, 0, 0, None, 0, p_axes_b))

    def backward_bm(X, U, lams, mu, reg):
        # the sweep runs batch-major, as in the vmap path
        kff, K = backward_b(
            jnp.transpose(X, (2, 0, 1)), jnp.transpose(U, (2, 0, 1)),
            jnp.transpose(lams[0], (2, 0, 1)), lams[1].T, lams[2].T, mu,
            reg, params)
        return jnp.transpose(kff, (1, 2, 0)), jnp.transpose(K, (1, 2, 3, 0))

    def ilqr_iter(carry, lams_mu):
        X, U, cost, reg = carry     # X (N+1,nx,B), U (N,nu,B), cost/reg (B,)
        lams, mu = lams_mu          # lam_stage (N,nc,B), lam_term (nct,B)

        kffs, Ks = backward_bm(X, U, lams, mu, reg)
        # cc includes the terminal AL cost
        Xc, Uc, xlast, cc = fwd_ls(X[:-1], U, kffs, Ks, lams[0], lams[1],
                                   lams[2], mu, params)

        best = jnp.argmin(cc, axis=0)                        # (B,)
        onehot = (alphas_idx[:, None] == best[None, :]).astype(dtype)
        best_cost = jnp.sum(cc * onehot, axis=0)
        X_stage = jnp.einsum("kaxb,ab->kxb", Xc, onehot)
        U_best = jnp.einsum("kaub,ab->kub", Uc, onehot)
        x_last = jnp.einsum("axb,ab->xb", xlast, onehot)
        X_best = jnp.concatenate([X_stage, x_last[None]], axis=0)

        improved = best_cost < cost - 1e-12                  # (B,)
        X_new = jnp.where(improved[None, None, :], X_best, X)
        U_new = jnp.where(improved[None, None, :], U_best, U)
        cost_new = jnp.where(improved, best_cost, cost)
        reg_new = jnp.where(improved,
                            jnp.maximum(reg / cfg.reg_scale, cfg.reg_init),
                            jnp.minimum(reg * cfg.reg_scale, cfg.reg_max))
        return (X_new, U_new, cost_new, reg_new), None

    x0_bm = jnp.asarray(x0_b, dtype).T                       # (nx, B)
    U0_bm = jnp.transpose(jnp.asarray(U0_b, dtype), (1, 2, 0))

    def al_round(carry, i, inner_iters):
        # X already corresponds to U applied open-loop from x0 — only the
        # AL cost is re-based under the new (lams, mu); no re-rollout.
        X, U, lam_stage, lam_term, lam_eq, _ = carry
        mu = core.mu_at(i)
        lams = (lam_stage, lam_term, lam_eq)
        cost0 = al_total_bm(X, U, lams, mu)
        init = (X, U, cost0, jnp.full((B,), cfg.reg_init, dtype))
        (X, U_new, _, _), _ = jax.lax.scan(
            lambda c, _: ilqr_iter(c, (lams, mu)), init, None,
            length=inner_iters)
        cs, ct, he = eval_con_bm(X, U_new)                   # (N,nc,B) ...
        lam_stage = jnp.maximum(0.0, lam_stage + mu * cs)
        lam_term = jnp.maximum(0.0, lam_term + mu * ct)
        lam_eq = lam_eq + mu * he
        viol = viol_bm(cs, ct, he)
        return (X, U_new, lam_stage, lam_term, lam_eq, viol), None

    if lam0_b is None:
        lam0_bm = (jnp.zeros((N, nc, B), dtype),
                   jnp.zeros((nct, B), dtype), jnp.zeros((ne, B), dtype))
    else:
        # batch-major (B, N, nc) / (B, nct) / (B, ne) -> batch-minor
        lam0_bm = (jnp.transpose(jnp.asarray(lam0_b[0], dtype), (1, 2, 0)),
                   jnp.asarray(lam0_b[1], dtype).T,
                   jnp.asarray(lam0_b[2], dtype).T)
    X0_bm, Uc0_bm = rollout_bm(x0_bm, U0_bm)
    carry0 = (X0_bm, Uc0_bm, *lam0_bm,
              jnp.full((B,), jnp.inf, dtype))
    X_fin, U_fin, lam_stage, lam_term, lam_eq, viol = run_al_rounds(
        al_round, carry0, cfg)

    if ps_keys:
        cost = jax.vmap(lambda X, U, p: _objective(ocp, X, U, p),
                        in_axes=(-1, -1, p_axes))(X_fin, U_fin, params)
    else:
        cost = jax.vmap(lambda X, U: _objective(ocp, X, U, params),
                        in_axes=(-1, -1))(X_fin, U_fin)
    # back to the batch-major result contract
    return SolveResult(
        X=jnp.transpose(X_fin, (2, 0, 1)),
        U=jnp.transpose(U_fin, (2, 0, 1)),
        cost=cost, max_violation=viol,
        lam_stage=jnp.transpose(lam_stage, (2, 0, 1)),
        lam_term=lam_term.T, lam_eq=lam_eq.T,
        converged=viol < cfg.constraint_tol)
