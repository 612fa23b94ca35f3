"""Augmented-Lagrangian iLQR — the on-device replacement for IPOPT.

Where the reference hands one NLP per control tick to IPOPT's interior-point
loop (C++, host-side, ~316 variables, mpc_wholebody_qref.py:314-317), this
solver runs entirely on-device with fixed shapes and fixed iteration counts:

- outer loop: Powell-Hestenes-Rockafellar augmented Lagrangian over the hard
  inequality/equality constraints (state boxes, input-rate boxes, injected
  terminal equality), multipliers updated per round, penalty grown
  geometrically;
- inner loop: iLQR — a Riccati backward sweep on Gauss-Newton stage
  expansions (hand-assembled Jacobians when the OCP provides them, one
  forward-mode Jacobian otherwise, exact Hessians as a last resort),
  followed by a forward rollout with a *parallel* backtracking line search
  (all step sizes evaluated in one vmapped rollout batch, best-by-merit
  selected);
- input boxes additionally enforced by clamping in the rollout
  (control-limited iLQR), so iterates stay feasible w.r.t. ulim throughout.

Two entry points:
- ``al_ilqr_solve``        one scenario; jit/vmap-safe (closed-loop control);
- ``al_ilqr_solve_batched``  (solver/batched.py) the high-throughput path:
  a batch of scenarios in one program, through fused Pallas kernels on the
  GPU where the OCP provides them.

Numerical notes: objective scaling (cfg.cost_scale) keeps the reference's
~1e5-magnitude costs inside float32 mantissa; the unrolled tiny-Cholesky
(linalg_small.py) replaces batched LAPACK solves, which dominate runtime
otherwise.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mmmpc_tpu.ocp.spec import OCP
from mmmpc_tpu.solver.linalg_small import chol_solve_unrolled
from mmmpc_tpu.utils.configs import SolverConfig


class SolveResult(NamedTuple):
    X: jnp.ndarray            # (N+1, nx) optimal state trajectory
    U: jnp.ndarray            # (N, nu) optimal inputs
    cost: jnp.ndarray         # scalar: original (non-AL) objective
    max_violation: jnp.ndarray  # scalar: max over hard constraints (<=0 ok)
    lam_stage: jnp.ndarray    # (N, nc) inequality multipliers
    lam_term: jnp.ndarray     # (nct,)
    lam_eq: jnp.ndarray       # (ne,)
    converged: jnp.ndarray    # bool: viol < tol at exit


def rollout(ocp: OCP, x0, U, params):
    """Roll the dynamics forward under clamped inputs. Returns (X, Uc)."""

    def step(x, u):
        uc = ocp.clamp_u(u)
        x_next = ocp.dynamics(x, uc)
        return x_next, (x, uc)

    x_last, (Xs, Uc) = jax.lax.scan(step, x0, U)
    X = jnp.concatenate([Xs, x_last[None, :]], axis=0)
    return X, Uc


def _objective(ocp: OCP, X, U, params):
    ks = jnp.arange(ocp.N)
    stage = jax.vmap(lambda x, u, k: ocp.stage_cost(x, u, k, params))(
        X[:-1], U, ks)
    return jnp.sum(stage) + ocp.terminal_cost(X[-1], params)


def _al_penalty_ineq(c, lam, mu):
    """PHR penalty for c <= 0 with multiplier lam >= 0."""
    t = jnp.maximum(0.0, lam + mu * c)
    return (jnp.sum(t * t) - jnp.sum(lam * lam)) / (2.0 * mu)


def _al_penalty_eq(h, lam, mu):
    return jnp.sum(lam * h) + 0.5 * mu * jnp.sum(h * h)


def resolve_assoc_scan(cfg: SolverConfig) -> bool:
    """Decide scan vs associative-scan backward sweep.

    ``cfg.use_assoc_scan``: True forces the associative scan, False the
    sequential scan.  "auto" is the sequential scan: the parallel-prefix
    factorization can only win where the sweep is latency-bound (small
    batch, long horizon), and that crossover has not been measured on the
    GPU (scripts/bench_longhorizon.py measures it).  Any other string is an
    error (a typo like "Auto" must not silently pick a path).
    """
    mode = cfg.use_assoc_scan
    if isinstance(mode, str) and mode != "auto":
        raise ValueError(
            f"use_assoc_scan={mode!r}: expected True, False, or 'auto'")
    return mode is True


def build_core(ocp: OCP, params, cfg: SolverConfig, dtype):
    """Per-scenario solver building blocks shared by the single-scenario and
    batched entry points."""
    nx, nu, N = ocp.nx, ocp.nu, ocp.N

    nc = jax.eval_shape(ocp.stage_ineq, jnp.zeros(nx, dtype),
                        jnp.zeros(nu, dtype), 0, params).shape[0]
    nct = jax.eval_shape(ocp.terminal_ineq, jnp.zeros(nx, dtype),
                         params).shape[0]
    ne = jax.eval_shape(ocp.terminal_eq, jnp.zeros(nx, dtype),
                        params).shape[0]
    ks = jnp.arange(N)

    # Uniform objective scaling for float32 conditioning (see SolverConfig.
    # cost_scale): minimizing f/s with AL penalties is the same program with
    # multipliers/penalties re-based by s; solutions are unchanged.
    inv_scale = 1.0 / cfg.cost_scale
    sqrt_inv_scale = jnp.sqrt(jnp.asarray(inv_scale, dtype))

    def al_stage(x, u, k, lam_k, mu):
        cost = ocp.stage_cost(x, u, k, params) * inv_scale
        if nc:
            cost = cost + _al_penalty_ineq(
                ocp.stage_ineq(x, u, k, params), lam_k, mu)
        return cost

    def al_terminal(x, lam_t, lam_e, mu):
        cost = ocp.terminal_cost(x, params) * inv_scale
        if nct:
            cost = cost + _al_penalty_ineq(ocp.terminal_ineq(x, params),
                                           lam_t, mu)
        if ne:
            cost = cost + _al_penalty_eq(ocp.terminal_eq(x, params),
                                         lam_e, mu)
        return cost

    def al_total(X, U, lams, mu):
        lam_stage, lam_term, lam_eq = lams
        stage = jax.vmap(lambda x, u, k, l: al_stage(x, u, k, l, mu))(
            X[:-1], U, ks, lam_stage)
        return jnp.sum(stage) + al_terminal(X[-1], lam_term, lam_eq, mu)

    # ---- derivative paths ----
    use_gn = ocp.stage_residuals is not None
    use_hand = ocp.has_hand_jacobians

    def _dyn_jacs(x, u):
        if ocp.dynamics_jacobians is not None:
            return ocp.dynamics_jacobians(x, u)
        A = jax.jacfwd(ocp.dynamics, argnums=0)(x, u)
        B = jax.jacfwd(ocp.dynamics, argnums=1)(x, u)
        return A, B

    def stage_derivs_exact(x, u, k, lam_k, mu):
        z = jnp.concatenate([x, u])

        def fz(zz):
            return al_stage(zz[:nx], zz[nx:], k, lam_k, mu)

        g = jax.grad(fz)(z)
        H = jax.hessian(fz)(z)
        # PSD guard: exact Hessians of nonconvex stage costs can be
        # indefinite, and an indefinite Quu reaching the unrolled Cholesky
        # produces sqrt(<0) = NaN before the regularization feedback loop can
        # react.  Clamp eigenvalues (tiny (nx+nu)^2 matrix; this path is the
        # cold general-OCP fallback, never the batched hot path, so an eigh
        # per stage is affordable).  The GN/hand/AL-expansion paths build
        # J^T J and are PSD by construction.
        H = 0.5 * (H + H.T)
        w, V = jnp.linalg.eigh(H)
        H = (V * jnp.maximum(w, 1e-8)) @ V.T
        A, B = _dyn_jacs(x, u)
        return (g[:nx], g[nx:], H[:nx, :nx], H[nx:, nx:], H[nx:, :nx], A, B)

    def stage_derivs_gn(x, u, k, lam_k, mu):
        """Gauss-Newton expansion: the scaled AL stage cost is (up to
        multiplier constants) ||r(z)||^2 with
        r = [sqrt(1/s) * cost residuals, sqrt(mu/2) * max(0, lam/mu + c)],
        so grad = 2 J^T r and a PSD Hessian 2 J^T J from one forward-mode
        Jacobian — no reverse pass, no second derivatives of FK trig."""
        z = jnp.concatenate([x, u])

        def rz(zz):
            xx, uu = zz[:nx], zz[nx:]
            parts = [ocp.stage_residuals(xx, uu, k, params) * sqrt_inv_scale]
            if nc:
                c = ocp.stage_ineq(xx, uu, k, params)
                parts.append(jnp.sqrt(mu / 2) *
                             jnp.maximum(0.0, lam_k / mu + c))
            return jnp.concatenate(parts)

        r = rz(z)
        J = jax.jacfwd(rz)(z)
        g = 2.0 * (J.T @ r)
        H = 2.0 * (J.T @ J)
        A, B = _dyn_jacs(x, u)
        return (g[:nx], g[nx:], H[:nx, :nx], H[nx:, nx:], H[nx:, :nx], A, B)

    def stage_derivs_hand(x, u, k, lam_k, mu):
        """Hand-assembled GN expansion: no AD in the hot loop at all (save
        whatever minimal AD the OCP's *_jac callables use internally)."""
        r, J = ocp.stage_gn(x, u, k, params)
        r = r * sqrt_inv_scale
        J = J * sqrt_inv_scale
        if nc:
            c, Jc = ocp.stage_ineq_jac(x, u, k, params)
            t = lam_k / mu + c
            w = jnp.sqrt(mu / 2)
            r = jnp.concatenate([r, w * jnp.maximum(0.0, t)])
            J = jnp.concatenate(
                [J, w * jnp.where((t > 0)[:, None], Jc, 0.0)], axis=0)
        g = 2.0 * (J.T @ r)
        H = 2.0 * (J.T @ J)
        A, B = ocp.dynamics_jacobians(x, u)
        return (g[:nx], g[nx:], H[:nx, :nx], H[nx:, nx:], H[nx:, :nx], A, B)

    use_al_exp = ocp.has_al_expansion

    def stage_derivs_al_exp(x, u, k, lam_k, mu):
        lx, lu, lxx, luu, lux = ocp.stage_al_expansion(
            x, u, k, params, lam_k, mu, inv_scale)
        A, B = ocp.dynamics_jacobians(x, u)
        return (lx, lu, lxx, luu, lux, A, B)

    stage_derivs = (stage_derivs_al_exp if use_al_exp
                    else stage_derivs_hand if use_hand
                    else stage_derivs_gn if use_gn else stage_derivs_exact)

    def terminal_res(x, lam_t, lam_e, mu):
        parts = [ocp.terminal_residuals(x, params) * sqrt_inv_scale]
        if nct:
            c = ocp.terminal_ineq(x, params)
            parts.append(jnp.sqrt(mu / 2) * jnp.maximum(0.0, lam_t / mu + c))
        if ne:
            h = ocp.terminal_eq(x, params)
            parts.append(jnp.sqrt(mu / 2) * (h + lam_e / mu))
        return jnp.concatenate(parts)

    def terminal_derivs_hand(x, lam_t, lam_e, mu):
        r, J = ocp.terminal_gn(x, params)
        r = r * sqrt_inv_scale
        J = J * sqrt_inv_scale
        w = jnp.sqrt(mu / 2)
        if nct:
            c, Jc = ocp.terminal_ineq_jac(x, params)
            t = lam_t / mu + c
            r = jnp.concatenate([r, w * jnp.maximum(0.0, t)])
            J = jnp.concatenate(
                [J, w * jnp.where((t > 0)[:, None], Jc, 0.0)], axis=0)
        if ne:
            h, Jh = ocp.terminal_eq_jac(x, params)
            r = jnp.concatenate([r, w * (h + lam_e / mu)])
            J = jnp.concatenate([J, w * Jh], axis=0)
        return 2.0 * (J.T @ r), 2.0 * (J.T @ J)

    def terminal_derivs(x, lam_t, lam_e, mu):
        if use_al_exp:
            return ocp.terminal_al_expansion(x, params, lam_t, lam_e, mu,
                                             inv_scale)
        if use_hand:
            return terminal_derivs_hand(x, lam_t, lam_e, mu)
        if use_gn:
            rt = terminal_res(x, lam_t, lam_e, mu)
            Jt = jax.jacfwd(
                lambda xx: terminal_res(xx, lam_t, lam_e, mu))(x)
            return 2.0 * (Jt.T @ rt), 2.0 * (Jt.T @ Jt)
        g = jax.grad(lambda xx: al_terminal(xx, lam_t, lam_e, mu))(x)
        H = jax.hessian(lambda xx: al_terminal(xx, lam_t, lam_e, mu))(x)
        # Same PSD guard as stage_derivs_exact: an indefinite terminal V_xx
        # seeds the whole backward sweep.
        H = 0.5 * (H + H.T)
        w, V = jnp.linalg.eigh(H)
        return g, (V * jnp.maximum(w, 1e-8)) @ V.T

    def fwd_pass(x0, X, U, kffs, Ks, alpha, lams, mu):
        """Closed-loop rollout with step size alpha: (Xn, Un, cost)."""

        def step(carry, inp):
            x, cost = carry
            X_k, U_k, kff, K, k, lam_k = inp
            u = ocp.clamp_u(U_k + alpha * kff + K @ (x - X_k))
            cost = cost + al_stage(x, u, k, lam_k, mu)
            return (ocp.dynamics(x, u), cost), (x, u)

        (x_last, cost), (Xs, Un) = jax.lax.scan(
            step, (x0, jnp.zeros((), dtype)),
            (X[:-1], U, kffs, Ks, ks, lams[0]), unroll=cfg.scan_unroll)
        cost = cost + al_terminal(x_last, lams[1], lams[2], mu)
        Xn = jnp.concatenate([Xs, x_last[None, :]], axis=0)
        return Xn, Un, cost

    eye_u = jnp.eye(nu, dtype=dtype)

    def backward_assoc(derivs, term_g, term_H, reg):
        """O(log N)-depth parallel-prefix Riccati (long-horizon path)."""
        from mmmpc_tpu.ops.assoc_riccati import assoc_riccati_backward
        return assoc_riccati_backward(*derivs, term_g, term_H, reg=reg)

    def backward_scan(derivs, term_g, term_H, reg):
        """Pure-JAX Riccati backward sweep (per scenario)."""

        def bwd(carry_b, inp):
            Vx, Vxx = carry_b
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

        (_, _), (kffs_r, Ks_r) = jax.lax.scan(
            bwd, (term_g, term_H), jax.tree.map(lambda a: a[::-1], derivs))
        return kffs_r[::-1], Ks_r[::-1]

    def eval_constraints(X, U):
        cs = (jax.vmap(lambda x, u, k: ocp.stage_ineq(x, u, k, params))(
            X[:-1], U, ks) if nc else jnp.zeros((N, 0), dtype))
        ct = (ocp.terminal_ineq(X[-1], params) if nct
              else jnp.zeros((0,), dtype))
        he = (ocp.terminal_eq(X[-1], params) if ne
              else jnp.zeros((0,), dtype))
        return cs, ct, he

    def violation(cs, ct, he):
        viol = jnp.maximum(
            jnp.max(cs, initial=-jnp.inf) if nc else -jnp.inf,
            jnp.max(ct, initial=-jnp.inf) if nct else -jnp.inf)
        return jnp.maximum(viol, jnp.max(jnp.abs(he), initial=0.0)
                           if ne else 0.0)

    def mu_at(i):
        return jnp.minimum(cfg.mu_init * cfg.mu_scale ** i.astype(dtype),
                           cfg.mu_max)

    return types.SimpleNamespace(
        nx=nx, nu=nu, N=N, nc=nc, nct=nct, ne=ne, ks=ks, dtype=dtype,
        al_stage=al_stage, al_terminal=al_terminal, al_total=al_total,
        stage_derivs=stage_derivs, terminal_derivs=terminal_derivs,
        fwd_pass=fwd_pass,
        backward_scan=(backward_assoc
                       if resolve_assoc_scan(cfg)
                       else backward_scan),
        eval_constraints=eval_constraints, violation=violation, mu_at=mu_at)


def run_al_rounds(al_round, carry0, cfg: SolverConfig):
    """Drive the AL outer loop with the (first, middle, final) inner-budget
    schedule: the first round solves from scratch, middle rounds track the
    multiplier updates, the last round polishes (its solve quality decides
    the final violation).  Shared by all solver entry points."""
    later = (cfg.ilqr_iters_later if cfg.ilqr_iters_later is not None
             else cfg.ilqr_iters)
    final = (cfg.ilqr_iters_final if cfg.ilqr_iters_final is not None
             else later)
    carry, _ = al_round(carry0, jnp.asarray(0), cfg.ilqr_iters)
    last = cfg.al_iters - 1
    if last < 1:
        return carry
    n_mid = last - 1 if final != later else last
    if n_mid > 0:
        carry, _ = jax.lax.scan(
            lambda c, i: al_round(c, i, later), carry,
            jnp.arange(1, 1 + n_mid))
    if final != later:
        carry, _ = al_round(carry, jnp.asarray(last), final)
    return carry


def shift_multipliers(lam_stage, lam_term, lam_eq, decay: float = 0.5):
    """Receding-horizon warm start for AL multipliers: shift the stage
    multipliers forward one control period (repeat the last stage), keep the
    terminal groups, and *damp* everything by ``decay``.

    The damping is load-bearing: a solve's returned multipliers include one
    final update applied at the largest penalty (lam += mu_last * c), which
    overshoots whenever the inner solve is inexact (the RT budget).  Carrying
    the full duals tick-over-tick winds that overshoot up into divergence;
    the geometric decay makes the cross-tick dual loop a leaky integrator
    whose steady state still pins the active constraints (measured: exact
    0.0 steady-state violation at the 3x(6,4) RT budget vs ~4e-3 for
    primal-only warm starts).  The analogue of carrying IPOPT's duals
    between ticks — the reference cold-starts its duals every tick
    (mpc_wholebody_qref.py:295-304 warm-starts primal U only)."""
    axis = lam_stage.ndim - 2 if lam_stage.ndim >= 2 else 0
    shifted = jnp.concatenate(
        [jax.lax.slice_in_dim(lam_stage, 1, None, axis=axis),
         jax.lax.slice_in_dim(lam_stage, -1, None, axis=axis)], axis=axis)
    return decay * shifted, decay * lam_term, decay * lam_eq


def al_ilqr_solve(ocp: OCP, x0, U_init, params,
                  cfg: SolverConfig = SolverConfig(),
                  lam0=None) -> SolveResult:
    """Solve the OCP from initial state x0 with warm-start inputs U_init.

    lam0: optional (lam_stage (N, nc), lam_term (nct,), lam_eq (ne,)) warm
    start for the AL multipliers (e.g. the previous tick's SolveResult fields
    through ``shift_multipliers``).  Zeros when None (cold start).

    """
    # a float32 product may run in reduced precision (TF32 on the GPU); at
    # the solver's 9x9 scale full precision costs little and reduced
    # precision breaks closed-loop regulation (SolverConfig.matmul_precision)
    with jax.default_matmul_precision(cfg.matmul_precision):
        return _al_ilqr_solve_body(ocp, x0, U_init, params, cfg, lam0)


def _al_ilqr_solve_body(ocp: OCP, x0, U_init, params, cfg: SolverConfig,
                        lam0) -> SolveResult:
    dtype = jnp.result_type(x0)
    core = build_core(ocp, params, cfg, dtype)
    N, nc, nct, ne = core.N, core.nc, core.nct, core.ne

    def ilqr_iter(carry, lams_mu):
        X, U, cost, reg = carry
        lams, mu = lams_mu

        derivs = jax.vmap(
            lambda x, u, k, l: core.stage_derivs(x, u, k, l, mu))(
                X[:-1], U, core.ks, lams[0])
        term_g, term_H = core.terminal_derivs(X[-1], lams[1], lams[2], mu)
        kffs, Ks = core.backward_scan(derivs, term_g, term_H, reg)

        alphas = cfg.alpha_decay ** jnp.arange(cfg.n_alpha, dtype=dtype)
        Xc, Uc, cc = jax.vmap(
            lambda a: core.fwd_pass(X[0], X, U, kffs, Ks, a, lams, mu))(
                alphas)

        best = jnp.argmin(cc)
        best_cost = cc[best]
        improved = best_cost < cost - 1e-12
        X_new = jnp.where(improved, Xc[best], X)
        U_new = jnp.where(improved, Uc[best], U)
        cost_new = jnp.where(improved, best_cost, cost)
        reg_new = jnp.where(improved,
                            jnp.maximum(reg / cfg.reg_scale, cfg.reg_init),
                            jnp.minimum(reg * cfg.reg_scale, cfg.reg_max))
        return (X_new, U_new, cost_new, reg_new), None

    def al_round(carry, i, inner_iters):
        # X corresponds to U applied open-loop from x0 (the accepted line-
        # search rollout), so re-rolling the dynamics every round is
        # redundant — only the AL cost must be re-based under the new
        # (lams, mu).
        X, U, lam_stage, lam_term, lam_eq, _ = carry
        mu = core.mu_at(i)
        lams = (lam_stage, lam_term, lam_eq)
        cost0 = core.al_total(X, U, lams, mu)
        init = (X, U, cost0, jnp.asarray(cfg.reg_init, dtype))
        (X, U_new, _, _), _ = jax.lax.scan(
            lambda c, _: ilqr_iter(c, (lams, mu)), init, None,
            length=inner_iters)
        cs, ct, he = core.eval_constraints(X, U_new)
        lam_stage = jnp.maximum(0.0, lam_stage + mu * cs)
        lam_term = jnp.maximum(0.0, lam_term + mu * ct)
        lam_eq = lam_eq + mu * he
        viol = core.violation(cs, ct, he)
        return (X, U_new, lam_stage, lam_term, lam_eq, viol), None

    if lam0 is None:
        lam0 = (jnp.zeros((N, nc), dtype), jnp.zeros((nct,), dtype),
                jnp.zeros((ne,), dtype))
    X0, Uc0 = rollout(ocp, x0, jnp.asarray(U_init, dtype), params)
    carry0 = (X0, Uc0,
              jnp.asarray(lam0[0], dtype), jnp.asarray(lam0[1], dtype),
              jnp.asarray(lam0[2], dtype), jnp.asarray(jnp.inf, dtype))
    X_fin, U_fin, lam_stage, lam_term, lam_eq, viol = run_al_rounds(
        al_round, carry0, cfg)

    cost = _objective(ocp, X_fin, U_fin, params)
    return SolveResult(
        X=X_fin, U=U_fin, cost=cost, max_violation=viol,
        lam_stage=lam_stage, lam_term=lam_term, lam_eq=lam_eq,
        converged=viol < cfg.constraint_tol)
