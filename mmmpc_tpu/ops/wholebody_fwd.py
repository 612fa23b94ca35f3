"""Pallas kernel (Triton route): fused forward rollout + parallel line search
for the whole-body qref MPC.

One iLQR iteration's forward pass is a closed-loop rollout over the horizon
for every line-search step size.  As XLA code it is a ``lax.scan`` whose
per-step working set is one 9-state per scenario, so each of the N dependent
steps costs at least one kernel launch whatever the batch.  This kernel runs
the complete control-limited rollout for ALL step sizes in one launch:

- **one scenario per lane**: a program owns a power-of-two block of
  scenarios and every scalar of the recursion is a ``(block,)`` vector;
  arrays are batch-minor (``(..., B)``), so every load is contiguous along
  the batch;
- **the horizon is a loop inside the program**: the per-candidate states,
  the trig carry and the running costs are ``fori_loop`` carries held in
  registers; the FK of x_{k+1} computed for the dynamics step is reused as
  the constraint FK of step k+1 (and, on the last stage, as the reference's
  bug-compatible terminal self-collision group), so each stage pays exactly
  one FK per candidate;
- **shared problem data as scalars**: references, weights, obstacle and
  half-plane geometry and the AL penalty mu are scalar loads from small
  global arrays — runtime-mutable (the setWeight mechanism) without
  recompilation; bounds and masks are static Python floats baked into the
  unrolled penalty rows.

The stage semantics replicate solver/al_ilqr.py's fwd_pass + the whole-body
controller's AL stage cost (asserted in tests/test_fwd_lanes.py):

    u_k   = clamp(U_k + alpha * kff_k + K_k (x_k - X_k))
    cost += stage_cost(x_k, u_k) / cost_scale + PHR(stage_ineq, lam_k, mu)
    x_{k+1} = f(x_k, u_k)

The terminal AL cost (P-tracking + terminal slack groups + PHR on the
terminal boxes + the maskable position equality) is added after the loop,
where the FK of x_N is already in registers — the returned per-candidate
costs are complete.

Reference formulation being accelerated: /root/reference/controllers/
mpc_wholebody_qref.py:142-331 (costs/constraints) and the rollout protocol
of an iLQR line search (no reference equivalent — IPOPT owns the iterates).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from mmmpc_tpu.models.arm import A2, A3, A5, A6, A7
from mmmpc_tpu.ocp.constraints import (
    OBSTACLE_EXPAND_DIST, SELF_COLLISION_RADIUS,
)
from mmmpc_tpu.utils.configs import BASELINK2JOINT1_X, BASELINK2JOINT1_Z

# Scenarios per program and warps per program.  One scenario per thread
# (block = 32 * num_warps) keeps every per-scenario value in one thread's
# registers; 8192 scenarios then make 128 programs for the card's 132 SMs.
BLOCK = 64
NUM_WARPS = 2

_NEG_BIG = -1e9
_EPS = 1e-9  # matches utils/math.safe_norm / safe_dist


# --------------------------------------------------------------------------
# launch plumbing
# --------------------------------------------------------------------------

def _lanes_spec(shape):
    """BlockSpec of a batch-minor operand ``shape + (B,)``: program b sees
    lanes [b * BLOCK, (b + 1) * BLOCK)."""
    n = len(shape)
    return pl.BlockSpec(tuple(shape) + (BLOCK,), lambda b: (0,) * n + (b,))


def _whole_spec(shape):
    """BlockSpec of a shared operand every program reads whole."""
    n = len(shape)
    return pl.BlockSpec(tuple(shape), lambda b: (0,) * n)


def _pad_lanes(a, padded):
    """Pad the trailing batch axis to ``padded`` with copies of the last
    scenario (the pad lanes then compute finite values; the wrapper drops
    them)."""
    B = a.shape[-1]
    if B == padded:
        return a
    return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, padded - B)],
                   mode="edge")


# --------------------------------------------------------------------------
# per-lane algebra
# --------------------------------------------------------------------------

def _trig_full(x):
    """The 8 trig vectors the rollout carries: [s1, c1, st, ct, sb, cb, sp,
    cp] (sin/cos of q1, th = q1-q2, be = th-q3, psi).

    Computed ONCE per rollout (before the horizon loop); every stage then
    advances them with the angle-addition identity + a small-angle
    polynomial instead of re-evaluating sin/cos."""
    q1 = x[6]
    th = q1 - x[7]
    be = th - x[8]
    psi = x[2]
    return [jnp.sin(q1), jnp.cos(q1), jnp.sin(th), jnp.cos(th),
            jnp.sin(be), jnp.cos(be), jnp.sin(psi), jnp.cos(psi)]


def _sincos_small(d):
    """(sin d, cos d) for |d| <= ~0.7 by 7th/6th-order Taylor.

    The advanced angles move by dt * (clamped input rates): |d_q| <= 0.3,
    |d_psi| = dt |dpsi| <= ~0.65 even transiently (dpsi integrates clamped
    dw).  Worst-case poly error at d = 0.7: sin 3e-9, cos 8e-7 — below
    float32 resolution of the downstream FK/cost algebra."""
    d2 = d * d
    sd = d * (1.0 - d2 * ((1.0 / 6.0)
                          - d2 * ((1.0 / 120.0) - d2 * (1.0 / 5040.0))))
    cd = 1.0 - d2 * (0.5 - d2 * ((1.0 / 24.0) - d2 * (1.0 / 720.0)))
    return sd, cd


def _rot(s, c, sd, cd):
    """(sin(a+d), cos(a+d)) from sin/cos of a and d — exact identity."""
    return s * cd + c * sd, c * cd - s * sd


def _trig_advance(tr, x, u, dt):
    """Advance the trig carry across one dynamics step: the new angles are
    q1 + dt u2, th + dt (u2-u3), be + dt (u2-u3-u4), psi + dt dpsi — the
    exact increments of the dynamics — so the rotation is the exact
    angle-sum identity with only the tiny-delta sin/cos approximated."""
    s1, c1, st, ct, sb, cb, sp, cp = tr
    out = []
    for (s, c), d in zip(((s1, c1), (st, ct), (sb, cb), (sp, cp)),
                         (dt * u[2], dt * (u[2] - u[3]),
                          dt * (u[2] - u[3] - u[4]), dt * x[5])):
        out += _rot(s, c, *_sincos_small(d))
    return out


def _fk_from_trig(x, tr):
    """World-frame (ee, j2, j3) from the carried trig vectors — the same
    algebra as models/mobile_manipulator.wholebody_fk (itself the reference
    forward_tranformation, mobile_manipulator.py:17-55) with the sin/cos
    factored out into the carry."""
    px, py = x[0], x[1]
    s1, c1, st, ct, sb, cb, sp, cp = tr
    x2 = A2 * s1 + A3 * c1
    z2 = A2 * c1 - A3 * s1
    x3 = x2 - A3 * ct + A5 * st
    z3 = z2 + A3 * st + A5 * ct
    xe = x3 + A6 * cb - A7 * sb
    ze = z3 - A6 * sb - A7 * cb

    def lift(ax, az):
        r = ax + BASELINK2JOINT1_X
        return [px + r * cp, py + r * sp, az + BASELINK2JOINT1_Z]

    return lift(xe, ze), lift(x2, z2), lift(x3, z3)


def _dyn_tr(x, u, dt, sp, cp):
    """Per-lane wholebody_step (reference mobile_manipulator.py:57-75) with
    sin/cos(psi) supplied from the trig carry."""
    px, py, psi, dx, dy, dpsi = x[0], x[1], x[2], x[3], x[4], x[5]
    dV, dw = u[0], u[1]
    return [
        px + dt * dx,
        py + dt * dy,
        psi + dt * dpsi,
        dx + dt * (dV * cp - dy * dpsi),
        dy + dt * (dV * sp + dx * dpsi),
        dpsi + dt * dw,
        x[6] + dt * u[2],
        x[7] + dt * u[3],
        x[8] + dt * u[4],
    ]


def _selfcol(ee, j2, j3):
    """radius - ||check - ee|| for the 4 reference check points (the first is
    the *world origin* — reference quirk kept, mpc_wholebody_qref.py:219-222)."""
    checks = (
        [jnp.zeros_like(ee[0])] * 3,
        [j2[c] * 0.5 for c in range(3)],
        j2,
        [(j2[c] + j3[c]) * 0.5 for c in range(3)],
    )
    out = []
    for chk in checks:
        d2 = _EPS
        for c in range(3):
            dc = chk[c] - ee[c]
            d2 = d2 + dc * dc
        out.append(SELF_COLLISION_RADIUS - jnp.sqrt(d2))
    return out


def _qform(M, e, n):
    """e^T M e with M an (n, n) nested list of scalars and e a list of
    vectors."""
    acc = None
    for i in range(n):
        row = None
        for j in range(n):
            t = M[i][j] * e[j]
            row = t if row is None else row + t
        t = e[i] * row
        acc = t if acc is None else acc + t
    return acc


def _hp_group(pts, hp, any_live):
    """One slack row per sample point: minus the deepest half-plane
    penetration over the live faces (reference mpc_wholebody_qref.py:57-89)."""
    out = []
    for p in pts:
        dmax = None
        for (n0, n1, n2, o0, o1, o2, m) in hp:
            d = n0 * (o0 - p[0]) + n1 * (o1 - p[1]) + n2 * (o2 - p[2])
            d = jnp.where(m > 0, d, _NEG_BIG)
            dmax = d if dmax is None else jnp.maximum(dmax, d)
        out.append(jnp.where(any_live > 0, -dmax, _NEG_BIG))
    return out


def _sample_points(ee, j2, j3):
    return (
        [j2[c] * 0.5 for c in range(3)],
        j2,
        [(j2[c] + j3[c]) * 0.5 for c in range(3)],
        j3,
        [(j3[c] + ee[c]) * 0.5 for c in range(3)],
        ee,
    )


def _phr(rows, lam, mu):
    """Sum of PHR terms (max(lam + mu c, 0)^2 - lam^2) over the rows.

    Masked (infinite-bound) rows have c = None: the solver's penalty
    (al_ilqr._al_penalty_ineq) still subtracts their lam^2, so it is
    reproduced exactly."""
    pen = None
    for r, c in rows:
        if c is None:
            term = -lam[r] * lam[r]
        else:
            t = jnp.maximum(lam[r] + mu * c, 0.0)
            term = t * t - lam[r] * lam[r]
        pen = term if pen is None else pen + term
    return pen


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def _kernel(mu_ref, S_ref, Q_ref, R_ref, W_ref, P_ref, eqm_ref,
            xref_ref, xreft_ref, uref_ref,
            ulast_ref, obs_ref, obst_ref, hpo_ref, hpn_ref, hpm_ref,
            X_in, U_in, kff_in, K_in, lam_in, lamt_in, lame_in,
            Xc_out, Uc_out, xlast_out, cc_out, *,
            nx, nu, N, n_alpha, alphas, dt, inv_scale, base_radius,
            n_obs, n_hp, bug_compat, moving, x_bounds, du_bounds, u_clamp,
            ps_ulast, ps_xref, ps_qp, ps_eqm, ps_uref):
    mu = mu_ref[0]
    inv2mu = 0.5 / mu          # scalar: one divide instead of a vector one
    S = S_ref[0]
    x_lo, x_hi, x_mlo, x_mhi = x_bounds
    du_lo, du_hi, du_mlo, du_mhi = du_bounds
    u_lo, u_hi = u_clamp

    # per-scenario Q/P are DIAGONALS (the wrapper extracts them — the task
    # weight tables are diagonal, and a diagonal keeps the tracking cost at
    # nx products instead of nx^2)
    qd = [Q_ref[i, :] for i in range(nx)] if ps_qp else None
    pd = [P_ref[i, :] for i in range(nx)] if ps_qp else None
    Qm = None if ps_qp else [[Q_ref[i, j] for j in range(nx)]
                             for i in range(nx)]
    Pm = None if ps_qp else [[P_ref[i, j] for j in range(nx)]
                             for i in range(nx)]
    Rm = [[R_ref[i, j] for j in range(nu)] for i in range(nu)]
    Wm = [[W_ref[i, j] for j in range(nu)] for i in range(nu)]
    eqm_t = eqm_ref[:] if ps_eqm else eqm_ref[0]
    xr_N = ([xreft_ref[i, :] for i in range(nx)] if ps_xref
            else [xref_ref[N, i] for i in range(nx)])
    hp = [(hpn_ref[f, 0], hpn_ref[f, 1], hpn_ref[f, 2],
           hpo_ref[f, 0], hpo_ref[f, 1], hpo_ref[f, 2], hpm_ref[f])
          for f in range(n_hp)]
    any_live = hp[0][6]
    for f in range(1, n_hp):
        any_live = any_live + hp[f][6]

    x_init = [X_in[0, i, :] for i in range(nx)]
    tr0 = _trig_full(x_init)     # the only full sin/cos of the rollout
    zero = jnp.zeros_like(x_init[0])

    def stage(k, carry):
        xs, trs, costs = carry
        Xk = [X_in[k, i, :] for i in range(nx)]
        Uk = [U_in[k, i, :] for i in range(nu)]
        kffk = [kff_in[k, i, :] for i in range(nu)]
        Kk = [[K_in[k, i, j, :] for j in range(nx)] for i in range(nu)]
        lam = [lam_in[k, r, :] for r in range(2 * nx + 2 * nu)]
        # per-scenario U_last (fleet serving: each robot's previous command
        # sequence) and references are lane vectors; shared ones scalars
        ul = [ulast_ref[k, i, :] if ps_ulast else ulast_ref[k, i]
              for i in range(nu)]
        xr_k = [xref_ref[k, i, :] if ps_xref else xref_ref[k, i]
                for i in range(nx)]
        ur_k = [uref_ref[k, i, :] if ps_uref else uref_ref[k, i]
                for i in range(nu)]
        if moving:
            obs = [(obs_ref[k, o, 0], obs_ref[k, o, 1], obs_ref[k, o, 2])
                   for o in range(n_obs)]
        else:
            obs = [(obs_ref[o, 0], obs_ref[o, 1], obs_ref[o, 2])
                   for o in range(n_obs)]

        new_xs, new_trs, new_costs = [], [], []
        for a in range(n_alpha):
            x, tr = xs[a], trs[a]
            ee, j2, j3 = _fk_from_trig(x, tr)

            # -- control: feedforward + feedback, clamped to ulim ---------
            u = []
            for i in range(nu):
                acc = Uk[i] + alphas[a] * kffk[i]
                for j in range(nx):
                    acc = acc + Kk[i][j] * (x[j] - Xk[j])
                if math.isfinite(u_lo[i]):
                    acc = jnp.maximum(acc, u_lo[i])
                if math.isfinite(u_hi[i]):
                    acc = jnp.minimum(acc, u_hi[i])
                u.append(acc)

            # -- dynamics + advanced trig (reused as next stage's trig) ---
            xn = _dyn_tr(x, u, dt, tr[6], tr[7])
            trn = _trig_advance(tr, x, u, dt)

            # -- slack group (ground + self-collision + hp union) ---------
            gs = []
            for ox, oy, orad in obs:
                dx0 = x[0] - ox
                dy0 = x[1] - oy
                gs.append((orad + base_radius)
                          - jnp.sqrt(dx0 * dx0 + dy0 * dy0 + _EPS))
            gs += _selfcol(ee, j2, j3)
            gs += _hp_group(_sample_points(ee, j2, j3), hp, any_live)
            if bug_compat:
                # terminal self-collision rides stage N-1's slack group
                # (reference mpc_wholebody_qref.py:263-265 stale-index bug)
                een, j2n, j3n = _fk_from_trig(xn, trn)
                last = k == N - 1
                gs += [jnp.where(last, t, _NEG_BIG)
                       for t in _selfcol(een, j2n, j3n)]
            gmax = gs[0]
            for t in gs[1:]:
                gmax = jnp.maximum(gmax, t)
            smax = jnp.maximum(gmax, 0.0)

            # -- quadratic tracking costs ---------------------------------
            ex = [x[i] - xr_k[i] for i in range(nx)]
            eu = [u[i] - ur_k[i] for i in range(nu)]
            edu = [u[i] - ul[i] for i in range(nu)]
            if ps_qp:
                track = None
                for i in range(nx):
                    t = qd[i] * ex[i] * ex[i]
                    track = t if track is None else track + t
            else:
                track = _qform(Qm, ex, nx)
            track = track + _qform(Rm, eu, nu) + _qform(Wm, edu, nu)

            # -- PHR penalty on the box constraints (static rows) ---------
            rows = []
            for i in range(nx):
                rows.append((i, (x[i] - x_hi[i]) if x_mhi[i] else None))
            for i in range(nx):
                rows.append((nx + i, (x_lo[i] - x[i]) if x_mlo[i] else None))
            for i in range(nu):
                rows.append((2 * nx + i,
                             (edu[i] - du_hi[i]) if du_mhi[i] else None))
            for i in range(nu):
                rows.append((2 * nx + nu + i,
                             (du_lo[i] - edu[i]) if du_mlo[i] else None))
            stage_c = inv_scale * (track + S * smax * smax)
            stage_c = stage_c + _phr(rows, lam, mu) * inv2mu

            for i in range(nx):
                Xc_out[k, a, i, :] = x[i]
            for i in range(nu):
                Uc_out[k, a, i, :] = u[i]
            new_xs.append(xn)
            new_trs.append(trn)
            new_costs.append(costs[a] + stage_c)
        return new_xs, new_trs, new_costs

    init = ([list(x_init) for _ in range(n_alpha)],
            [list(tr0) for _ in range(n_alpha)],
            [zero for _ in range(n_alpha)])
    xs, trs, costs = jax.lax.fori_loop(0, N, stage, init)

    # ---- terminal AL cost (replicates al_ilqr.al_terminal: P-tracking +
    # S*relu_max(terminal slack groups)^2 + PHR on the terminal state boxes
    # + the maskable position equality)
    obs_t = [(obst_ref[o, 0], obst_ref[o, 1], obst_ref[o, 2])
             for o in range(n_obs)]
    lam_t = [lamt_in[i, :] for i in range(2 * nx)]
    lam_e = [lame_in[i, :] for i in range(2)]
    for a in range(n_alpha):
        xn, trn = xs[a], trs[a]
        een, j2n, j3n = _fk_from_trig(xn, trn)
        exN = [xn[i] - xr_N[i] for i in range(nx)]
        if ps_qp:
            trackN = None
            for i in range(nx):
                t = pd[i] * exN[i] * exN[i]
                trackN = t if trackN is None else trackN + t
        else:
            trackN = _qform(Pm, exN, nx)

        gsN = []
        for ox, oy, orad in obs_t:
            dx0 = xn[0] - ox
            dy0 = xn[1] - oy
            gsN.append((orad + base_radius)
                       - jnp.sqrt(dx0 * dx0 + dy0 * dy0 + _EPS))
        gsN += _hp_group(_sample_points(een, j2n, j3n), hp, any_live)
        if not bug_compat:
            gsN += _selfcol(een, j2n, j3n)
        gmaxN = gsN[0]
        for t in gsN[1:]:
            gmaxN = jnp.maximum(gmaxN, t)
        smaxN = jnp.maximum(gmaxN, 0.0)

        rows = []
        for i in range(nx):
            rows.append((i, (xn[i] - x_hi[i]) if x_mhi[i] else None))
            rows.append((nx + i, (x_lo[i] - xn[i]) if x_mlo[i] else None))
        penN = _phr(rows, lam_t, mu)

        peneq = zero
        for i in range(2):
            h = eqm_t * (xn[i] - xr_N[i])
            peneq = peneq + lam_e[i] * h + 0.5 * mu * h * h

        cterm = (costs[a] + inv_scale * (trackN + S * smaxN * smaxN)
                 + penN * inv2mu + peneq)
        for i in range(nx):
            xlast_out[a, i, :] = xn[i]
        cc_out[a, :] = cterm


def make_fwd_linesearch(*, nx, nu, N, dt, base_radius, n_obs, n_hp,
                        x_bounds, du_bounds, u_clamp, alphas, inv_scale,
                        bug_compat, moving, interpret=False):
    """Build the fused line-search rollout for one whole-body qref OCP.

    Static data (bounds, masks, clamp limits, alphas, dt) is baked into the
    kernel; runtime data (weights, references, obstacle geometry, multipliers,
    mu) arrives per call.  Returns

        fwd(X_bm, U_bm, kff_bm, K_bm, lam_bm, lamt_bm, lame_bm, mu, params)
            -> (Xc (N, n_alpha, nx, B), Uc (N, n_alpha, nu, B),
                xlast (n_alpha, nx, B), cc (n_alpha, B))

    with all arrays batch-minor and any batch B (padded to ``BLOCK`` inside).
    cc INCLUDES the terminal AL cost; lamt_bm (2*nx, B) and lame_bm (2, B)
    are the terminal box / equality multipliers.  ``interpret`` runs the
    kernel through the Pallas interpreter (CPU tests).
    """
    n_alpha = len(alphas)
    nc = 2 * nx + 2 * nu
    f32 = jnp.float32

    x_bounds = tuple(tuple(float(v) if i < 2 else bool(v) for v in b)
                     for i, b in enumerate(x_bounds))
    du_bounds = tuple(tuple(float(v) if i < 2 else bool(v) for v in b)
                      for i, b in enumerate(du_bounds))
    u_clamp = tuple(tuple(float(v) for v in b) for b in u_clamp)
    alphas = tuple(float(a) for a in alphas)

    def fwd(X_bm, U_bm, kff_bm, K_bm, lam_bm, lamt_bm, lame_bm, mu, params):
        assert X_bm.shape[:-1] == (N, nx) and lam_bm.shape[1] == nc
        B = X_bm.shape[-1]
        Bp = -(-B // BLOCK) * BLOCK
        # A per-scenario params entry carries a trailing batch axis (fleet
        # task serving: each robot's phase owns its reference window,
        # weight-table row and equality mask — solver/batched.py::
        # _per_scenario_keys).  Per-scenario Q/P must be DIAGONAL: only
        # their diagonals reach the kernel.  Unused operands are dummies.
        p = {k: jnp.asarray(params[k], f32)
             for k in ("Q", "P", "R", "W", "S", "X_ref", "U_ref", "U_last",
                       "eq_mask", "obstacles")}
        ps_ulast = p["U_last"].ndim == 3          # (N, nu, B)
        ps_xref = p["X_ref"].ndim == 3            # (N+1, nx, B)
        ps_qp = p["Q"].ndim == 3                  # (nx, nx, B)
        ps_eqm = p["eq_mask"].ndim == 1           # (B,)
        ps_uref = p["U_ref"].ndim == 3            # (N, nu, B)
        Q, P = p["Q"], p["P"]
        if ps_qp:
            Q = jnp.diagonal(Q, axis1=0, axis2=1).T      # (nx, B)
            P = jnp.diagonal(P, axis1=0, axis2=1).T
        X_ref, X_ref_term = p["X_ref"], jnp.zeros((1,), f32)
        if ps_xref:
            X_ref, X_ref_term = X_ref[:N], X_ref[N]
        obs = obs_t = p["obstacles"]
        if n_obs == 0:
            obs_t = jnp.zeros((1, 3), f32)
            obs = jnp.zeros((N, 1, 3) if moving else (1, 3), f32)
        elif moving:
            obs_t, obs = obs[N], obs[:N]
        hp_o = jnp.asarray(params["hp_points"] - OBSTACLE_EXPAND_DIST
                           * params["hp_normals"], f32)

        # (operand, whether it carries the batch as its last axis)
        operands = [
            (jnp.asarray(mu, f32).reshape(1), False),
            (p["S"].reshape(1), False),
            (Q, ps_qp), (p["R"], False), (p["W"], False), (P, ps_qp),
            (p["eq_mask"] if ps_eqm else p["eq_mask"].reshape(1), ps_eqm),
            (X_ref, ps_xref), (X_ref_term, ps_xref),
            (p["U_ref"], ps_uref), (p["U_last"], ps_ulast),
            (obs, False), (obs_t, False), (hp_o, False),
            (jnp.asarray(params["hp_normals"], f32), False),
            (jnp.asarray(params["hp_mask"], f32).reshape(n_hp), False),
            (X_bm, True), (U_bm, True), (kff_bm, True), (K_bm, True),
            (lam_bm, True), (lamt_bm, True), (lame_bm, True),
        ]
        args = [_pad_lanes(a.astype(f32), Bp) if b else a
                for a, b in operands]
        in_specs = [_lanes_spec(a.shape[:-1]) if b
                    else _whole_spec(a.shape)
                    for a, (_, b) in zip(args, operands)]
        out_shape = [
            jax.ShapeDtypeStruct((N, n_alpha, nx, Bp), f32),
            jax.ShapeDtypeStruct((N, n_alpha, nu, Bp), f32),
            jax.ShapeDtypeStruct((n_alpha, nx, Bp), f32),
            jax.ShapeDtypeStruct((n_alpha, Bp), f32),
        ]
        kernel = functools.partial(
            _kernel, nx=nx, nu=nu, N=N, n_alpha=n_alpha, alphas=alphas,
            dt=float(dt), inv_scale=float(inv_scale),
            base_radius=float(base_radius), n_obs=n_obs, n_hp=n_hp,
            bug_compat=bug_compat, moving=moving,
            x_bounds=x_bounds, du_bounds=du_bounds, u_clamp=u_clamp,
            ps_ulast=ps_ulast, ps_xref=ps_xref, ps_qp=ps_qp,
            ps_eqm=ps_eqm, ps_uref=ps_uref)
        Xc, Uc, xlast, cc = pl.pallas_call(
            kernel, grid=(Bp // BLOCK,), in_specs=in_specs,
            out_specs=[_lanes_spec(o.shape[:-1]) for o in out_shape],
            out_shape=out_shape, backend="triton", name="wholebody_fwd",
            compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                               num_stages=1),
            interpret=interpret)(*args)
        return Xc[..., :B], Uc[..., :B], xlast[..., :B], cc[..., :B]

    return fwd
