"""Whole-body MPC with joint-space reference — THE main controller.

JAX re-design of the reference MPCWholeBody
(/root/reference/controllers/mpc_wholebody_qref.py): 9-state / 5-input
receding-horizon MPC with

- state/input/input-rate quadratic tracking costs (Q, R, W) and terminal P,
- ground circle obstacles, half-plane-union manipulator obstacles and
  self-collision spheres folded into the exact slack penalty S*relu(max g)^2
  (see ocp/spec.py for the equivalence proof sketch),
- hard state boxes, input boxes (clamped + AL), input-rate boxes,
- runtime-mutable weights (setWeight) and a runtime-maskable terminal
  position equality (the FSM-injected constraint, interface:167) — all as
  jit *arguments*, so task-phase switches never recompile,
- warm-started U / U_last coupling and the return-u[0] protocol
  (mpc_wholebody_qref.py:287-331).

The reference's terminal-block bug — terminal self-collision constrained
against the stale stage slack s[N-1] (mpc_wholebody_qref.py:263-265) — is
replicated by folding the terminal self-collision values into stage N-1's
penalty group (X_N is reconstructed from (x_{N-1}, u_{N-1}) via the
dynamics); set ``replicate_terminal_selfcol_bug=False`` for the fixed
formulation.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from mmmpc_tpu.controllers.common import (
    ControllerBase, as_weight_matrix, finite_bound_masks, scalar_weight,
    weight_sqrt,
)
from mmmpc_tpu.models.mobile_manipulator import (
    wholebody_fk, wholebody_jacobians, wholebody_step,
)
from mmmpc_tpu.models.obstacles import ground_obstacle_array
from mmmpc_tpu.ocp import OCP
from mmmpc_tpu.ocp.constraints import (
    _NEG_BIG, box_g, ground_circle_g, halfplane_union_g,
    manipulator_sample_points, relu_max, relu_max_penalty, self_collision_g,
)
from mmmpc_tpu.utils.configs import SolverConfig

PI = math.pi

_DEFAULT_Q = 5 * np.diag([5, 5, 0, 0, 0, 1, 1, 1, 1.0])
_DEFAULT_R = np.diag([0.1, 0.1, 0.0, 0.0, 0.0])
_DEFAULT_S = np.diag([1e5])
_DEFAULT_W = np.diag([0, 0, 1e-1, 1e-1, 1e-1])
_DEFAULT_ULIM = np.array([[-2, -PI, -1, -1, -1], [2, PI, 1, 1, 1.0]])
_DEFAULT_XLIM = np.array([
    [-100, -100, -np.inf, -2, -2, -PI, -PI / 2, -PI, 0],
    [100, 100, np.inf, 2, 2, PI, PI / 2, 0, 3 * PI / 2],
])
_DEFAULT_DULIM = np.array([
    [-np.inf, -np.inf, -0.5, -0.5, -0.5],
    [np.inf, np.inf, 0.5, 0.5, 0.5],
])


class MPCWholeBody(ControllerBase):
    NX, NU = 9, 5

    def __init__(self, robot, obstacle_list, obstacle_manipulation_list,
                 N=10, Q=_DEFAULT_Q, P=_DEFAULT_Q, R=_DEFAULT_R,
                 S=_DEFAULT_S, W=_DEFAULT_W,
                 ulim=_DEFAULT_ULIM, xlim=_DEFAULT_XLIM, dulim=_DEFAULT_DULIM,
                 solver_config: SolverConfig | None = None,
                 replicate_terminal_selfcol_bug: bool = True,
                 n_hp_pad: int | None = None,
                 moving_obstacles: bool = False):
        self.robot_model = robot
        self.dt = robot.dt
        self.base_radius = robot.base.base_radius()
        self.f_dynamics = robot.f_kinematics
        self.moving_obstacles = moving_obstacles
        self.replicate_terminal_selfcol_bug = replicate_terminal_selfcol_bug

        # runtime weight state (reference setWeight mechanism)
        self.Q_value = as_weight_matrix(Q, self.NX)
        self.P_value = as_weight_matrix(P, self.NX)
        self.R_value = as_weight_matrix(R, self.NU)
        self.W_value = as_weight_matrix(W, self.NU)
        self.S_value = scalar_weight(S)

        self.ulim = np.asarray(ulim, dtype=float)
        self.xlim = np.asarray(xlim, dtype=float)
        self.dulim = np.asarray(dulim, dtype=float)

        # obstacle data (runtime arrays, static shapes)
        self.obstacle_list = obstacle_list
        self.obstacle_manipulation_list = obstacle_manipulation_list
        obs = ground_obstacle_array(obstacle_list)
        self.n_obs = obs.shape[0]
        self.obstacles_value = jnp.asarray(obs)
        n_hp = max(len(obstacle_manipulation_list), 1)
        self.n_hp = n_hp_pad or n_hp
        pts = np.zeros((self.n_hp, 3))
        nrm = np.zeros((self.n_hp, 3))
        msk = np.zeros((self.n_hp,))
        for j, (p, nvec) in enumerate(obstacle_manipulation_list):
            pts[j] = np.asarray(p, dtype=float).reshape(3)
            nrm[j] = np.asarray(nvec, dtype=float).reshape(3)
            msk[j] = 1.0
        self.hp_points_value = jnp.asarray(pts)
        self.hp_normals_value = jnp.asarray(nrm)
        self.hp_mask_value = jnp.asarray(msk)

        # FSM-injected terminal position equality, off by default
        self.terminal_eq_mask = jnp.asarray(0.0)

        self._x_lo, self._x_hi, self._x_mlo, self._x_mhi = \
            finite_bound_masks(self.xlim)
        self._du_lo, self._du_hi, self._du_mlo, self._du_mhi = \
            finite_bound_masks(self.dulim)

        ocp = self._build_ocp(N)
        super().__init__(ocp, solver_config or SolverConfig())
        self.reset()

    # ------------------------------------------------------------------
    def _build_ocp(self, N):
        dt = self.dt
        bug_compat = self.replicate_terminal_selfcol_bug
        base_radius = self.base_radius
        moving = self.moving_obstacles

        def dynamics(x, u):
            return wholebody_step(x, u, dt)

        def slack_group(x, params, k):
            obs = params["obstacles"][k] if moving else params["obstacles"]
            pose_ee, j2, j3 = wholebody_fk(x)
            ee = pose_ee[:3]
            g_ground = ground_circle_g(x[0], x[1], obs, base_radius)
            pts = manipulator_sample_points(ee, j2, j3)
            g_hp = halfplane_union_g(pts, params["hp_points"],
                                     params["hp_normals"], params["hp_mask"])
            g_self = self_collision_g(ee, j2, j3)
            return jnp.concatenate([g_ground, g_self, g_hp])

        def terminal_selfcol(x):
            pose_ee, j2, j3 = wholebody_fk(x)
            return self_collision_g(pose_ee[:3], j2, j3)

        def stage_slack_g(x, u, k, p):
            g = slack_group(x, p, k)
            if bug_compat:
                # terminal self-collision rides stage N-1's slack (reference
                # mpc_wholebody_qref.py:263-265 uses the stale loop index)
                g_term = terminal_selfcol(dynamics(x, u))
                g_term = jnp.where(k == N - 1, g_term, _NEG_BIG)
                g = jnp.concatenate([g, g_term])
            return g

        def terminal_slack_g(x, p):
            obs = p["obstacles"][N] if moving else p["obstacles"]
            pose_ee, j2, j3 = wholebody_fk(x)
            ee = pose_ee[:3]
            g_ground = ground_circle_g(x[0], x[1], obs, base_radius)
            pts = manipulator_sample_points(ee, j2, j3)
            g_hp = halfplane_union_g(pts, p["hp_points"], p["hp_normals"],
                                     p["hp_mask"])
            parts = [g_ground, g_hp]
            if not bug_compat:
                parts.append(self_collision_g(ee, j2, j3))
            return jnp.concatenate(parts)

        def stage_cost(x, u, k, p):
            ex = x - p["X_ref"][k]
            eu = u - p["U_ref"][k]
            edu = u - p["U_last"][k]
            cost = ex @ p["Q"] @ ex + eu @ p["R"] @ eu + edu @ p["W"] @ edu
            return cost + relu_max_penalty(stage_slack_g(x, u, k, p), p["S"])

        def terminal_cost(x, p):
            ex = x - p["X_ref"][N]
            return (ex @ p["P"] @ ex
                    + relu_max_penalty(terminal_slack_g(x, p), p["S"]))

        def stage_residuals(x, u, k, p):
            """Sum-of-squares factorization of stage_cost (Gauss-Newton
            path): cost == ||residuals||^2 exactly."""
            ex = x - p["X_ref"][k]
            eu = u - p["U_ref"][k]
            edu = u - p["U_last"][k]
            smax = relu_max(stage_slack_g(x, u, k, p))
            return jnp.concatenate([
                p["Q_s"] @ ex, p["R_s"] @ eu, p["W_s"] @ edu,
                (p["S_sqrt"] * smax)[None],
            ])

        def terminal_residuals(x, p):
            ex = x - p["X_ref"][N]
            smax = relu_max(terminal_slack_g(x, p))
            return jnp.concatenate([p["P_s"] @ ex,
                                    (p["S_sqrt"] * smax)[None]])

        x_lo, x_hi, x_mlo, x_mhi = (self._x_lo, self._x_hi,
                                    self._x_mlo, self._x_mhi)
        du_lo, du_hi, du_mlo, du_mhi = (self._du_lo, self._du_hi,
                                        self._du_mlo, self._du_mhi)

        def stage_ineq(x, u, k, p):
            gx = box_g(x, x_lo, x_hi, x_mlo, x_mhi)
            gdu = box_g(u - p["U_last"][k], du_lo, du_hi, du_mlo, du_mhi)
            return jnp.concatenate([gx, gdu])

        def terminal_ineq(x, p):
            return box_g(x, x_lo, x_hi, x_mlo, x_mhi)

        def terminal_eq(x, p):
            return p["eq_mask"] * (x[:2] - p["X_ref"][N, :2])

        # ---- hand-assembled Jacobians (the solver's fastest path) ----
        # Box-constraint Jacobians are constant +-selection rows; only the
        # slack residual row is nonlinear (one reverse-mode pass per stage).
        nxl, nul = self.NX, self.NU
        Jc_np = np.zeros((2 * nxl + 2 * nul, nxl + nul))
        for i in range(nxl):
            if np.asarray(x_mhi)[i]:
                Jc_np[i, i] = 1.0
            if np.asarray(x_mlo)[i]:
                Jc_np[nxl + i, i] = -1.0
        for i in range(nul):
            if np.asarray(du_mhi)[i]:
                Jc_np[2 * nxl + i, nxl + i] = 1.0
            if np.asarray(du_mlo)[i]:
                Jc_np[2 * nxl + nul + i, nxl + i] = -1.0
        Jc_const = jnp.asarray(Jc_np)
        Jct_np = np.zeros((2 * nxl, nxl))
        Jct_np[:, :] = Jc_np[: 2 * nxl, :nxl]
        Jct_const = jnp.asarray(Jct_np)
        Jeq_np = np.zeros((2, nxl))
        Jeq_np[0, 0] = 1.0
        Jeq_np[1, 1] = 1.0
        Jeq_const = jnp.asarray(Jeq_np)

        import jax as _jax

        def stage_gn(x, u, k, p):
            ex = x - p["X_ref"][k]
            eu = u - p["U_ref"][k]
            edu = u - p["U_last"][k]
            z = jnp.concatenate([x, u])
            smax, sgrad = _jax.value_and_grad(
                lambda zz: relu_max(
                    stage_slack_g(zz[:nxl], zz[nxl:], k, p)))(z)
            zero95 = jnp.zeros((nxl, nul), x.dtype)
            zero59 = jnp.zeros((nul, nxl), x.dtype)
            r = jnp.concatenate([p["Q_s"] @ ex, p["R_s"] @ eu,
                                 p["W_s"] @ edu, (p["S_sqrt"] * smax)[None]])
            J = jnp.concatenate([
                jnp.concatenate([p["Q_s"], zero95], axis=1),
                jnp.concatenate([zero59, p["R_s"]], axis=1),
                jnp.concatenate([zero59, p["W_s"]], axis=1),
                (p["S_sqrt"] * sgrad)[None, :],
            ], axis=0)
            return r, J

        def terminal_gn(x, p):
            ex = x - p["X_ref"][N]
            smax, sgrad = _jax.value_and_grad(
                lambda xx: relu_max(terminal_slack_g(xx, p)))(x)
            r = jnp.concatenate([p["P_s"] @ ex, (p["S_sqrt"] * smax)[None]])
            J = jnp.concatenate([p["P_s"], (p["S_sqrt"] * sgrad)[None, :]],
                                axis=0)
            return r, J

        def stage_ineq_jac(x, u, k, p):
            return stage_ineq(x, u, k, p), Jc_const.astype(x.dtype)

        def terminal_ineq_jac(x, p):
            return terminal_ineq(x, p), Jct_const.astype(x.dtype)

        def terminal_eq_jac(x, p):
            return (terminal_eq(x, p),
                    p["eq_mask"] * Jeq_const.astype(x.dtype))

        def dynamics_jacobians(x, u):
            return wholebody_jacobians(x, u, dt)

        # ---- fully-structured AL expansion (no Jacobian materialized) ----
        # Row layout of stage_ineq: [x_hi(9), x_lo(9), du_hi(5), du_lo(5)];
        # of terminal_ineq: [x_hi(9), x_lo(9)].  Box rows are +-unit vectors,
        # so their AL contributions are pure diagonal/vector updates; the
        # tracking JtJ blocks are the weight matrices themselves; only the
        # slack row contributes a rank-1 outer product (its gradient is the
        # single reverse-mode pass through the FK).
        def stage_al_expansion(x, u, k, p, lam_k, mu, inv_scale):
            ex = x - p["X_ref"][k]
            eu = u - p["U_ref"][k]
            edu = u - p["U_last"][k]
            z = jnp.concatenate([x, u])
            smax, sgrad = _jax.value_and_grad(
                lambda zz: relu_max(
                    stage_slack_g(zz[:nxl], zz[nxl:], k, p)))(z)
            sx, su = sgrad[:nxl], sgrad[nxl:]
            S = p["S"]
            two_s = 2.0 * inv_scale
            gx = two_s * (p["Q"] @ ex + S * smax * sx)
            gu = two_s * (p["R"] @ eu + p["W"] @ edu + S * smax * su)
            Hxx = two_s * (p["Q"] + S * jnp.outer(sx, sx))
            Huu = two_s * (p["R"] + p["W"] + S * jnp.outer(su, su))
            Hux = two_s * (S * jnp.outer(su, sx))

            c = stage_ineq(x, u, k, p)
            t = jnp.maximum(0.0, lam_k + mu * c)
            act = ((lam_k + mu * c) > 0).astype(x.dtype)
            gx = gx + t[:nxl] - t[nxl:2 * nxl]
            gu = gu + t[2 * nxl:2 * nxl + nul] - t[2 * nxl + nul:]
            Hxx = Hxx + jnp.diag(mu * (act[:nxl] + act[nxl:2 * nxl]))
            Huu = Huu + jnp.diag(
                mu * (act[2 * nxl:2 * nxl + nul] + act[2 * nxl + nul:]))
            return gx, gu, Hxx, Huu, Hux

        def terminal_al_expansion(x, p, lam_t, lam_e, mu, inv_scale):
            ex = x - p["X_ref"][N]
            smax, sx = _jax.value_and_grad(
                lambda xx: relu_max(terminal_slack_g(xx, p)))(x)
            S = p["S"]
            two_s = 2.0 * inv_scale
            gx = two_s * (p["P"] @ ex + S * smax * sx)
            Hxx = two_s * (p["P"] + S * jnp.outer(sx, sx))

            c = terminal_ineq(x, p)
            t = jnp.maximum(0.0, lam_t + mu * c)
            act = ((lam_t + mu * c) > 0).astype(x.dtype)
            gx = gx + t[:nxl] - t[nxl:]
            Hxx = Hxx + jnp.diag(mu * (act[:nxl] + act[nxl:]))

            # maskable terminal position equality: h = m*(x[:2]-ref)
            m = p["eq_mask"]
            h = terminal_eq(x, p)
            geq = m * (lam_e + mu * h)                     # (2,)
            gx = gx.at[:2].add(geq)
            Hxx = Hxx.at[0, 0].add(mu * m * m).at[1, 1].add(mu * m * m)
            return gx, Hxx

        # ---- fused forward line-search kernel (ops/wholebody_fwd.py) ----
        xb = tuple(np.asarray(b) for b in (self._x_lo, self._x_hi,
                                           self._x_mlo, self._x_mhi))
        dub = tuple(np.asarray(b) for b in (self._du_lo, self._du_hi,
                                            self._du_mlo, self._du_mhi))
        ulim_np = self.ulim
        n_obs, n_hp = self.n_obs, self.n_hp

        def lanes_fwd_factory(cfg, interpret=False):
            from mmmpc_tpu.ops.wholebody_fwd import make_fwd_linesearch
            return make_fwd_linesearch(
                nx=self.NX, nu=self.NU, N=N, dt=dt,
                base_radius=base_radius, n_obs=n_obs, n_hp=n_hp,
                x_bounds=xb, du_bounds=dub, u_clamp=(ulim_np[0], ulim_np[1]),
                alphas=[cfg.alpha_decay ** i for i in range(cfg.n_alpha)],
                inv_scale=1.0 / cfg.cost_scale, bug_compat=bug_compat,
                moving=moving, interpret=interpret)

        return OCP(
            nx=self.NX, nu=self.NU, N=N, dynamics=dynamics,
            lanes_fwd_factory=lanes_fwd_factory,
            lanes_per_scenario_keys=frozenset(
                {"U_last", "X_ref", "U_ref", "Q", "P", "eq_mask"}),
            stage_cost=stage_cost, terminal_cost=terminal_cost,
            stage_ineq=stage_ineq, terminal_ineq=terminal_ineq,
            terminal_eq=terminal_eq,
            u_lower=jnp.asarray(self.ulim[0]),
            u_upper=jnp.asarray(self.ulim[1]),
            stage_residuals=stage_residuals,
            terminal_residuals=terminal_residuals,
            stage_gn=stage_gn, terminal_gn=terminal_gn,
            stage_ineq_jac=stage_ineq_jac,
            terminal_ineq_jac=terminal_ineq_jac,
            terminal_eq_jac=terminal_eq_jac,
            dynamics_jacobians=dynamics_jacobians,
            stage_al_expansion=stage_al_expansion,
            terminal_al_expansion=terminal_al_expansion)

    # ------------------------------------------------------------------
    def reset(self):
        """Clear warm-start state (the reference rebuilds its Opti here; our
        compiled program is parameterized, so nothing to rebuild)."""
        self.reset_warmstart()
        self.x_guess = None

    def setWeight(self, Q=None, R=None, P=None, S=None, W=None):
        """Runtime weight mutation (reference mpc_wholebody_qref.py:119-139)."""
        if Q is not None:
            self.Q_value = as_weight_matrix(Q, self.NX)
        if R is not None:
            self.R_value = as_weight_matrix(R, self.NU)
        if P is not None:
            self.P_value = as_weight_matrix(P, self.NX)
        if S is not None:
            self.S_value = scalar_weight(S)
        if W is not None:
            self.W_value = as_weight_matrix(W, self.NU)

    def add_terminal_position_constraint(self):
        """Enable the FSM-injected hard terminal equality
        X[N, :2] == X_ref[N, :2] (reference interface:167) — a runtime mask
        flip, no recompilation."""
        self.terminal_eq_mask = jnp.asarray(1.0)

    def set_obstacles(self, obstacles):
        """Update ground-obstacle positions (same count) at runtime."""
        self.obstacles_value = jnp.asarray(obstacles)

    def make_params(self, traj_ref, u_ref):
        return {
            "X_ref": jnp.asarray(traj_ref),
            "U_ref": jnp.asarray(u_ref),
            "Q": self.Q_value, "R": self.R_value, "P": self.P_value,
            "S": self.S_value, "W": self.W_value,
            "Q_s": weight_sqrt(self.Q_value),
            "R_s": weight_sqrt(self.R_value),
            "P_s": weight_sqrt(self.P_value),
            "W_s": weight_sqrt(self.W_value),
            "S_sqrt": jnp.sqrt(self.S_value),
            "obstacles": self.obstacles_value,
            "hp_points": self.hp_points_value,
            "hp_normals": self.hp_normals_value,
            "hp_mask": self.hp_mask_value,
            "eq_mask": self.terminal_eq_mask,
        }

    def solve(self, x_init, traj_ref, u_ref):
        """One receding-horizon solve; returns u[0] as a numpy (5,) array."""
        x_init = np.asarray(x_init, dtype=float).copy()
        # clamp infeasible sensor feedback into bounds (reference solve:290-292)
        x_init = np.clip(x_init, self.xlim[0], self.xlim[1])
        assert x_init[7] <= 0 and x_init[8] >= 0
        return self._solve_impl(x_init, self.make_params(traj_ref, u_ref))

    def angleDiff(self, a, b):
        from mmmpc_tpu.utils.math import angle_diff
        return angle_diff(a, b)
