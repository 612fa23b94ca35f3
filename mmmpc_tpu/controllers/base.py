"""Diff-drive base point-tracking MPC with ground-obstacle avoidance.

Reference: /root/reference/controllers/mpc_base.py.  Peculiarities kept:
- the yaw tracking error uses the wrap-aware angle difference in the cost
  (mpc_base.py:146-150),
- the 5-wide xlim is applied as boxes on (x, y) and on (dx, dy, dpsi) — the
  yaw itself is unbounded (mpc_base.py:16,155-156),
- obstacle circles use the shared per-step slack with weight M, i.e. the
  exact penalty M * relu(max g)^2 here,
- warm-started U, no U_last / input-rate term in this controller.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from mmmpc_tpu.controllers.common import (
    ControllerBase, as_weight_matrix, scalar_weight, weight_sqrt,
)
from mmmpc_tpu.models.base import base_step
from mmmpc_tpu.models.obstacles import ground_obstacle_array
from mmmpc_tpu.ocp import OCP
from mmmpc_tpu.ocp.constraints import ground_circle_g, relu_max, relu_max_penalty
from mmmpc_tpu.utils.configs import SolverConfig
from mmmpc_tpu.utils.math import angle_diff

PI = math.pi


class MPCBase(ControllerBase):
    NX, NU = 6, 2

    def __init__(self, robot, obstacle_list, N=10,
                 Q=np.diag([5.0, 5.0, 0.0, 0, 0, 1.0]),
                 P=np.diag([5.0, 5.0, 0.0, 0, 0, 1.0]),
                 R=np.diag([1.0, 1.0]),
                 M=np.diag([1e5]),
                 ulim=np.array([[-2, -PI], [2, PI]]),
                 xlim=np.array([[-100, -100, -2, -2, -PI],
                                [100, 100, 2, 2, PI]]),
                 solver_config: SolverConfig | None = None):
        self.dt = robot.dt
        self.base_radius = robot.base_radius()
        self.obstacle_list = obstacle_list
        self.Q_value = as_weight_matrix(Q, self.NX)
        self.P_value = as_weight_matrix(P, self.NX)
        self.R_value = as_weight_matrix(R, self.NU)
        self.M_value = scalar_weight(M)
        self.ulim = np.asarray(ulim, dtype=float)
        self.xlim = np.asarray(xlim, dtype=float)
        obs = ground_obstacle_array(obstacle_list)
        self.obstacles_value = jnp.asarray(obs)
        base_radius = self.base_radius
        dt = self.dt
        xlim_j = jnp.asarray(self.xlim)

        def dynamics(x, u):
            return base_step(x, u, dt)

        def state_error(x, x_ref):
            return jnp.concatenate([
                x[:2] - x_ref[:2],
                angle_diff(x[2], x_ref[2])[None],
                x[3:] - x_ref[3:],
            ])

        def slack_pen(x, p):
            g = ground_circle_g(x[0], x[1], p["obstacles"], base_radius)
            return relu_max_penalty(g, p["M"])

        def stage_cost(x, u, k, p):
            e = state_error(x, p["X_ref"][k])
            eu = u - p["U_ref"][k]
            return e @ p["Q"] @ e + eu @ p["R"] @ eu + slack_pen(x, p)

        def terminal_cost(x, p):
            e = state_error(x, p["X_ref"][N])
            return e @ p["P"] @ e + slack_pen(x, p)

        def box6(x):
            # xlim columns: [x, y, (dx, dy, dpsi)] — yaw unbounded
            v = jnp.concatenate([x[:2], x[3:]])
            lim = xlim_j.astype(v.dtype)   # dtype-preserving (f32 hot path)
            return jnp.concatenate([v - lim[1], lim[0] - v])

        def stage_ineq(x, u, k, p):
            return box6(x)

        def terminal_ineq(x, p):
            return box6(x)

        def slack_res(x, p):
            g = ground_circle_g(x[0], x[1], p["obstacles"], base_radius)
            smax = relu_max(g)
            return (p["M_sqrt"] * smax)[None]

        def stage_residuals(x, u, k, p):
            e = state_error(x, p["X_ref"][k])
            eu = u - p["U_ref"][k]
            return jnp.concatenate(
                [p["Q_s"] @ e, p["R_s"] @ eu, slack_res(x, p)])

        def terminal_residuals(x, p):
            e = state_error(x, p["X_ref"][N])
            return jnp.concatenate([p["P_s"] @ e, slack_res(x, p)])

        # ---- fully-structured AL expansion (solver's fastest generic
        # path): tracking JtJ is the weight matrix itself (the wrap-aware
        # yaw error has unit slope a.e.), the slack group contributes one
        # rank-1 outer product from a single reverse-mode pass, and the box
        # rows are pure diagonal updates.  Mirrors the flagship qref
        # expansion (wholebody_qref.py).
        import jax as _jax

        _box_idx = jnp.asarray([0, 1, 3, 4, 5])

        def _slack_vg(x, p):
            return _jax.value_and_grad(lambda xx: relu_max(ground_circle_g(
                xx[0], xx[1], p["obstacles"], base_radius)))(x)

        def stage_al_expansion(x, u, k, p, lam_k, mu, inv_scale):
            e = state_error(x, p["X_ref"][k])
            eu = u - p["U_ref"][k]
            smax, sx = _slack_vg(x, p)
            M = p["M"]
            two_s = 2.0 * inv_scale
            gx = two_s * (p["Q"] @ e + M * smax * sx)
            gu = two_s * (p["R"] @ eu)
            Hxx = two_s * (p["Q"] + M * jnp.outer(sx, sx))
            Huu = two_s * p["R"]
            Hux = jnp.zeros((2, 6), x.dtype)

            c = box6(x)                      # rows [v - hi (5), lo - v (5)]
            t = jnp.maximum(0.0, lam_k + mu * c)
            act = ((lam_k + mu * c) > 0).astype(x.dtype)
            gx = gx.at[_box_idx].add(t[:5] - t[5:])
            Hxx = Hxx.at[_box_idx, _box_idx].add(mu * (act[:5] + act[5:]))
            return gx, gu, Hxx, Huu, Hux

        def terminal_al_expansion(x, p, lam_t, lam_e, mu, inv_scale):
            e = state_error(x, p["X_ref"][N])
            smax, sx = _slack_vg(x, p)
            M = p["M"]
            two_s = 2.0 * inv_scale
            gx = two_s * (p["P"] @ e + M * smax * sx)
            Hxx = two_s * (p["P"] + M * jnp.outer(sx, sx))
            t = jnp.maximum(0.0, lam_t + mu * box6(x))
            act = (t > 0).astype(x.dtype)
            gx = gx.at[_box_idx].add(t[:5] - t[5:])
            Hxx = Hxx.at[_box_idx, _box_idx].add(mu * (act[:5] + act[5:]))
            return gx, Hxx

        def dynamics_jacobians(x, u):
            from mmmpc_tpu.models.base import base_jacobians
            return base_jacobians(x, u, dt)

        ocp = OCP(nx=self.NX, nu=self.NU, N=N, dynamics=dynamics,
                  stage_cost=stage_cost, terminal_cost=terminal_cost,
                  stage_ineq=stage_ineq, terminal_ineq=terminal_ineq,
                  u_lower=jnp.asarray(self.ulim[0]),
                  u_upper=jnp.asarray(self.ulim[1]),
                  stage_residuals=stage_residuals,
                  terminal_residuals=terminal_residuals,
                  dynamics_jacobians=dynamics_jacobians,
                  stage_al_expansion=stage_al_expansion,
                  terminal_al_expansion=terminal_al_expansion)
        super().__init__(ocp, solver_config or SolverConfig())
        self.reset()

    def reset(self):
        self.reset_warmstart()

    def setWeight(self, Q=None, R=None, P=None, M=None):
        if Q is not None:
            self.Q_value = as_weight_matrix(Q, self.NX)
        if R is not None:
            self.R_value = as_weight_matrix(R, self.NU)
        if P is not None:
            self.P_value = as_weight_matrix(P, self.NX)
        if M is not None:
            self.M_value = scalar_weight(M)

    def angleDiff(self, a, b):
        return angle_diff(a, b)

    def make_params(self, traj_ref, u_ref):
        return {"X_ref": jnp.asarray(traj_ref), "U_ref": jnp.asarray(u_ref),
                "Q": self.Q_value, "R": self.R_value, "P": self.P_value,
                "M": self.M_value, "obstacles": self.obstacles_value,
                "Q_s": weight_sqrt(self.Q_value),
                "R_s": weight_sqrt(self.R_value),
                "P_s": weight_sqrt(self.P_value),
                "M_sqrt": jnp.sqrt(self.M_value)}

    def solve(self, x_init, traj_ref, u_ref):
        return self._solve_impl(np.asarray(x_init, dtype=float),
                                self.make_params(traj_ref, u_ref))
