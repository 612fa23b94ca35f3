"""Whole-body MPC tracking a Cartesian end-point pose reference.

Reference: /root/reference/controllers/mpc_wholebody.py — same 9-state /
5-input model as the qref controller but the tracking error is the world
end-effector pose [x, y, z, psi] against a (N+1, 4) reference
(mpc_wholebody.py:66,79-80).  Ground obstacles with slack only (3-D
manipulator obstacles were a TODO in the reference; same here by fidelity),
input-rate cost/limits, and the tighter arm bounds q2 in [-3pi/4, 0],
q3 in [0, pi] (mpc_wholebody.py:18-20).
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from mmmpc_tpu.controllers.common import (
    ControllerBase, as_weight_matrix, finite_bound_masks, scalar_weight,
    weight_sqrt,
)
from mmmpc_tpu.models.mobile_manipulator import (
    wholebody_fk, wholebody_pose_jacobian, wholebody_step,
)
from mmmpc_tpu.models.obstacles import ground_obstacle_array
from mmmpc_tpu.ocp import OCP
from mmmpc_tpu.ocp.constraints import box_g, ground_circle_g, relu_max, relu_max_penalty
from mmmpc_tpu.utils.configs import SolverConfig

PI = math.pi

_DEFAULT_XLIM = np.array([
    [-100, -100, -np.inf, -2, -2, -PI, -PI / 2, -PI * 3 / 4, 0],
    [100, 100, np.inf, 2, 2, PI, PI / 2, 0, PI],
])


class MPCWholeBodyEndpoint(ControllerBase):
    NX, NU = 9, 5

    def __init__(self, robot, obstacle_list, N=10,
                 Q=5 * np.diag([1, 1, 1, 1.0]),
                 P=50 * np.diag([1, 1, 1, 1.0]),
                 R=np.diag([0.1, 0.1, 0.0, 0.0, 0.0]),
                 S=np.diag([1e5]),
                 W=np.diag([0, 0, 1e-1, 1e-1, 1e-1]),
                 ulim=np.array([[-2, -PI, -1, -1, -1], [2, PI, 1, 1, 1.0]]),
                 xlim=_DEFAULT_XLIM,
                 dulim=np.array([[-np.inf, -np.inf, -0.5, -0.5, -0.5],
                                 [np.inf, np.inf, 0.5, 0.5, 0.5]]),
                 solver_config: SolverConfig | None = None):
        self.robot_model = robot
        self.dt = robot.dt
        self.base_radius = robot.base.base_radius()
        self.obstacle_list = obstacle_list
        self.Q_value = as_weight_matrix(Q, 4)
        self.P_value = as_weight_matrix(P, 4)
        self.R_value = as_weight_matrix(R, self.NU)
        self.W_value = as_weight_matrix(W, self.NU)
        self.S_value = scalar_weight(S)
        self.ulim = np.asarray(ulim, dtype=float)
        self.xlim = np.asarray(xlim, dtype=float)
        self.dulim = np.asarray(dulim, dtype=float)
        self.obstacles_value = jnp.asarray(ground_obstacle_array(obstacle_list))
        base_radius = self.base_radius
        dt = self.dt
        x_lo, x_hi, x_mlo, x_mhi = finite_bound_masks(self.xlim)
        du_lo, du_hi, du_mlo, du_mhi = finite_bound_masks(self.dulim)

        def dynamics(x, u):
            return wholebody_step(x, u, dt)

        def slack_pen(x, p):
            g = ground_circle_g(x[0], x[1], p["obstacles"], base_radius)
            return relu_max_penalty(g, p["S"])

        def stage_cost(x, u, k, p):
            pose_ee, _, _ = wholebody_fk(x)
            e = pose_ee - p["X_ref"][k]
            eu = u - p["U_ref"][k]
            edu = u - p["U_last"][k]
            return (e @ p["Q"] @ e + eu @ p["R"] @ eu + edu @ p["W"] @ edu
                    + slack_pen(x, p))

        def terminal_cost(x, p):
            pose_ee, _, _ = wholebody_fk(x)
            e = pose_ee - p["X_ref"][N]
            return e @ p["P"] @ e + slack_pen(x, p)

        def stage_ineq(x, u, k, p):
            gx = box_g(x, x_lo, x_hi, x_mlo, x_mhi)
            gdu = box_g(u - p["U_last"][k], du_lo, du_hi, du_mlo, du_mhi)
            return jnp.concatenate([gx, gdu])

        def terminal_ineq(x, p):
            return box_g(x, x_lo, x_hi, x_mlo, x_mhi)

        def slack_res(x, p):
            g = ground_circle_g(x[0], x[1], p["obstacles"], base_radius)
            smax = relu_max(g)
            return (p["S_sqrt"] * smax)[None]

        def stage_residuals(x, u, k, p):
            pose_ee, _, _ = wholebody_fk(x)
            e = pose_ee - p["X_ref"][k]
            eu = u - p["U_ref"][k]
            edu = u - p["U_last"][k]
            return jnp.concatenate([p["Q_s"] @ e, p["R_s"] @ eu,
                                    p["W_s"] @ edu, slack_res(x, p)])

        def terminal_residuals(x, p):
            pose_ee, _, _ = wholebody_fk(x)
            e = pose_ee - p["X_ref"][N]
            return jnp.concatenate([p["P_s"] @ e, slack_res(x, p)])

        # ---- fully-structured AL expansion (see wholebody_qref.py): the
        # end-point pose tracking runs one forward FK Jacobian (4x9) per
        # stage — its Gauss-Newton block is Jp^T Q Jp — the ground-obstacle
        # slack is a rank-1 term, and all hard rows are boxes (pure diagonal
        # updates; masked rows self-deactivate through the PHR max).
        import jax as _jax

        nxl, nul = self.NX, self.NU
        _pose = lambda x: wholebody_fk(x)[0]                  # noqa: E731

        def _slack_vg(x, p):
            return _jax.value_and_grad(lambda xx: relu_max(ground_circle_g(
                xx[0], xx[1], p["obstacles"], base_radius)))(x)

        def stage_al_expansion(x, u, k, p, lam_k, mu, inv_scale):
            e = _pose(x) - p["X_ref"][k]
            Jp = wholebody_pose_jacobian(x)                   # (4, 9)
            eu = u - p["U_ref"][k]
            edu = u - p["U_last"][k]
            smax, sx = _slack_vg(x, p)
            S = p["S"]
            two_s = 2.0 * inv_scale
            gx = two_s * (Jp.T @ (p["Q"] @ e) + S * smax * sx)
            gu = two_s * (p["R"] @ eu + p["W"] @ edu)
            Hxx = two_s * (Jp.T @ p["Q"] @ Jp + S * jnp.outer(sx, sx))
            Huu = two_s * (p["R"] + p["W"])
            Hux = jnp.zeros((nul, nxl), x.dtype)

            # rows: [x_hi(9), x_lo(9), du_hi(5), du_lo(5)]
            c = stage_ineq(x, u, k, p)
            t = jnp.maximum(0.0, lam_k + mu * c)
            act = (t > 0).astype(x.dtype)
            gx = gx + (t[:nxl] - t[nxl:2 * nxl])
            gu = gu + (t[2 * nxl:2 * nxl + nul] - t[2 * nxl + nul:])
            Hxx = Hxx + jnp.diag(mu * (act[:nxl] + act[nxl:2 * nxl]))
            Huu = Huu + jnp.diag(
                mu * (act[2 * nxl:2 * nxl + nul] + act[2 * nxl + nul:]))
            return gx, gu, Hxx, Huu, Hux

        def terminal_al_expansion(x, p, lam_t, lam_e, mu, inv_scale):
            e = _pose(x) - p["X_ref"][N]
            Jp = wholebody_pose_jacobian(x)
            smax, sx = _slack_vg(x, p)
            S = p["S"]
            two_s = 2.0 * inv_scale
            gx = two_s * (Jp.T @ (p["P"] @ e) + S * smax * sx)
            Hxx = two_s * (Jp.T @ p["P"] @ Jp + S * jnp.outer(sx, sx))
            t = jnp.maximum(0.0, lam_t + mu * terminal_ineq(x, p))
            act = (t > 0).astype(x.dtype)
            gx = gx + (t[:nxl] - t[nxl:])
            Hxx = Hxx + jnp.diag(mu * (act[:nxl] + act[nxl:]))
            return gx, Hxx

        def dynamics_jacobians(x, u):
            from mmmpc_tpu.models.mobile_manipulator import (
                wholebody_jacobians,
            )
            return wholebody_jacobians(x, u, dt)

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

    def make_params(self, traj_ref, u_ref):
        return {"X_ref": jnp.asarray(traj_ref), "U_ref": jnp.asarray(u_ref),
                "Q": self.Q_value, "R": self.R_value, "P": self.P_value,
                "S": self.S_value, "W": self.W_value,
                "Q_s": weight_sqrt(self.Q_value),
                "R_s": weight_sqrt(self.R_value),
                "P_s": weight_sqrt(self.P_value),
                "W_s": weight_sqrt(self.W_value),
                "S_sqrt": jnp.sqrt(self.S_value),
                "obstacles": self.obstacles_value}

    def solve(self, x_init, traj_ref, u_ref):
        x_init = np.asarray(x_init, dtype=float).copy()
        x_init = np.clip(x_init, self.xlim[0], self.xlim[1])
        assert x_init[7] <= 0 and x_init[8] >= 0
        return self._solve_impl(x_init, self.make_params(traj_ref, u_ref))
