"""3-DoF arm joint-space MPC with self-collision and convex obstacles.

Reference: /root/reference/controllers/mpc_manipulator_3DoF.py.
Peculiarities kept:
- self-collision spheres are HARD constraints here (no slack;
  mpc_manipulator_3DoF.py:86-89) — they go to the AL inequality block,
- the convex (half-plane union) obstacle uses its own per-stage slack with
  module weight 1e6 (mpc_manipulator_3DoF.py:5,91-93) — folded as
  1e6 * relu(max_i -maxc_i)^2,
- no obstacle expansion margin in this controller (unlike the whole-body
  one), positions are in the ARM frame,
- M here is the input-rate (control change) weight, not a slack weight,
- optional Cartesian reference (is_cartesian_ref) tracks the end-point
  position instead of joint angles.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from mmmpc_tpu.controllers.common import (
    ControllerBase, as_weight_matrix, weight_sqrt,
)
from mmmpc_tpu.models.arm import arm_fk, arm_step, ee_jacobian
from mmmpc_tpu.ocp import OCP
from mmmpc_tpu.ocp.constraints import (
    halfplane_union_g, manipulator_sample_points, relu_max,
    relu_max_penalty, self_collision_g,
)
from mmmpc_tpu.utils.configs import SolverConfig

PI = math.pi
SLACK_WEIGHT = 1e6   # reference WEIGHT (mpc_manipulator_3DoF.py:5)


class MPCManipulator3DoF(ControllerBase):
    NX, NU = 3, 3

    def __init__(self, robot, obstacle_surfaces_manipulation,
                 obstacle_point_manipulation, N=10,
                 Q=np.diag([1, 1.0, 1]), P=np.diag([1, 1.0, 1]),
                 R=np.diag([0.1, 0.1, 0.1]),
                 M=np.diag([1e-2, 1e-2, 1e-2]),
                 qlim=(np.array([-PI / 2, -PI, 0]), np.array([PI / 2, 0, PI])),
                 dqlim=(np.array([-1, -1, -1.0]), np.array([1, 1, 1.0])),
                 ddqlim=(np.array([-0.5] * 3), np.array([0.5] * 3)),
                 is_cartesian_ref: bool = False,
                 solver_config: SolverConfig | None = None):
        self.robot_model = robot
        self.dt = robot.dt
        self.qlim = (np.asarray(qlim[0], dtype=float).reshape(-1),
                     np.asarray(qlim[1], dtype=float).reshape(-1))
        self.dqlim = (np.asarray(dqlim[0], dtype=float).reshape(-1),
                      np.asarray(dqlim[1], dtype=float).reshape(-1))
        self.ddqlim = (np.asarray(ddqlim[0], dtype=float).reshape(-1),
                       np.asarray(ddqlim[1], dtype=float).reshape(-1))
        self.Q_value = as_weight_matrix(Q, self.NX)
        self.P_value = as_weight_matrix(P, self.NX)
        self.R_value = as_weight_matrix(R, self.NU)
        self.M_value = as_weight_matrix(M, self.NU)
        self.is_cartesian_ref = is_cartesian_ref

        # half-plane obstacle (single union; arm frame, no expansion)
        point = np.asarray(obstacle_point_manipulation, dtype=float)
        self.has_obstacle = point.size > 0
        normals = [np.asarray(n, dtype=float).reshape(3)
                   for n in obstacle_surfaces_manipulation] \
            if self.has_obstacle else []
        n_hp = max(len(normals), 1)
        hp_pts = np.zeros((n_hp, 3))
        hp_nrm = np.zeros((n_hp, 3))
        hp_msk = np.zeros((n_hp,))
        for j, nvec in enumerate(normals):
            hp_pts[j] = point.reshape(3)
            hp_nrm[j] = nvec
            hp_msk[j] = 1.0
        self.hp_points_value = jnp.asarray(hp_pts)
        self.hp_normals_value = jnp.asarray(hp_nrm)
        self.hp_mask_value = jnp.asarray(hp_msk)

        dt = self.dt
        qlo = jnp.asarray(self.qlim[0])
        qhi = jnp.asarray(self.qlim[1])
        ddlo = jnp.asarray(self.ddqlim[0])
        ddhi = jnp.asarray(self.ddqlim[1])
        cartesian = self.is_cartesian_ref

        def dynamics(q, dq):
            return arm_step(q, dq, dt)

        def slack_pen(q, p):
            ee, j2, j3 = arm_fk(q)
            pts = manipulator_sample_points(ee, j2, j3)
            g = halfplane_union_g(pts, p["hp_points"], p["hp_normals"],
                                  p["hp_mask"], expand=0.0)
            return relu_max_penalty(g, SLACK_WEIGHT)

        def state_error(q, ref):
            if cartesian:
                ee, _, _ = arm_fk(q)
                return ee - ref
            return q - ref

        def stage_cost(q, dq, k, p):
            e = state_error(q, p["X_ref"][k])
            eu = dq - p["U_ref"][k]
            edu = dq - p["U_last"][k]
            c = e @ p["Q"] @ e + eu @ p["R"] @ eu + edu @ p["M"] @ edu
            return c + slack_pen(q, p)

        def terminal_cost(q, p):
            e = state_error(q, p["X_ref"][N])
            return e @ p["P"] @ e + slack_pen(q, p)

        def selfcol(q):
            ee, j2, j3 = arm_fk(q)
            # hard: 0.05 - ||p_i - ee|| <= 0 (reference :86-89)
            return self_collision_g(ee, j2, j3)

        def stage_ineq(q, dq, k, p):
            gq = jnp.concatenate([q - qhi.astype(q.dtype),
                                  qlo.astype(q.dtype) - q])
            edu = dq - p["U_last"][k]
            gdd = jnp.concatenate([edu - ddhi.astype(q.dtype),
                                   ddlo.astype(q.dtype) - edu])
            return jnp.concatenate([gq, gdd, selfcol(q)])

        def terminal_ineq(q, p):
            gq = jnp.concatenate([q - qhi.astype(q.dtype),
                                  qlo.astype(q.dtype) - q])
            return jnp.concatenate([gq, selfcol(q)])

        def slack_res(q, p):
            ee, j2, j3 = arm_fk(q)
            pts = manipulator_sample_points(ee, j2, j3)
            g = halfplane_union_g(pts, p["hp_points"], p["hp_normals"],
                                  p["hp_mask"], expand=0.0)
            smax = relu_max(g)
            return (jnp.sqrt(SLACK_WEIGHT) * smax)[None]

        def stage_residuals(q, dq, k, p):
            e = state_error(q, p["X_ref"][k])
            eu = dq - p["U_ref"][k]
            edu = dq - p["U_last"][k]
            return jnp.concatenate([p["Q_s"] @ e, p["R_s"] @ eu,
                                    p["M_s"] @ edu, slack_res(q, p)])

        def terminal_residuals(q, p):
            e = state_error(q, p["X_ref"][N])
            return jnp.concatenate([p["P_s"] @ e, slack_res(q, p)])

        # ---- fully-structured AL expansion (see wholebody_qref.py): the
        # joint-space tracking JtJ is the weight matrix (Cartesian mode runs
        # one forward FK Jacobian instead), the wedge-obstacle slack is a
        # rank-1 term from a single reverse-mode pass, boxes are diagonal
        # updates, and the four hard self-collision rows contribute a small
        # (3x4x3) Gauss-Newton product through their FK Jacobian.
        import jax as _jax

        if cartesian:
            def _track(q, ref):
                e = arm_fk(q)[0] - ref
                return e, ee_jacobian(q)
        else:
            def _track(q, ref):
                return q - ref, jnp.eye(3, dtype=q.dtype)

        def _slack_vg(q, p):
            def f(qq):
                ee, j2, j3 = arm_fk(qq)
                pts = manipulator_sample_points(ee, j2, j3)
                return relu_max(halfplane_union_g(
                    pts, p["hp_points"], p["hp_normals"], p["hp_mask"],
                    expand=0.0))
            return _jax.value_and_grad(f)(q)

        def _selfcol_jac(q):
            return _jax.jacfwd(selfcol)(q)            # (4, 3)

        def stage_al_expansion(q, dq, k, p, lam_k, mu, inv_scale):
            e, Je = _track(q, p["X_ref"][k])
            eu = dq - p["U_ref"][k]
            edu = dq - p["U_last"][k]
            smax, sq = _slack_vg(q, p)
            two_s = 2.0 * inv_scale
            gq = two_s * (Je.T @ (p["Q"] @ e) + SLACK_WEIGHT * smax * sq)
            gu = two_s * (p["R"] @ eu + p["M"] @ edu)
            Hqq = two_s * (Je.T @ p["Q"] @ Je
                           + SLACK_WEIGHT * jnp.outer(sq, sq))
            Huu = two_s * (p["R"] + p["M"])
            Hux = jnp.zeros((3, 3), q.dtype)

            # ineq rows: [q_hi(3), q_lo(3), dd_hi(3), dd_lo(3), selfcol(4)]
            c = stage_ineq(q, dq, k, p)
            t = jnp.maximum(0.0, lam_k + mu * c)
            act = (t > 0).astype(q.dtype)
            gq = gq + (t[0:3] - t[3:6])
            gu = gu + (t[6:9] - t[9:12])
            Hqq = Hqq + jnp.diag(mu * (act[0:3] + act[3:6]))
            Huu = Huu + jnp.diag(mu * (act[6:9] + act[9:12]))
            Jsc = _selfcol_jac(q)
            gq = gq + Jsc.T @ t[12:16]
            Hqq = Hqq + mu * (Jsc.T * act[12:16][None, :]) @ Jsc
            return gq, gu, Hqq, Huu, Hux

        def terminal_al_expansion(q, p, lam_t, lam_e, mu, inv_scale):
            e, Je = _track(q, p["X_ref"][N])
            smax, sq = _slack_vg(q, p)
            two_s = 2.0 * inv_scale
            gq = two_s * (Je.T @ (p["P"] @ e) + SLACK_WEIGHT * smax * sq)
            Hqq = two_s * (Je.T @ p["P"] @ Je
                           + SLACK_WEIGHT * jnp.outer(sq, sq))
            # terminal rows: [q_hi(3), q_lo(3), selfcol(4)]
            c = terminal_ineq(q, p)
            t = jnp.maximum(0.0, lam_t + mu * c)
            act = (t > 0).astype(q.dtype)
            gq = gq + (t[0:3] - t[3:6])
            Hqq = Hqq + jnp.diag(mu * (act[0:3] + act[3:6]))
            Jsc = _selfcol_jac(q)
            gq = gq + Jsc.T @ t[6:10]
            Hqq = Hqq + mu * (Jsc.T * act[6:10][None, :]) @ Jsc
            return gq, Hqq

        def dynamics_jacobians(q, dq):
            eye = jnp.eye(3, dtype=q.dtype)
            return eye, jnp.asarray(dt, q.dtype) * eye

        ocp = OCP(nx=self.NX, nu=self.NU, N=N, dynamics=dynamics,
                  stage_cost=stage_cost, terminal_cost=terminal_cost,
                  stage_ineq=stage_ineq, terminal_ineq=terminal_ineq,
                  u_lower=jnp.asarray(self.dqlim[0]),
                  u_upper=jnp.asarray(self.dqlim[1]),
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
                "M": self.M_value,
                "Q_s": weight_sqrt(self.Q_value),
                "R_s": weight_sqrt(self.R_value),
                "P_s": weight_sqrt(self.P_value),
                "M_s": weight_sqrt(self.M_value),
                "hp_points": self.hp_points_value,
                "hp_normals": self.hp_normals_value,
                "hp_mask": self.hp_mask_value}

    def solve(self, x_init, traj_ref, u_ref):
        x_init = np.asarray(x_init, dtype=float).copy()
        # clamp infeasible sensor feedback (reference :134-135)
        x_init = np.clip(x_init, self.qlim[0], self.qlim[1])
        assert x_init[1] <= 0 and x_init[2] >= 0
        return self._solve_impl(x_init, self.make_params(traj_ref, u_ref))
