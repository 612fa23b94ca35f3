"""1-D point-mass demo MPC — the simplest instance of the controller pattern.

Reference: /root/reference/controllers/mpc_demo.py.  Double integrator,
position/velocity tracking, acceleration input box, hard velocity box on the
running states (the reference leaves the terminal state unbounded; kept).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mmmpc_tpu.controllers.common import (
    ControllerBase, as_weight_matrix, weight_sqrt,
)
from mmmpc_tpu.models.point_mass import point_mass_step
from mmmpc_tpu.ocp import OCP
from mmmpc_tpu.utils.configs import SolverConfig


class MPC(ControllerBase):
    NX, NU = 2, 1

    def __init__(self, robot, N=10, Q=np.diag([1.0, 0.0]),
                 P=np.diag([1.0, 0.0]), R=np.diag([0.1]),
                 vlim=(-1, 1), alim=(-5, 5),
                 solver_config: SolverConfig | None = None):
        self.dt = robot.dt
        self.vlim = vlim
        self.Q_value = as_weight_matrix(Q, self.NX)
        self.P_value = as_weight_matrix(P, self.NX)
        self.R_value = as_weight_matrix(R, self.NU)
        dt = self.dt

        def stage_cost(x, u, k, p):
            ex = x - p["X_ref"][k]
            eu = u - p["U_ref"][k]
            return ex @ p["Q"] @ ex + eu @ p["R"] @ eu

        def terminal_cost(x, p):
            ex = x - p["X_ref"][N]
            return ex @ p["P"] @ ex

        def stage_ineq(x, u, k, p):
            return jnp.stack([x[1] - vlim[1], vlim[0] - x[1]])

        def stage_residuals(x, u, k, p):
            ex = x - p["X_ref"][k]
            eu = u - p["U_ref"][k]
            return jnp.concatenate([p["Q_s"] @ ex, p["R_s"] @ eu])

        def terminal_residuals(x, p):
            return p["P_s"] @ (x - p["X_ref"][N])

        # structured AL expansion (see wholebody_qref.py): everything is
        # quadratic/diagonal here, so no AD at all in the solver hot loop
        def stage_al_expansion(x, u, k, p, lam_k, mu, inv_scale):
            two_s = 2.0 * inv_scale
            gx = two_s * (p["Q"] @ (x - p["X_ref"][k]))
            gu = two_s * (p["R"] @ (u - p["U_ref"][k]))
            Hxx = two_s * p["Q"]
            Huu = two_s * p["R"]
            Hux = jnp.zeros((1, 2), x.dtype)
            t = jnp.maximum(0.0, lam_k + mu * stage_ineq(x, u, k, p))
            act = (t > 0).astype(x.dtype)
            gx = gx.at[1].add(t[0] - t[1])
            Hxx = Hxx.at[1, 1].add(mu * (act[0] + act[1]))
            return gx, gu, Hxx, Huu, Hux

        def terminal_al_expansion(x, p, lam_t, lam_e, mu, inv_scale):
            two_s = 2.0 * inv_scale
            return (two_s * (p["P"] @ (x - p["X_ref"][N])), two_s * p["P"])

        def dynamics_jacobians(x, u):
            A = jnp.asarray([[1.0, dt], [0.0, 1.0]], x.dtype)
            B = jnp.asarray([[0.0], [dt]], x.dtype)
            return A, B

        ocp = OCP(nx=self.NX, nu=self.NU, N=N,
                  dynamics=lambda x, u: point_mass_step(x, u, dt),
                  stage_cost=stage_cost, terminal_cost=terminal_cost,
                  stage_ineq=stage_ineq,
                  u_lower=jnp.asarray([float(alim[0])]),
                  u_upper=jnp.asarray([float(alim[1])]),
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
                "Q_s": weight_sqrt(self.Q_value),
                "R_s": weight_sqrt(self.R_value),
                "P_s": weight_sqrt(self.P_value)}

    def solve(self, x_init, traj_ref, u_ref):
        u_ref = np.asarray(u_ref, dtype=float).reshape(self.N, self.NU)
        return self._solve_impl(np.asarray(x_init, dtype=float),
                                self.make_params(traj_ref, u_ref))
