"""Config dataclasses: solver settings and benchmark scenarios.

The reference keeps scenario constants inline in the demo script
(/root/reference/demo_wholebody_qref.py:10-44) and controller defaults in
``__init__`` signatures.  Here every configuration is an explicit, hashable
dataclass; everything that varies at runtime (weights, obstacle positions,
references) is a plain array argument to jitted functions — mirroring the
reference's ``opti.parameter`` mechanism so one compiled program serves all
task phases.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

PI = math.pi

# Frame offsets between the Albert base link and the arm mount (joint 1).
# Reference: /root/reference/robot_models/mobile_manipulator.py:14-15.  The
# -0.007 x-offset is a known sign quirk in the reference ("it's an error!")
# kept as the default for bit-compatibility with the oracle.
BASELINK2JOINT1_X = -0.007
BASELINK2JOINT1_Z = 0.606 + 0.333

# Stand-off distance between the base target and the button
# (reference interface_wholebody_qref.py:23).
WORKING_RADIUS = 0.6


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Fixed-shape AL-iLQR solver settings (all static under jit).

    The reference runs IPOPT with max_iter=2000 / acceptable_tol=1e-8
    (mpc_wholebody_qref.py:280-285).  On the accelerator we run a fixed
    number of augmented-Lagrangian outer rounds, each with a fixed number of iLQR
    sweeps, with convergence masking instead of data-dependent exits.
    """

    al_iters: int = 6          # outer augmented-Lagrangian multiplier updates
    ilqr_iters: int = 10       # inner iLQR sweeps in the FIRST AL round
    # Inner sweeps in later AL rounds.  The first round solves the problem
    # from scratch; subsequent rounds only track the multiplier updates, so
    # a handful of sweeps suffices.  None => same as ilqr_iters.
    ilqr_iters_later: int | None = None
    # Inner sweeps in the LAST AL round.  The final violation is decided by
    # how well the last subproblem is solved, so a polish budget there buys
    # the convergence tail more cheaply than widening every middle round.
    # None => same as ilqr_iters_later.
    ilqr_iters_final: int | None = None
    mu_init: float = 10.0      # initial AL penalty
    mu_scale: float = 5.0      # penalty growth per AL round
    mu_max: float = 1e6
    reg_init: float = 1e-6     # Levenberg regularization on Quu
    reg_scale: float = 10.0
    reg_max: float = 1e6
    n_alpha: int = 8           # parallel backtracking line-search candidates
    alpha_decay: float = 0.5
    cost_tol: float = 1e-7     # relative cost-decrease tolerance (for masking)
    constraint_tol: float = 1e-5
    # Objective values in the reference formulation reach ~1e5 (slack weight
    # S); dividing the AL objective by this factor keeps value-function
    # arithmetic within float32 mantissa.  Solutions are unchanged
    # (uniform scaling); reported costs are in original units.
    cost_scale: float = 1.0
    # Run the batched solver's inner loop through the OCP's fused kernels
    # (solver/batched.py lanes path) where they apply: on the GPU, for an
    # OCP that provides them.  False pins the plain vmapped XLA path, the
    # comparison the kernels are kept against.
    use_kernels: bool = True
    # Unroll factor for the sequential horizon scans (forward line-search
    # rollouts).  The per-step working set is tiny, so the scan is
    # launch/HBM-latency bound; unrolling lets XLA fuse consecutive steps.
    scan_unroll: int = 1
    # Evaluate the Riccati backward sweep with the associative-scan
    # (parallel-prefix) formulation — O(log N) sequential depth instead of
    # O(N), at the price of matrix-matrix composition elements.  Values:
    #   "auto" (default): the sequential scan until the crossover is
    #     measured on the GPU (solver/al_ilqr.py::resolve_assoc_scan);
    #   True: force assoc;  False: force the sequential scan.
    # Applies to the per-scenario (vmapped) solver path.
    use_assoc_scan: bool | str = "auto"
    # Matmul precision for the solver's linear algebra.  A float32 matrix
    # product on the GPU may run in TF32 (about three decimal digits),
    # which is NOT enough for the Riccati gain algebra: solves can still
    # pass a 1e-3 violation tolerance while closed-loop position regulation
    # degenerates into a limit cycle around the target.  These are 9x9/5x5
    # matrices, so full float32 costs little; "highest" is the default.
    matmul_precision: str = "highest"


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One benchmark scenario (the reference's five configs, BASELINE.json).

    ``hp_points``/``hp_normals`` encode the half-plane ("convex") obstacles
    for the manipulator as dense arrays padded to ``n_halfplanes``; a mask
    keeps vmapped batches shape-stable across scenarios.
    """

    name: str
    dt: float
    N: int
    t_move: float
    t_manipulate: float
    x_start: np.ndarray          # (9,)
    global_pose_target: np.ndarray  # (4,) x y z psi of the end effector
    ground_obstacles: np.ndarray    # (n_obs, 3) columns x, y, radius
    hp_points: np.ndarray        # (n_hp, 3)
    hp_normals: np.ndarray       # (n_hp, 3)
    hp_mask: np.ndarray          # (n_hp,) 1.0 for live half-planes

    @property
    def n_halfplanes(self) -> int:
        return int(self.hp_mask.sum())


def _hp_arrays(pairs, n_pad):
    """Stack (point, normal) pairs into padded arrays + mask."""
    pts = np.zeros((n_pad, 3))
    nrm = np.zeros((n_pad, 3))
    msk = np.zeros((n_pad,))
    for j, (p, n) in enumerate(pairs):
        pts[j] = np.asarray(p, dtype=float).reshape(3)
        nrm[j] = np.asarray(n, dtype=float).reshape(3)
        msk[j] = 1.0
    return pts, nrm, msk


# Ground obstacles common to all demo scenarios
# (reference demo_wholebody_qref.py:40-44).
_GROUND_OBSTACLES = np.array(
    [
        [2.5, 3.0, 0.6],
        [2.5, 1.0, 0.6],
        [5 - 0.6, 5.0, 0.1],
    ]
)


def make_scenario(experiment_scenario: int = 1, dt: float = 0.1, N: int = 20,
                  t_move: float = 5.0, t_manipulate: float = 2.0,
                  n_hp_pad: int = 3) -> Scenario:
    """The reference demo's three scenarios (demo_wholebody_qref.py:18-44).

    scenario 1: table-corner avoidance (3 half-planes around the button),
    scenario 2: wedge obstacle during base motion (2 half-planes),
    scenario 0: debug — no half-plane obstacles, trivial backwards target.
    """
    if experiment_scenario == 1:
        x_start = np.array([0, 0, 0, 0, 0, 0, -PI / 4, -PI, PI], dtype=float)
        target = np.array([5 - 0.6, 5, 0.606 + 0.333 + 0.5, -PI])
        hp = [
            (np.array([5.007 - 0.43, 5, 0.27 + 0.606 + 0.333]), np.array([0, 0, -1.0])),
            (np.array([5.007 - 0.43, 5, 0.27 + 0.606 + 0.333]), np.array([-1.0, 0, 0])),
            (np.array([5.007 - 0.43, 5, 0.27 + 0.606 + 0.333]), np.array([0, 1.0, 0])),
        ]
    elif experiment_scenario == 2:
        x_start = np.zeros(9)
        target = np.array([5 - 0.6, 5, 0.606 + 0.333 + 0.5, -PI])
        s2 = 1.0 / math.sqrt(2.0)
        hp = [
            (np.array([2.5, 2, 0.35 + 0.606 + 0.333]), np.array([s2, 0, s2])),
            (np.array([2.5, 2, 0.35 + 0.606 + 0.333]), np.array([-s2, 0, s2])),
        ]
    else:  # debug scenario 0
        x_start = np.zeros(9)
        target = np.array([-0.6, 0, 0.606 + 0.333 + 0.5, -PI])
        hp = []

    pts, nrm, msk = _hp_arrays(hp, n_hp_pad)
    return Scenario(
        name=f"scenario{experiment_scenario}",
        dt=dt, N=N, t_move=t_move, t_manipulate=t_manipulate,
        x_start=x_start, global_pose_target=target,
        ground_obstacles=_GROUND_OBSTACLES.copy(),
        hp_points=pts, hp_normals=nrm, hp_mask=msk,
    )
