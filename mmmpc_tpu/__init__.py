"""mmmpc_tpu — batched whole-body MPC framework for a mobile manipulator.

A from-scratch re-design of the capabilities of HsinyuG/mobile-manipulator-mpc
(CasADi/IPOPT/PyBullet, see /root/reference) as an idiomatic JAX/XLA/Pallas
framework:

- ``models``      pure-function dynamics & kinematics (diff-drive base,
                  Panda-3DoF arm, whole-body composition), batched Gauss-Newton
                  IK (replaces the reference's ``ca.nlpsol('ipopt')`` IK).
- ``ocp``         declarative optimal-control-problem spec: costs, bounds,
                  obstacle / self-collision constraint residuals vectorized
                  over the horizon (replaces the CasADi ``Opti()`` graph).
- ``solver``      augmented-Lagrangian iLQR (Riccati sweep via ``lax.scan``)
                  with fixed iteration counts; jit/vmap-safe throughout
                  (replaces IPOPT).
- ``controllers`` the reference's controller API surface (MPCDemo, MPCBase,
                  MPCManipulator3DoF, MPCWholeBody variants) on top of the
                  generic solver.
- ``runtime``     task state machine, global/local planners, closed-loop
                  driver, logging (replaces interface_wholebody_qref.py).
- ``sim``         pure-JAX kinematic plant (the reference's
                  ``physical_sim=False`` path), batched.
- ``parallel``    mesh construction, shard_map'd batched solves, collective
                  metric reductions (solves/s, constraint-violation maxima).
- ``ops``         fused Pallas kernels (Triton route) for the GPU hot path.
- ``utils``       angle math, safe norms, config dataclasses, DH codegen
                  verification.
"""

__version__ = "0.1.0"

from mmmpc_tpu.utils import configs  # noqa: F401
