"""Scaling layer: vmap within a chip, shard_map across the device mesh.

The reference is a single-process synchronous loop — one IPOPT solve per
control tick (SURVEY.md §2.3).  Here the scaling unit is the *solve*:
thousands of scenarios (initial states x obstacle layouts x references) are
vmapped into one compiled program per chip and sharded across chips over a
1-D ``("data",)`` mesh.  Cross-chip aggregates (throughput counts,
constraint-violation maxima, convergence fractions) are collectives
(psum/pmax) inside the same compiled program, so multi-host benchmarking
needs no host-side gather.

Tensor/pipeline/sequence/expert parallelism are deliberately absent: at
nx=9 / nu=5 / N<=20 a single solve is far below one core's compute, so the
scaling dimension is the scenario batch (see SURVEY.md §2.3's analysis).
Long-horizon intra-solve parallelism would be an associative-scan Riccati,
which stays chip-local.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


class BatchStats(NamedTuple):
    """Mesh-global batch statistics, reduced over the mesh."""
    n_solved: jnp.ndarray          # total solves in the global batch
    n_converged: jnp.ndarray       # solves meeting the constraint tolerance
    max_violation: jnp.ndarray     # worst hard-constraint violation anywhere
    mean_cost: jnp.ndarray


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """A 1-D data mesh over all (or the given) devices."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices).reshape(-1), (axis_name,))


def _with_stats(run_b):
    def run(x0_b, U0_b, params):
        res = run_b(x0_b, U0_b, params)
        stats = BatchStats(
            n_solved=jnp.asarray(x0_b.shape[0], jnp.float32),
            n_converged=jnp.sum(res.converged.astype(jnp.float32)),
            max_violation=jnp.max(res.max_violation),
            mean_cost=jnp.mean(res.cost),
        )
        return res, stats

    return run


def batched_solve_fn(solve_fn):
    """vmap a single-scenario solve over (x0, U0) batches with shared params.

    solve_fn: (x0, U0, params) -> SolveResult.  Returns (results, stats)
    where stats are single-chip aggregates.
    """
    return _with_stats(
        lambda x0_b, U0_b, params: jax.vmap(
            lambda x0, U0: solve_fn(x0, U0, params))(x0_b, U0_b))


def controller_batched_fn(controller):
    """Batched (x0_b, U0_b, params) -> (results, stats) for a controller,
    via the natively-batched solver (fused kernels on the GPU)."""
    return _with_stats(controller.batch_solve_fn())


def sharded_task_loop_fn(run, mesh: Mesh, axis_name: str = "data"):
    """shard_map a fleet task loop over the mesh's data axis.

    ``run`` is a loop built by sim/batch_task_engine.make_batch_task_loop:
    ``run(x_start_b, global_pose_target_b, carry0=None) ->
    (TaskRolloutLog, carry)``.  Robots are embarrassingly parallel — state,
    phase FSM, batched IK, and the primal/dual warm starts are all
    per-robot — so every array (inputs, log, carry) shards on its leading
    batch axis and no collective runs inside the tick; cross-chip movement
    is the initial scatter and the log/checkpoint gather.  The carry
    returned by one segment feeds the next segment SHARDED (chunked
    dispatch stays multi-chip end-to-end, and the carry doubles as the
    sharded fleet checkpoint payload).

    The global batch must divide by the mesh size.  The scale-out twin of
    the single-chip loop the reference runs one-robot-per-process
    (/root/reference/interface_wholebody_qref.py:65-81); SURVEY.md §2.3.
    """
    data = P(axis_name)
    # pytree-prefix specs: every leaf of the log and of the carry is
    # batch-leading, so a single P("data") prefix covers both trees
    fresh = jax.shard_map(
        lambda x, g: run(x, g), mesh=mesh,
        in_specs=(data, data), out_specs=(data, data), check_vma=False)
    cont = jax.shard_map(
        lambda x, g, c: run(x, g, c), mesh=mesh,
        in_specs=(data, data, data), out_specs=(data, data),
        check_vma=False)

    def run_sharded(x_start_b, global_pose_target_b, carry0=None):
        x_start_b = jax.device_put(
            x_start_b, NamedSharding(mesh, data))
        global_pose_target_b = jax.device_put(
            global_pose_target_b, NamedSharding(mesh, data))
        if carry0 is None:
            return jax.jit(fresh)(x_start_b, global_pose_target_b)
        return jax.jit(cont)(x_start_b, global_pose_target_b, carry0)

    return run_sharded


def sharded_solve_fn(solve_fn, mesh: Mesh, axis_name: str = "data",
                     batch_impl=None):
    """shard_map the batched solve over the mesh's data axis.

    The per-chip shard runs the batched solve (``batch_impl`` — e.g. a
    controller's ``batch_solve_fn()`` with the Pallas Riccati kernel — or a
    vmap of ``solve_fn``); BatchStats are reduced with psum/pmax over the mesh
    inside the compiled program.  Batch size must divide by the mesh size.
    Returns a jitted callable (x0_b, U0_b, params) ->
    (SolveResult sharded over batch, BatchStats replicated).
    """
    run = (_with_stats(batch_impl) if batch_impl is not None
           else batched_solve_fn(solve_fn))

    def shard_body(x0_b, U0_b, params):
        res, stats = run(x0_b, U0_b, params)
        stats = BatchStats(
            n_solved=jax.lax.psum(stats.n_solved, axis_name),
            n_converged=jax.lax.psum(stats.n_converged, axis_name),
            max_violation=jax.lax.pmax(stats.max_violation, axis_name),
            mean_cost=jax.lax.pmean(stats.mean_cost, axis_name),
        )
        return res, stats

    sharded = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P()),
        out_specs=(P(axis_name), P()),
        check_vma=False)

    def run_sharded(x0_b, U0_b, params):
        x0_b = jax.device_put(
            x0_b, NamedSharding(mesh, P(axis_name)))
        U0_b = jax.device_put(
            U0_b, NamedSharding(mesh, P(axis_name)))
        return jax.jit(sharded)(x0_b, U0_b, params)

    return run_sharded
