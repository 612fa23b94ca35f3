"""Vectorized constraint building blocks shared by all controllers.

Each function returns constraint values with the convention ``g <= 0`` is
satisfied, evaluated for a single state (vmap over the horizon happens in the
solver).  These are the vectorized forms of the reference's per-k Python
loops over CasADi expressions (mpc_wholebody_qref.py:49-89,208-227).
"""

import jax.numpy as jnp

from mmmpc_tpu.models.mobile_manipulator import wholebody_fk
from mmmpc_tpu.utils.math import safe_dist, safe_norm

# A "satisfied by a wide margin" constant used to disable masked-out
# constraint rows without resorting to +-inf (which poisons Hessians).
_NEG_BIG = -1e9

# Endpoint self-collision sphere radius (mpc_wholebody_qref.py:43).
SELF_COLLISION_RADIUS = 0.05
# Half-plane obstacles are expanded by this margin because the link radius is
# not modeled (mpc_wholebody_qref.py:44,78).
OBSTACLE_EXPAND_DIST = 0.03


def ground_circle_g(xy_x, xy_y, obstacles, body_radius):
    """(r_obs + r_body) - dist((x,y), obs) for each ground obstacle.

    obstacles: (n_obs, 3) rows [x, y, radius].  Reference obsAvoid
    (mpc_wholebody_qref.py:49-54).
    """
    return (obstacles[:, 2] + body_radius) - safe_dist(
        xy_x - obstacles[:, 0], xy_y - obstacles[:, 1])


def manipulator_sample_points(ee, j2, j3):
    """The six sampled link points used for obstacle constraints.

    [j2/2, j2, (j2+j3)/2, j3, (j3+ee)/2, ee] — reference
    mpc_wholebody_qref.py:216-217.  (In the whole-body controller these are
    world-frame points, including the quirky j2/2 'midpoint' of the world
    position — kept verbatim for parity.)
    """
    return jnp.stack([j2 / 2, j2, (j2 + j3) / 2, j3, (j3 + ee) / 2, ee])


def self_collision_g(ee, j2, j3, radius=SELF_COLLISION_RADIUS):
    """radius - ||p_check - ee|| for the four check points.

    Check points [origin, j2/2, j2, (j2+j3)/2] — reference
    mpc_wholebody_qref.py:219-222.  Note: in the whole-body controller the
    first check point is the *world* origin (the reference reuses the
    arm-frame list unchanged); we keep that behavior.
    """
    checks = jnp.stack([jnp.zeros_like(ee), j2 / 2, j2, (j2 + j3) / 2])
    return radius - safe_norm(checks - ee[None, :], axis=-1)


def halfplane_union_g(points, hp_points, hp_normals, hp_mask,
                      expand=OBSTACLE_EXPAND_DIST):
    """Union-of-half-planes obstacle values for each sampled link point.

    A point p is safe w.r.t. the obstacle if it lies outside at least one
    face: max_j n_j . (o_j - p) <= 0 where o_j is the face point pushed out
    by ``expand`` along its normal.  Returns g_i = -max_j(...) per sampled
    point (g <= 0 safe) — reference obsAvoidConvex
    (mpc_wholebody_qref.py:76-89) without the if_else/mmax special cases:
    one masked max covers 1, 2 or n faces.

    points: (n_p, 3); hp_*: (n_hp, ...).  If no face is live (scenario 0)
    the constraint is reported as satisfied.
    """
    o = hp_points - expand * hp_normals                    # (n_hp, 3)
    d = jnp.einsum("jc,ijc->ij", hp_normals,
                   o[None, :, :] - points[:, None, :])     # (n_p, n_hp)
    d = jnp.where(hp_mask[None, :] > 0, d, _NEG_BIG)
    any_live = jnp.sum(hp_mask) > 0
    return jnp.where(any_live, -jnp.max(d, axis=1), _NEG_BIG)


def wholebody_collision_g(x, obstacles, base_radius, hp_points, hp_normals,
                          hp_mask, include_self_collision=True):
    """All slack-group constraint values of the whole-body qref MPC at one
    state: ground circles + self-collision spheres + half-plane unions.

    Returns a flat vector; the slack cost is S * relu(max(.))^2.
    """
    pose_ee, j2, j3 = wholebody_fk(x)
    ee = pose_ee[:3]
    g_ground = ground_circle_g(x[0], x[1], obstacles, base_radius)
    pts = manipulator_sample_points(ee, j2, j3)
    g_hp = halfplane_union_g(pts, hp_points, hp_normals, hp_mask)
    parts = [g_ground, g_hp]
    if include_self_collision:
        parts.append(self_collision_g(ee, j2, j3))
    return jnp.concatenate(parts)


def box_g(v, lower, upper, finite_mask_lo, finite_mask_hi):
    """Two-sided box constraints as g <= 0, with masked infinite bounds.

    lower/upper are dense arrays with +-inf replaced by 0 where masked; the
    static masks select which rows are emitted as real constraints.
    """
    upper = jnp.asarray(upper, v.dtype)
    lower = jnp.asarray(lower, v.dtype)
    g_hi = jnp.where(finite_mask_hi, v - upper, _NEG_BIG)
    g_lo = jnp.where(finite_mask_lo, lower - v, _NEG_BIG)
    return jnp.concatenate([g_hi, g_lo])


def relu_max(g):
    """relu(max g) with a static-shape empty-group guard.

    An empty constraint group (e.g. a controller built with no obstacles)
    contributes 0.  NOTE: must branch on the static shape — ``jnp.max(g,
    initial=...)`` on a 0-size array has a NaN forward-mode derivative.
    """
    if g.shape[0] == 0:
        return jnp.zeros(())
    return jnp.maximum(0.0, jnp.max(g))


def relu_max_penalty(g, weight):
    """The exact slack-block equivalent: weight * relu(max g)^2."""
    smax = relu_max(g)
    return weight * smax * smax
