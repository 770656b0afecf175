"""Schur-complement Levenberg-Marquardt bundle adjustment.

Parity surface: /root/reference/tadataka/local_ba.py (LM mu/nu schedule,
convergence thresholds) + the external ``sparseba`` SBA solver it delegates
to (local_ba.py:6,77) — re-designed rather than ported:

- Per-observation 2x6 / 2x3 Jacobian blocks come from AD (residuals.py).
- The sparse normal equations are assembled by scatter-add into dense
  per-point W blocks (N, M, 6, 3): window BA has small M (keyframe count),
  so the reduced camera system S (6M x 6M) is tiny while N (landmarks) is
  large — exactly the shape the Schur trick wants.
- S = U + mu I - sum_i Y_i W_i^T is ONE einsum contraction over landmarks —
  one dense product, and the axis to shard for the distributed version
  (parallel/distributed_ba.py): shard i over devices, psum S and the camera
  rhs.
- The LM retry loop (mu/nu, mu, mu*nu^k) is a bounded ``lax.while_loop``.

All shapes static; invalid observations carry zero weight.
"""

from functools import partial

import jax
import jax.numpy as jnp

from tadataka_tpu.ba.residuals import (
    projection_residuals, projection_jacobians)


def _assemble(poses, points, viewpoint_indices, point_indices, x_true,
              weights):
    """Build (U, V, W, e_cam, e_pt, error) for the current state."""
    M = poses.shape[0]
    N = points.shape[0]

    r = projection_residuals(poses, points, viewpoint_indices, point_indices,
                             x_true)                       # (O, 2)
    A, B = projection_jacobians(poses, points, viewpoint_indices,
                                point_indices)             # (O,2,6), (O,2,3)
    w = weights[:, None, None]
    Aw = A * w
    Bw = B * w

    U = jnp.zeros((M, 6, 6)).at[viewpoint_indices].add(
        jnp.einsum('oia,oib->oab', Aw, A))
    V = jnp.zeros((N, 3, 3)).at[point_indices].add(
        jnp.einsum('oia,oib->oab', Bw, B))
    W = jnp.zeros((N, M, 6, 3)).at[point_indices, viewpoint_indices].add(
        jnp.einsum('oia,oib->oab', Aw, B))

    e_cam = jnp.zeros((M, 6)).at[viewpoint_indices].add(
        jnp.einsum('oia,oi->oa', Aw, r))
    e_pt = jnp.zeros((N, 3)).at[point_indices].add(
        jnp.einsum('oia,oi->oa', Bw, r))

    err = jnp.sum(jnp.sum(r * r, axis=-1) * weights) \
        / jnp.maximum(jnp.sum(weights), 1.0)
    return U, V, W, e_cam, e_pt, err


def _schur_step(U, V, W, e_cam, e_pt, mu):
    """Solve the damped normal equations via the Schur complement.

    Returns (dposes (M, 6), dpoints (N, 3)).
    """
    M = U.shape[0]
    N = V.shape[0]
    I3 = jnp.eye(3, dtype=V.dtype)
    I6 = jnp.eye(6, dtype=U.dtype)

    V_damped = V + mu * I3[None]
    V_inv = jnp.linalg.inv(V_damped)                       # (N, 3, 3)

    Y = jnp.einsum('nmab,nbc->nmac', W, V_inv)             # (N, M, 6, 3)

    # reduced camera system: S_jk = delta_jk (U_j + mu I) - sum_n Y_nj W_nk^T
    S = -jnp.einsum('njab,nkcb->jakc', Y, W)               # (M,6,M,6)
    U_diag = (U + mu * I6[None])                           # (M, 6, 6)
    # block-diagonal add without unrolling: scatter into the (M,6,M,6) view
    S = S.at[jnp.arange(M), :, jnp.arange(M), :].add(U_diag)
    S = S.reshape(6 * M, 6 * M)

    rhs = e_cam.reshape(-1) - jnp.einsum('njab,nb->ja', Y, e_pt).reshape(-1)

    dposes = jnp.linalg.solve(S, rhs).reshape(M, 6)

    # back-substitute landmarks
    Wt_dc = jnp.einsum('nmab,ma->nb', W, dposes)           # (N, 3)
    dpoints = jnp.einsum('nab,nb->na', V_inv, e_pt - Wt_dc)
    return dposes, dpoints


@partial(jax.jit, static_argnames=("max_iter",))
def lm_solve(poses, points, viewpoint_indices, point_indices, x_true,
             weights=None, max_iter=200, initial_mu=1.0, nu=100.0,
             absolute_error_threshold=1e-8, relative_error_threshold=1e-6,
             max_mu=1e12):
    """Levenberg-Marquardt with the reference's mu/nu schedule
    (local_ba.py:88-134).  Returns (poses, points, final_error).
    """
    if weights is None:
        weights = jnp.ones(x_true.shape[0], dtype=x_true.dtype)

    def error_of(po, pt):
        r = projection_residuals(po, pt, viewpoint_indices, point_indices,
                                 x_true)
        return (jnp.sum(jnp.sum(r * r, axis=-1) * weights)
                / jnp.maximum(jnp.sum(weights), 1.0))

    def lm_update(po, pt, mu):
        """Reference schedule: try mu/nu, then mu, then mu*nu^k.

        The normal equations depend only on the linearization point
        (po, pt), NOT on mu — so the system is assembled ONCE per outer
        iteration and every damping trial pays only a Schur solve + a
        residual evaluation, not a full Jacobian/scatter assembly per
        trial."""
        U, V, W, e_cam, e_pt, error0 = _assemble(
            po, pt, viewpoint_indices, point_indices, x_true, weights)

        def try_mu(mu_):
            dpo, dpt = _schur_step(U, V, W, e_cam, e_pt, mu_)
            new_po = po + dpo
            new_pt = pt + dpt
            return new_po, new_pt, error_of(new_po, new_pt)

        po1, pt1, err1 = try_mu(mu / nu)
        po2, pt2, err2 = try_mu(mu)

        def inflate(state):
            _, _, _, cur_mu, err = state
            new_mu = cur_mu * nu
            npo, npt, nerr = try_mu(new_mu)
            return npo, npt, nerr, new_mu, nerr

        def cond(state):
            _, _, _, cur_mu, err = state
            return jnp.logical_and(err >= error0, cur_mu < max_mu)

        po3, pt3, err3, mu3, _ = jax.lax.while_loop(
            cond, inflate, (po2, pt2, err2, mu, err2))

        use1 = err1 < error0
        use2 = jnp.logical_and(jnp.logical_not(use1), err2 < error0)

        def pick(a, b, c):
            return jnp.where(use1, a, jnp.where(use2, b, c))

        new_po = pick(po1, po2, po3)
        new_pt = pick(pt1, pt2, pt3)
        new_mu = jnp.where(use1, mu / nu, jnp.where(use2, mu, mu3))
        new_err = pick(err1, err2, err3)
        return new_po, new_pt, new_mu, new_err

    def body(state):
        po, pt, mu, cur_err, it, done = state
        po, pt, mu, new_err = lm_update(po, pt, mu)
        rel = jnp.abs((cur_err - new_err) / jnp.maximum(new_err, 1e-30))
        done = jnp.logical_or(new_err < absolute_error_threshold,
                              rel < relative_error_threshold)
        return po, pt, mu, new_err, it + 1, done

    def cond(state):
        *_, it, done = state
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    err0 = error_of(poses, points)
    poses, points, _, err, _, _ = jax.lax.while_loop(
        cond, body, (poses, points, jnp.asarray(initial_mu, poses.dtype),
                     err0, 0, jnp.asarray(False)))
    return poses, points, err


class LocalBundleAdjustment:
    """Reference-shaped wrapper (local_ba.py:60-134)."""

    def __init__(self, viewpoint_indices, point_indices, x_true):
        assert len(viewpoint_indices) == x_true.shape[0]
        assert len(point_indices) == x_true.shape[0]
        self.viewpoint_indices = jnp.asarray(viewpoint_indices)
        self.point_indices = jnp.asarray(point_indices)
        self.x_true = jnp.asarray(x_true)

    def compute(self, initial_rotvecs, initial_translations, initial_points,
                max_iter=200, initial_mu=1.0, nu=100.0,
                absolute_error_threshold=1e-8,
                relative_error_threshold=1e-6):
        poses = jnp.concatenate(
            [jnp.asarray(initial_rotvecs), jnp.asarray(initial_translations)],
            axis=-1)
        poses, points, _ = lm_solve(
            poses, jnp.asarray(initial_points),
            self.viewpoint_indices, self.point_indices, self.x_true,
            max_iter=max_iter, initial_mu=initial_mu, nu=nu,
            absolute_error_threshold=absolute_error_threshold,
            relative_error_threshold=relative_error_threshold)
        return poses[:, :3], poses[:, 3:], points
