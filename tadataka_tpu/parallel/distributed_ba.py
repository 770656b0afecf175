"""Distributed Schur-complement bundle adjustment.

Shard landmarks (and their observations) across devices; each device
assembles its local V/W blocks and its contribution to the reduced camera
system; ``psum`` over the device axis reduces the (6M x 6M) camera
system, which every device solves redundantly (it is tiny); landmark
back-substitution stays local.  Per LM iteration the only communication is
psum(S) + psum(rhs) + psum(scalar error) — O(M^2) floats, independent of the
landmark count.

Everything runs under one ``shard_map``-ed jit, so the same code compiles
for one device or many.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from tadataka_tpu.ba.residuals import (
    projection_residuals, projection_jacobians)

AXIS = "shard"


def shard_observations(viewpoint_indices, point_indices, x_true,
                       n_points, n_devices):
    """Host-side layout: pad points to a multiple of n_devices and group
    observations by owning shard (each padded to equal length).

    Returns (vi_sh, pi_local_sh, x_sh, w_sh, points_per_shard) where arrays
    have leading axis n_devices and pi_local is the in-shard point index.
    """
    viewpoint_indices = np.asarray(viewpoint_indices)
    point_indices = np.asarray(point_indices)
    x_true = np.asarray(x_true)

    points_per_shard = -(-n_points // n_devices)
    shard_of = point_indices // points_per_shard
    counts = np.bincount(shard_of, minlength=n_devices)
    max_obs = int(counts.max()) if len(counts) else 1
    max_obs = max(max_obs, 1)

    vi_sh = np.zeros((n_devices, max_obs), dtype=np.int32)
    pi_sh = np.zeros((n_devices, max_obs), dtype=np.int32)
    x_sh = np.zeros((n_devices, max_obs, 2), dtype=np.float32)
    w_sh = np.zeros((n_devices, max_obs), dtype=np.float32)

    for d in range(n_devices):
        sel = np.where(shard_of == d)[0]
        n = len(sel)
        vi_sh[d, :n] = viewpoint_indices[sel]
        pi_sh[d, :n] = point_indices[sel] - d * points_per_shard
        x_sh[d, :n] = x_true[sel]
        w_sh[d, :n] = 1.0
    return vi_sh, pi_sh, x_sh, w_sh, points_per_shard


def _local_assemble(poses, points_local, vi, pi_local, x_true, w, mu):
    """Per-shard normal-equation blocks + Schur contribution."""
    M = poses.shape[0]
    Nl = points_local.shape[0]

    r = projection_residuals(poses, points_local, vi, pi_local, x_true)
    A, B = projection_jacobians(poses, points_local, vi, pi_local)
    ww = w[:, None, None]
    Aw = A * ww
    Bw = B * ww

    U = jnp.zeros((M, 6, 6)).at[vi].add(jnp.einsum('oia,oib->oab', Aw, A))
    V = jnp.zeros((Nl, 3, 3)).at[pi_local].add(
        jnp.einsum('oia,oib->oab', Bw, B))
    W = jnp.zeros((Nl, M, 6, 3)).at[pi_local, vi].add(
        jnp.einsum('oia,oib->oab', Aw, B))
    e_cam = jnp.zeros((M, 6)).at[vi].add(jnp.einsum('oia,oi->oa', Aw, r))
    e_pt = jnp.zeros((Nl, 3)).at[pi_local].add(
        jnp.einsum('oia,oi->oa', Bw, r))

    V_inv = jnp.linalg.inv(V + mu * jnp.eye(3)[None])
    Y = jnp.einsum('nmab,nbc->nmac', W, V_inv)

    S_local = -jnp.einsum('njab,nkcb->jakc', Y, W)
    rhs_local = -jnp.einsum('njab,nb->ja', Y, e_pt)

    sq_err = jnp.sum(jnp.sum(r * r, axis=-1) * w)
    n_obs = jnp.sum(w)
    return U, V_inv, W, e_cam, e_pt, S_local, rhs_local, sq_err, n_obs


def _spmd_step(poses, points_local, vi, pi_local, x_true, w, mu):
    """One damped GN step, executed identically on every shard."""
    M = poses.shape[0]
    (U, V_inv, W, e_cam, e_pt, S_local, rhs_local,
     sq_err, n_obs) = _local_assemble(poses, points_local, vi, pi_local,
                                      x_true, w, mu)

    # the ONLY cross-device communication of the iteration
    S = jax.lax.psum(S_local, AXIS)
    rhs_pt = jax.lax.psum(rhs_local, AXIS)
    U_sum = jax.lax.psum(U, AXIS)
    e_cam_sum = jax.lax.psum(e_cam, AXIS)

    S = S.reshape(M, 6, M, 6)
    S = S.at[jnp.arange(M), :, jnp.arange(M), :].add(
        U_sum + mu * jnp.eye(6)[None])
    S = S.reshape(6 * M, 6 * M)
    rhs = e_cam_sum.reshape(-1) + rhs_pt.reshape(-1)

    dposes = jnp.linalg.solve(S, rhs).reshape(M, 6)

    Wt_dc = jnp.einsum('nmab,ma->nb', W, dposes)
    dpoints = jnp.einsum('nab,nb->na', V_inv, e_pt - Wt_dc)
    return dposes, dpoints


def _spmd_error(poses, points_local, vi, pi_local, x_true, w):
    r = projection_residuals(poses, points_local, vi, pi_local, x_true)
    sq = jax.lax.psum(jnp.sum(jnp.sum(r * r, axis=-1) * w), AXIS)
    n = jax.lax.psum(jnp.sum(w), AXIS)
    return sq / jnp.maximum(n, 1.0)


def _spmd_lm(poses, points_local, vi, pi_local, x_true, w,
             max_iter, initial_mu, nu, abs_threshold, rel_threshold):
    """Full LM loop under SPMD; mirrors ba/schur.py's schedule."""

    def try_mu(po, pt, mu):
        dpo, dpt = _spmd_step(po, pt, vi, pi_local, x_true, w, mu)
        npo, npt = po + dpo, pt + dpt
        return npo, npt, _spmd_error(npo, npt, vi, pi_local, x_true, w)

    def lm_update(po, pt, mu):
        error0 = _spmd_error(po, pt, vi, pi_local, x_true, w)
        po1, pt1, err1 = try_mu(po, pt, mu / nu)
        po2, pt2, err2 = try_mu(po, pt, mu)

        def inflate(state):
            _, _, _, cur_mu, _ = state
            new_mu = cur_mu * nu
            npo, npt, nerr = try_mu(po, pt, new_mu)
            return npo, npt, nerr, new_mu, nerr

        def cond(state):
            *_, cur_mu, err = state
            return jnp.logical_and(err >= error0, cur_mu < 1e12)

        po3, pt3, err3, mu3, _ = jax.lax.while_loop(
            cond, inflate, (po2, pt2, err2, mu, err2))

        use1 = err1 < error0
        use2 = jnp.logical_and(jnp.logical_not(use1), err2 < error0)

        def pick(a, b, c):
            return jnp.where(use1, a, jnp.where(use2, b, c))

        return (pick(po1, po2, po3), pick(pt1, pt2, pt3),
                jnp.where(use1, mu / nu, jnp.where(use2, mu, mu3)),
                pick(err1, err2, err3))

    def body(state):
        po, pt, mu, cur_err, it, done = state
        po, pt, mu, new_err = lm_update(po, pt, mu)
        rel = jnp.abs((cur_err - new_err) / jnp.maximum(new_err, 1e-30))
        done = jnp.logical_or(new_err < abs_threshold, rel < rel_threshold)
        return po, pt, mu, new_err, it + 1, done

    def cond(state):
        *_, it, done = state
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    err0 = _spmd_error(poses, points_local, vi, pi_local, x_true, w)
    poses, points_local, _, err, _, _ = jax.lax.while_loop(
        cond, body,
        (poses, points_local, jnp.asarray(initial_mu, poses.dtype), err0, 0,
         jnp.asarray(False)))
    return poses, points_local, err


def distributed_lm_solve(mesh, poses, points, viewpoint_indices,
                         point_indices, x_true, max_iter=20,
                         initial_mu=1.0, nu=100.0,
                         absolute_error_threshold=1e-8,
                         relative_error_threshold=1e-6):
    """Landmark-sharded LM bundle adjustment over a device mesh.

    poses: (M, 6); points: (N, 3); observations indexed globally.
    Returns (poses, points, error).
    """
    n_devices = mesh.devices.size
    vi_sh, pi_sh, x_sh, w_sh, pps = shard_observations(
        viewpoint_indices, point_indices, x_true, points.shape[0], n_devices)

    N_pad = pps * n_devices
    points_pad = np.zeros((N_pad, 3), dtype=np.float32)
    points_pad[:points.shape[0]] = np.asarray(points)

    spmd = jax.jit(jax.shard_map(
        partial(_spmd_lm, max_iter=max_iter, initial_mu=initial_mu, nu=nu,
                abs_threshold=absolute_error_threshold,
                rel_threshold=relative_error_threshold),
        mesh=mesh,
        in_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(), P(AXIS), P()),
        check_vma=True,
    ))

    new_poses, new_points_pad, err = spmd(
        jnp.asarray(poses), jnp.asarray(points_pad),
        jnp.asarray(vi_sh).reshape(-1),
        jnp.asarray(pi_sh).reshape(-1),
        jnp.asarray(x_sh).reshape(-1, 2),
        jnp.asarray(w_sh).reshape(-1))
    return new_poses, new_points_pad[:points.shape[0]], err
