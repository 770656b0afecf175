"""Perspective-n-Point pose estimation with RANSAC.

Parity surface: solve_pnp (/root/reference/tadataka/pose.py:67-99), which
delegates to cv2.solvePnPRansac(EPnP) with an adaptive reprojection
threshold.  Here: vmapped fixed-trial RANSAC over 6-point DLT hypotheses,
followed by masked Gauss-Newton refinement on the inlier set — no OpenCV.

Keypoints are NORMALIZED image coordinates (the reference passes K = I).
"""

from functools import partial

import jax
import jax.numpy as jnp

from tadataka_tpu.core.pose import Pose
from tadataka_tpu.core.projection import pi
from tadataka_tpu.core.so3 import exp_so3
from tadataka_tpu.core.solvers import solve_nullspace

DEFAULT_TRIALS = 128
MIN_CORRESPONDENCES = 6
EPNP_SAMPLES = 5
GN_ITERATIONS = 15


def calc_reprojection_threshold(keypoints, k=3.0, mask=None):
    """k * rms-distance-from-centroid / n (pose.py:67-73).

    ``mask`` restricts the statistic to valid rows (callers pad keypoint
    batches to static capacities)."""
    if mask is None:
        n = jnp.asarray(keypoints.shape[0], keypoints.dtype)
        w = jnp.ones(keypoints.shape[0], keypoints.dtype)
    else:
        w = mask.astype(keypoints.dtype)
        n = jnp.maximum(jnp.sum(w), 1.0)
    center = (jnp.sum(keypoints * w[:, None], axis=0, keepdims=True) / n)
    sq = jnp.sum((keypoints - center) ** 2, axis=1) * w
    rms = jnp.sqrt(jnp.sum(sq) / n)
    return k * rms / n


def _dlt_pose(points, keypoints):
    """DLT camera-matrix fit from n >= 6 correspondences, orthogonalized.

    points: (n, 3), keypoints: (n, 2) normalized.  Returns (R, t).
    """
    n = points.shape[0]
    X = jnp.concatenate([points, jnp.ones((n, 1), points.dtype)], axis=-1)
    zeros = jnp.zeros_like(X)
    x, y = keypoints[:, 0:1], keypoints[:, 1:2]
    rows_x = jnp.concatenate([X, zeros, -x * X], axis=-1)   # (n, 12)
    rows_y = jnp.concatenate([zeros, X, -y * X], axis=-1)
    A = jnp.concatenate([rows_x, rows_y], axis=0)
    p = solve_nullspace(A)
    P = p.reshape(3, 4)

    M = P[:, :3]
    # nearest rotation: project M onto SO(3), recover scale from singulars
    U, s, Vt = jnp.linalg.svd(M)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]).at[2].set(d))
    R = U @ D @ Vt
    scale = jnp.mean(s) * d
    t = P[:, 3] / (scale + 1e-12)
    # resolve the global sign so points land in front of the camera
    depths = points @ R[2] + t[2]
    flip = jnp.sum(jnp.sign(depths)) < 0
    return R, jnp.where(flip, -t, t)


def _reprojection_errors(R, t, points, keypoints):
    P = points @ R.T + t
    pred = pi(P)
    err = jnp.linalg.norm(pred - keypoints, axis=-1)
    behind = P[:, 2] <= 0
    return jnp.where(behind, jnp.inf, err)


def _refine_gauss_newton(R, t, points, keypoints, weights, n_iter):
    """Masked GN on (rotvec-increment, t) minimizing reprojection error."""

    def residuals(dw, dt, R, t):
        Rk = exp_so3(dw) @ R
        P = points @ Rk.T + (t + dt)
        return (pi(P) - keypoints).ravel()

    def body(_, state):
        R, t = state
        zero = jnp.zeros(3, dtype=t.dtype)

        J = jax.jacfwd(lambda p: residuals(p[:3], p[3:], R, t))(
            jnp.concatenate([zero, zero]))
        r = residuals(zero, zero, R, t)
        w = jnp.repeat(weights, 2)
        Jw = J * w[:, None]
        JtJ = Jw.T @ J + 1e-9 * jnp.eye(6, dtype=t.dtype)
        delta = jnp.linalg.solve(JtJ, -(Jw.T @ r))
        R_new = exp_so3(delta[:3]) @ R
        t_new = t + delta[3:]
        return R_new, t_new

    return jax.lax.fori_loop(0, n_iter, body, (R, t))


@partial(jax.jit, static_argnames=("n_trials", "method"))
def solve_pnp_ransac(points, keypoints, mask, key,
                     reprojection_threshold=None, n_trials=DEFAULT_TRIALS,
                     method="epnp"):
    """RANSAC + GN refinement.  Returns (Pose, inlier_mask).

    method: "epnp" (5-point minimal samples, the reference's cv2 EPnP
    flag, pose.py:85), "p3p" (3-point Grunert minimal solver + 4th-point
    disambiguation — the smallest sample, most outlier-robust trials), or
    "dlt" (6-point DLT camera-matrix fit).
    """
    from tadataka_tpu.features.ransac import _sample_valid_indices
    from tadataka_tpu.pose_estimation.epnp import epnp_pose
    from tadataka_tpu.pose_estimation.p3p import p3p_best_pose

    if reprojection_threshold is None:
        reprojection_threshold = calc_reprojection_threshold(keypoints,
                                                             mask=mask)

    if method == "epnp":
        fit, n_samples = epnp_pose, EPNP_SAMPLES
    elif method == "p3p":
        fit, n_samples = p3p_best_pose, 4
    elif method == "dlt":
        fit, n_samples = _dlt_pose, MIN_CORRESPONDENCES
    else:
        raise ValueError(f"unknown PnP method: {method}")

    samples = _sample_valid_indices(key, mask, n_trials, n_samples)

    def trial(sample_idx):
        R, t = fit(points[sample_idx], keypoints[sample_idx])
        err = _reprojection_errors(R, t, points, keypoints)
        inliers = mask & (err < reprojection_threshold)
        return R, t, jnp.sum(inliers)

    Rs, ts, counts = jax.vmap(trial)(samples)
    best = jnp.argmax(counts)
    R, t = Rs[best], ts[best]

    err = _reprojection_errors(R, t, points, keypoints)
    inliers = mask & (err < reprojection_threshold)
    weights = inliers.astype(points.dtype)
    R, t = _refine_gauss_newton(R, t, points, keypoints, weights,
                                GN_ITERATIONS)
    err = _reprojection_errors(R, t, points, keypoints)
    inliers = mask & (err < reprojection_threshold)
    return Pose(R, t), inliers


def solve_pnp(points, keypoints, mask=None, key=None,
              reprojection_threshold=None):
    """Reference-shaped entry point (pose.py:76-99): raises on too few
    correspondences, returns the Pose.

    The reference's adaptive threshold (3 * rms / n) shrinks as the
    correspondence count grows — with hundreds of matches it starves the
    consensus set, so callers may pass an explicit threshold.
    """
    points = jnp.asarray(points)
    keypoints = jnp.asarray(keypoints)
    if mask is None:
        mask = jnp.ones(points.shape[0], dtype=bool)
    if key is None:
        key = jax.random.PRNGKey(3939)

    n = int(jnp.sum(mask))
    if n < MIN_CORRESPONDENCES:
        from tadataka_tpu.utils.exceptions import NotEnoughInliersException
        raise NotEnoughInliersException("No sufficient correspondences")

    pose, inliers = solve_pnp_ransac(
        points, keypoints, mask, key,
        reprojection_threshold=reprojection_threshold)
    if int(jnp.sum(inliers)) == 0:
        from tadataka_tpu.utils.exceptions import NotEnoughInliersException
        raise NotEnoughInliersException("No inliers found")
    return pose


def solve_pnp_packed(points, keypoints, mask_np, key=None,
                     reprojection_threshold=None):
    """`solve_pnp` with ZERO device syncs: the correspondence count comes
    from the caller's HOST-side mask, and the result is one packed (13,)
    device vector [R.ravel(), t, n_inliers] the caller fetches in a
    single round trip (each `int(jnp.sum(...))` in `solve_pnp` is a
    device->host round trip).  Raises only on the host-checkable
    too-few-correspondences case; the caller must treat a fetched
    n_inliers of 0 as NotEnoughInliers.
    """
    import numpy as _np
    n = int(_np.sum(mask_np))
    if n < MIN_CORRESPONDENCES:
        from tadataka_tpu.utils.exceptions import NotEnoughInliersException
        raise NotEnoughInliersException("No sufficient correspondences")
    if key is None:
        key = jax.random.PRNGKey(3939)
    pose, inliers = solve_pnp_ransac(
        jnp.asarray(points), jnp.asarray(keypoints), jnp.asarray(mask_np),
        key, reprojection_threshold=reprojection_threshold)
    return jnp.concatenate(
        [pose.R.ravel(), pose.t,
         jnp.sum(inliers).astype(jnp.float32)[None]])
