"""Two-view relative pose from the essential matrix.

Parity surface: /root/reference/tadataka/matrix.py:104-149 (8-point
fundamental via nullspace, E decomposition Eq. 9.14) and
/root/reference/tadataka/pose.py:104-170 (cheirality vote over the four
(R, t) candidates using triangulated-depth positivity).

Design: all four candidates triangulate a fixed-size point subset in one
batched DLT; the vote is an argmax — no itertools, no python branching.
"""

import jax
from functools import partial
import jax.numpy as jnp

from tadataka_tpu.core.pose import Pose
from tadataka_tpu.core.solvers import solve_nullspace
from tadataka_tpu.core.triangulation import linear_triangulation

_W = jnp.array([[0.0, -1.0, 0.0],
                [1.0, 0.0, 0.0],
                [0.0, 0.0, 1.0]])


def _masked_hartley(points, mask):
    w = mask.astype(points.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(points * w[:, None], axis=0) / n
    centered = points - mean
    dist = jnp.linalg.norm(centered, axis=1) * w
    scale = jnp.sqrt(2.0) / (jnp.sum(dist) / n + 1e-12)
    T = jnp.array([[scale, 0.0, -scale * mean[0]],
                   [0.0, scale, -scale * mean[1]],
                   [0.0, 0.0, 1.0]], dtype=points.dtype)
    return centered * scale, T


def estimate_fundamental(keypoints0, keypoints1, mask=None):
    """Masked, Hartley-normalized least-squares 8-point fundamental matrix.

    On normalized image coordinates this is the essential matrix
    (the reference calls estimate_fundamental on normalized keypoints,
    pose.py:162; skimage's FundamentalMatrixTransform also normalizes —
    in f32 the conditioning is not optional).
    """
    if mask is None:
        mask = jnp.ones(keypoints0.shape[0], dtype=bool)
    p0, T0 = _masked_hartley(keypoints0, mask)
    p1, T1 = _masked_hartley(keypoints1, mask)
    x0, y0 = p0[:, 0], p0[:, 1]
    x1, y1 = p1[:, 0], p1[:, 1]
    ones = jnp.ones_like(x0)
    A = jnp.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                   x0, y0, ones], axis=-1)
    A = A * mask.astype(A.dtype)[:, None]
    F = solve_nullspace(A).reshape(3, 3)
    # enforce rank 2 before denormalizing (skimage does the same)
    U, s, Vt = jnp.linalg.svd(F)
    F = (U * s.at[2].set(0.0)[None, :]) @ Vt
    return T1.T @ F @ T0


def fundamental_to_essential(F, K0, K1=None):
    if K1 is None:
        K1 = K0
    return K1.T @ F @ K0


def decompose_essential(E):
    """E -> (R1, R2, t1, t2) candidate rotations/translations (Eq. 9.14)."""
    U, _, VH = jnp.linalg.svd(E)
    U = jnp.where(jnp.linalg.det(U) < 0, -U, U)
    VH = jnp.where(jnp.linalg.det(VH) < 0, -VH, VH)

    R1 = U @ _W @ VH
    R2 = U @ _W.T @ VH

    S = -U @ _W @ jnp.diag(jnp.array([1.0, 1.0, 0.0])) @ U.T
    t1 = jnp.stack([S[2, 1], S[0, 2], S[1, 0]])
    t2 = -t1
    return R1, R2, t1, t2


def select_valid_pose(R1A, R1B, t1a, t1b, keypoints0, keypoints1, mask=None):
    """Cheirality vote: the candidate (R, t) putting the most triangulated
    points in front of both cameras wins (pose.py:119-147)."""
    n = keypoints0.shape[0]
    if mask is None:
        mask = jnp.ones(n, dtype=bool)

    R0 = jnp.eye(3, dtype=keypoints0.dtype)
    t0 = jnp.zeros(3, dtype=keypoints0.dtype)

    def count_valid(R_, t_):
        rotations = jnp.stack([R0, R_])
        translations = jnp.stack([t0, t_])
        keypoints = jnp.stack([keypoints0, keypoints1])
        _, depths = linear_triangulation(rotations, translations, keypoints)
        all_positive = jnp.all(depths > 0.0, axis=0)
        return jnp.sum(jnp.where(mask, all_positive, False))

    candidates = [(R1A, t1a), (R1A, t1b), (R1B, t1a), (R1B, t1b)]
    counts = jnp.stack([count_valid(R_, t_) for R_, t_ in candidates])
    best = jnp.argmax(counts)
    Rs = jnp.stack([c[0] for c in candidates])
    ts = jnp.stack([c[1] for c in candidates])
    return Rs[best], ts[best]


@jax.jit
def estimate_pose_change_lstsq(keypoints0, keypoints1, mask=None):
    """All-inlier least-squares variant (the reference's exact recipe,
    pose.py:150-168) — sensitive to structured detector noise."""
    E = estimate_fundamental(keypoints0, keypoints1, mask)
    R1A, R1B, t1a, t1b = decompose_essential(E)
    R, t = select_valid_pose(R1A, R1B, t1a, t1b,
                             keypoints0, keypoints1, mask)
    return Pose(R, t)


@partial(jax.jit, static_argnames=("n_trials",))
def _estimate_pose_change_ransac(keypoints0, keypoints1, mask, key,
                                 residual_threshold, n_trials):
    from tadataka_tpu.features.ransac import ransac_fundamental
    _, inliers = ransac_fundamental(
        keypoints0, keypoints1, mask, key,
        residual_threshold=residual_threshold, n_trials=n_trials)
    # refit on the consensus set
    E = estimate_fundamental(keypoints0, keypoints1, inliers)
    R1A, R1B, t1a, t1b = decompose_essential(E)
    R, t = select_valid_pose(R1A, R1B, t1a, t1b,
                             keypoints0, keypoints1, inliers)
    return Pose(R, t), inliers


def estimate_pose_change(keypoints0, keypoints1, mask=None, key=None,
                         residual_threshold=0.002, n_trials=256):
    """Pose such that x1 = project(pose.R @ X0 + pose.t) up to scale.

    keypoints are normalized image coordinates.  RANSAC + inlier refit
    (the reference's plain least squares on every match, pose.py:162, is
    not robust to the structured noise of real detections; RANSAC is the
    upgrade every production VO makes here).
    """
    if mask is None:
        mask = jnp.ones(keypoints0.shape[0], dtype=bool)
    if key is None:
        key = jax.random.PRNGKey(3939)
    pose, _ = _estimate_pose_change_ransac(
        jnp.asarray(keypoints0), jnp.asarray(keypoints1), mask, key,
        residual_threshold, n_trials)
    return pose
