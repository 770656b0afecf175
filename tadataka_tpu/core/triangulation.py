"""Triangulation: closed-form two-view depth and batched DLT.

Parity surface: /root/reference/src/triangulation.rs:8-36 (calc_depth0 with
axis selection by the larger |t| component) and
/root/reference/tadataka/triangulation.py (N-view DLT, per-point SVD loop).

Design: the reference triangulates point-by-point in a Python loop; here
the (n_points, 2*n_views, 4) DLT stack goes through one batched SVD.
"""

import jax.numpy as jnp

from tadataka_tpu.core.transforms import (
    to_homogeneous, get_rotation, get_translation)

EPSILON = 1e-16


def calc_depth0(T10, x0, x1):
    """Closed-form depth of x0 given relative transform T10 and match x1.

    x0, x1: (..., 2) normalized coords.  Axis i is chosen per the larger
    |t10| component (a static choice in the reference, a where-select here).
    """
    R = get_rotation(T10)
    t = get_translation(T10)
    y0 = to_homogeneous(x0)  # (..., 3)

    def depth_along(i):
        n = t[i] - t[2] * x1[..., i]
        d = (y0 @ R[2]) * x1[..., i] - (y0 @ R[i])
        return n / (d + EPSILON)

    use_x = jnp.abs(t[0]) > jnp.abs(t[1])
    return jnp.where(use_x, depth_along(0), depth_along(1))


def calc_depth0_poses(pose_w0, pose_w1, x0, x1):
    """calc_depth0 from world poses (parity: tadataka/triangulation.py:162)."""
    T10 = (pose_w1.inv() * pose_w0).T
    return calc_depth0(T10, x0, x1)


def linear_triangulation(rotations, translations, keypoints):
    """Batched N-view DLT triangulation.

    Args:
        rotations: (n_views, 3, 3) world->camera rotations
        translations: (n_views, 3)
        keypoints: (n_views, n_points, 2) normalized observations
    Returns:
        points: (n_points, 3) world points (inf where degenerate)
        depths: (n_views, n_points) per-view depths (nan where degenerate)
    """
    V = rotations.shape[0]
    N = keypoints.shape[1]

    # A rows per view v: [x_v * R_v[2] - R_v[0] | x_v * t_v[2] - t_v[0]]
    #                    [y_v * R_v[2] - R_v[1] | y_v * t_v[2] - t_v[1]]
    r2 = rotations[:, 2]                     # (V, 3)
    t2 = translations[:, 2]                  # (V,)
    kp = jnp.moveaxis(keypoints, 1, 0)       # (N, V, 2)

    rows_xy = (kp[..., None] * r2[None, :, None, :]
               - rotations[None, :, :2, :])  # (N, V, 2, 3)
    cols = (kp * t2[None, :, None]
            - translations[None, :, :2])     # (N, V, 2)
    A = jnp.concatenate([rows_xy, cols[..., None]], axis=-1)  # (N, V, 2, 4)
    A = A.reshape(N, 2 * V, 4)

    # smallest right singular vector per point — one batched SVD
    _, _, vh = jnp.linalg.svd(A)
    X = vh[:, -1, :]                         # (N, 4)

    w = X[:, 3]
    degenerate = jnp.abs(w) < 1e-12
    safe_w = jnp.where(degenerate, 1.0, w)
    points = X[:, :3] / safe_w[:, None]
    points = jnp.where(degenerate[:, None], jnp.inf, points)

    depths = (jnp.einsum('vd,nd->vn', r2, points)
              + t2[:, None])                 # (V, N)
    depths = jnp.where(degenerate[None, :], jnp.nan, depths)
    return points, depths


def two_view_triangulation(pose0w, pose1w, keypoints0, keypoints1):
    """Triangulate matches across two views (poses are world->camera).

    Parity: TwoViewTriangulation (/root/reference/tadataka/triangulation.py:87).
    """
    rotations = jnp.stack([pose0w.R, pose1w.R])
    translations = jnp.stack([pose0w.t, pose1w.t])
    keypoints = jnp.stack([keypoints0, keypoints1])
    return linear_triangulation(rotations, translations, keypoints)


def pairwise_triangulation(R0, t0, R1, t1, keypoints0, keypoints1):
    """Two-view DLT with a DIFFERENT first pose per row: R0/t0 are
    (N, 3, 3)/(N, 3) world->camera, R1/t1 shared (3, 3)/(3,).

    The feature-VO driver triangulates fresh matches against several
    keyframes at once; one batched program over all of them replaces one
    dispatch per keyframe.
    Returns (points (N, 3), depths (2, N)) like `two_view_triangulation`.
    """
    N = keypoints0.shape[0]

    def rows(R, t, kp):
        r2 = R[:, 2, :]                                  # (N, 3)
        t2 = t[:, 2]
        rows_xy = (kp[..., None] * r2[:, None, :]
                   - R[:, :2, :])                        # (N, 2, 3)
        cols = kp * t2[:, None] - t[:, :2]               # (N, 2)
        return jnp.concatenate([rows_xy, cols[..., None]], axis=-1)

    R1b = jnp.broadcast_to(R1, (N, 3, 3))
    t1b = jnp.broadcast_to(t1, (N, 3))
    A = jnp.concatenate([rows(R0, t0, keypoints0),
                         rows(R1b, t1b, keypoints1)], axis=1)  # (N, 4, 4)
    _, _, vh = jnp.linalg.svd(A)
    X = vh[:, -1, :]
    w = X[:, 3]
    degenerate = jnp.abs(w) < 1e-12
    safe_w = jnp.where(degenerate, 1.0, w)
    points = X[:, :3] / safe_w[:, None]
    points = jnp.where(degenerate[:, None], jnp.inf, points)
    d0 = jnp.einsum('nd,nd->n', R0[:, 2, :], points) + t0[:, 2]
    d1 = points @ R1[2] + t1[2]
    depths = jnp.stack([d0, d1])
    return points, jnp.where(degenerate[None, :], jnp.nan, depths)


def depths_from_triangulation(pose0, pose1, keypoint0, keypoint1):
    """Solve [R0^T y0 | -R1^T y1] d = R0^T t0 - R1^T t1 for (depth0, depth1).

    Parity: DepthsFromTriangulation (/root/reference/tadataka/triangulation.py:125).
    Closed-form 3x2 least squares via normal equations.
    """
    y0 = to_homogeneous(keypoint0)
    y1 = to_homogeneous(keypoint1)
    a0 = pose0.R.T @ y0
    a1 = -(pose1.R.T @ y1)
    A = jnp.stack([a0, a1], axis=-1)         # (3, 2)
    b = pose0.R.T @ pose0.t - pose1.R.T @ pose1.t
    AtA = A.T @ A
    Atb = A.T @ b
    return jnp.linalg.solve(AtA, Atb)


def compute_depth_mask(depths, min_depth=0.0):
    """All-views-positive depth mask (parity: tadataka/depth.py:17)."""
    return jnp.all(depths > min_depth, axis=0)


def depth_condition(depth_mask, positive_depth_ratio=0.8):
    """True when >= ratio of points have positive depth everywhere."""
    return jnp.mean(depth_mask.astype(jnp.float32)) >= positive_depth_ratio
