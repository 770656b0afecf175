"""High-level BA entry points used by the feature-based VO orchestrator.

Parity surface: run_ba / try_run_ba / can_run_ba
(/root/reference/tadataka/local_ba.py:137-178 and the sparseba guard).
"""

import warnings

import numpy as np
import jax.numpy as jnp

from tadataka_tpu.core.pose import Pose
from tadataka_tpu.ba.schur import lm_solve


def can_run_ba(n_viewpoints, n_points, n_visible,
               n_pose_params=6, n_point_params=3):
    """Gauge condition: at least as many residual rows as unknowns."""
    n_rows = 2 * n_visible
    n_cols = n_pose_params * n_viewpoints + n_point_params * n_points
    return n_rows >= n_cols


def test_unique(viewpoint_indices, point_indices):
    A = np.vstack((viewpoint_indices, point_indices))
    assert np.unique(A, axis=1).shape[1] == A.shape[1]


def run_ba(viewpoint_indices, point_indices, poses, points, keypoints_true,
           max_iter=5, relative_error_threshold=0.20):
    """Optimize a window of Pose objects + 3D points.

    Mirrors run_ba (local_ba.py:137-152): max 5 LM iterations, loose
    relative threshold — BA here is a refinement step inside the VO loop.

    Observations and points are padded to power-of-two capacities with
    zero-weight rows so the jitted LM program compiles O(log max_count)
    times per run instead of every frame (padded points receive no
    observations; LM damping keeps their Schur blocks invertible and
    their garbage updates are sliced away).
    """
    from scipy.spatial.transform import Rotation

    from tadataka_tpu.utils.padding import pow2_cap, pad_rows

    # numpy-side packing: stacking a VARIABLE number of poses with jnp
    # would compile a new concatenate per window size.  The per-pose
    # log/exp maps run through scipy on the HOST — a device log_so3 per
    # pose costs a dispatch + fetch round trip each, 2M round trips per BA
    # call.
    Rs = np.stack([np.asarray(p.R) for p in poses])
    rotvecs = Rotation.from_matrix(Rs).as_rotvec()
    ts = np.stack([np.asarray(p.t) for p in poses])
    pose_params = np.concatenate([rotvecs, ts], axis=-1).astype(np.float32)

    n_obs = len(keypoints_true)
    n_pts = len(points)
    n_poses = len(poses)
    obs_cap = pow2_cap(n_obs)
    pts_cap = pow2_cap(n_pts)
    pose_cap = pow2_cap(n_poses, lo=4)    # window sizes bucket to {4, 8, ...}
    weights = pad_rows(np.ones(n_obs, np.float32), obs_cap, 0.0)
    vi = pad_rows(np.asarray(viewpoint_indices, np.int32), obs_cap, 0)
    pi_ = pad_rows(np.asarray(point_indices, np.int32), obs_cap, 0)
    x_true = pad_rows(np.asarray(keypoints_true, np.float32), obs_cap, 0.0)
    pts = pad_rows(np.asarray(points, np.float32), pts_cap, 1.0)
    pose_params = pad_rows(pose_params, pose_cap, 0.0)

    new_params, new_points, _ = lm_solve(
        jnp.asarray(pose_params), jnp.asarray(pts),
        jnp.asarray(vi), jnp.asarray(pi_), jnp.asarray(x_true),
        weights=jnp.asarray(weights),
        max_iter=max_iter,
        absolute_error_threshold=1e-9,
        relative_error_threshold=relative_error_threshold)

    # ONE fetch for both outputs, host-side exp map
    n_pose_vals = int(new_params.size)
    flat = np.asarray(jnp.concatenate([new_params.ravel(),
                                       new_points.ravel()]))
    new_params = flat[:n_pose_vals].reshape(-1, 6)
    new_points = flat[n_pose_vals:].reshape(-1, 3)[:n_pts]
    new_poses = [Pose(Rotation.from_rotvec(new_params[j, :3]).as_matrix()
                      .astype(np.float32), new_params[j, 3:])
                 for j in range(n_poses)]
    return new_poses, new_points


def try_run_ba(viewpoint_indices, point_indices, poses, points,
               keypoints_true):
    """Guarded BA (local_ba.py:160-178)."""
    assert len(viewpoint_indices) == len(point_indices)
    assert len(set(int(v) for v in viewpoint_indices)) == len(poses)
    assert len(set(int(v) for v in point_indices)) == len(points)
    test_unique(viewpoint_indices, point_indices)

    if not can_run_ba(n_viewpoints=len(poses), n_points=len(points),
                      n_visible=len(keypoints_true)):
        warnings.warn("Arguments are not satisfying condition to run BA",
                      RuntimeWarning)
        return poses, points

    return run_ba(viewpoint_indices, point_indices, poses, points,
                  keypoints_true)
