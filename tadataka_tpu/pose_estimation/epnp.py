"""EPnP: Efficient Perspective-n-Point (Lepetit/Moreno-Noguer/Fua, IJCV'09).

Parity surface: the reference's ``solve_pnp`` delegates to
``cv2.solvePnPRansac(..., flags=cv2.SOLVEPNP_EPNP)``
(/root/reference/tadataka/pose.py:85) — this module replaces the OpenCV
EPnP solver with a static-shape array one.

Design: everything is fixed-shape linear algebra — one 4x4 (or 2x2)
solve for the barycentric coordinates, one 12x12 (or 9x9) symmetric
eigendecomposition for the camera-frame control points, and a Kabsch
alignment for (R, t).  Two hypothesis branches run unconditionally
(general 4-control-point and planar 3-control-point) and a reprojection
scoreboard picks the winner with ``lax.select`` — no data-dependent
branching, so the whole solver vmaps across RANSAC trials.

Keypoints are NORMALIZED image coordinates (K = I), as everywhere in this
framework.
"""

import jax.numpy as jnp

from tadataka_tpu.core.projection import pi

_EPS = 1e-12


def _kabsch(P_world, P_cam):
    """Rigid (R, t) minimizing ||R p_w + t - p_c||^2 (no scale)."""
    mean_w = jnp.mean(P_world, axis=0)
    mean_c = jnp.mean(P_cam, axis=0)
    X = P_world - mean_w
    Y = P_cam - mean_c
    S = X.T @ Y
    U, _, VT = jnp.linalg.svd(S)
    V = VT.T
    d = jnp.sign(jnp.linalg.det(V @ U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], S.dtype).at[2].set(d))
    R = V @ D @ U.T
    t = mean_c - R @ mean_w
    return R, t


def _solve_control_points(alphas, keypoints, n_ctrl):
    """Two smallest-eigenvector candidates of the EPnP M-matrix.

    alphas: (n, n_ctrl) barycentric coords; keypoints: (n, 2) normalized.
    Returns (2, n_ctrl, 3): nullvectors v1, v2 (ascending eigenvalue).
    """
    u = keypoints[:, 0:1]
    v = keypoints[:, 1:2]
    zeros = jnp.zeros_like(alphas)
    # rows: [a_j, 0, -a_j u] and [0, a_j, -a_j v] per control point j,
    # interleaved into 3*n_ctrl columns
    rows_x = jnp.stack([alphas, zeros, -alphas * u], axis=-1)  # (n, c, 3)
    rows_y = jnp.stack([zeros, alphas, -alphas * v], axis=-1)
    M = jnp.concatenate([rows_x.reshape(-1, 3 * n_ctrl),
                         rows_y.reshape(-1, 3 * n_ctrl)], axis=0)
    MtM = M.T @ M
    _, V = jnp.linalg.eigh(MtM)
    return V[:, :2].T.reshape(2, n_ctrl, 3)


def _beta_n2(ctrl_w, v1, v2):
    """N=2 beta case (IJCV'09 §3.3): solve the linearized pairwise-distance
    system for [b11, b12, b22] = [β1², β1β2, β2²], recover (β1, β2)."""
    iu, ju = jnp.triu_indices(ctrl_w.shape[0], k=1)
    dw = ctrl_w[iu] - ctrl_w[ju]          # (p, 3)
    d1 = v1[iu] - v1[ju]
    d2 = v2[iu] - v2[ju]
    # ||β1 d1 + β2 d2||² = ||dw||²  →  L [b11 b12 b22]ᵀ = ρ
    L = jnp.stack([jnp.sum(d1 * d1, -1),
                   2.0 * jnp.sum(d1 * d2, -1),
                   jnp.sum(d2 * d2, -1)], axis=-1)  # (p, 3)
    rho = jnp.sum(dw * dw, -1)
    b = jnp.linalg.solve(L.T @ L + _EPS * jnp.eye(3, dtype=L.dtype),
                         L.T @ rho)
    # sign convention: β1 >= 0; β2 carries the sign of β1β2
    b1 = jnp.sqrt(jnp.maximum(b[0], 0.0))
    b2 = jnp.sqrt(jnp.maximum(b[2], 0.0)) * jnp.where(b[1] < 0, -1.0, 1.0)
    return b1 * v1 + b2 * v2


def _scale_and_sign(ctrl_w, ctrl_c, alphas):
    """Resolve the nullvector's scale (pairwise-distance ratio, IJCV'09
    eq. 11 beta case N=1) and sign (cheirality: points in front)."""
    iu, ju = jnp.triu_indices(ctrl_w.shape[0], k=1)
    dw = ctrl_w[iu] - ctrl_w[ju]
    dc = ctrl_c[iu] - ctrl_c[ju]
    nw = jnp.linalg.norm(dw, axis=-1)
    nc = jnp.linalg.norm(dc, axis=-1)
    beta = jnp.sum(nc * nw) / (jnp.sum(nc * nc) + _EPS)
    ctrl_c = beta * ctrl_c
    z = (alphas @ ctrl_c)[:, 2]
    flip = jnp.sum(jnp.sign(z)) < 0
    return jnp.where(flip, -ctrl_c, ctrl_c)


def _epnp_candidates(ctrl_w, alphas, points, keypoints):
    """(R, t, err) for the N=1 and N=2 beta cases of one control layout."""
    vs = _solve_control_points(alphas, keypoints, ctrl_w.shape[0])
    cands = [vs[0], _beta_n2(ctrl_w, vs[0], vs[1])]
    out = []
    for ctrl_c in cands:
        ctrl_c = _scale_and_sign(ctrl_w, ctrl_c, alphas)
        R, t = _kabsch(points, alphas @ ctrl_c)
        out.append((R, t, _mean_reprojection_error(R, t, points, keypoints)))
    return out


def _epnp_general(points, keypoints):
    """4 control points: centroid + scaled principal axes."""
    n = points.shape[0]
    c0 = jnp.mean(points, axis=0)
    X = points - c0
    cov = X.T @ X / n
    w, V = jnp.linalg.eigh(cov)  # ascending
    # guard degenerate axes so the barycentric system stays invertible;
    # the planar branch handles truly flat scenes
    scale = jnp.sqrt(jnp.maximum(w, 1e-6 * (w[2] + _EPS)))
    ctrl_w = jnp.concatenate(
        [c0[None], c0[None] + scale[:, None] * V.T], axis=0)  # (4, 3)

    C = jnp.concatenate([ctrl_w.T, jnp.ones((1, 4), points.dtype)], axis=0)
    Pext = jnp.concatenate([points.T, jnp.ones((1, n), points.dtype)],
                           axis=0)
    alphas = jnp.linalg.solve(C, Pext).T  # (n, 4)
    return _epnp_candidates(ctrl_w, alphas, points, keypoints)


def _epnp_planar(points, keypoints):
    """3 control points (centroid + two in-plane axes) for flat scenes."""
    c0 = jnp.mean(points, axis=0)
    X = points - c0
    cov = X.T @ X / points.shape[0]
    w, V = jnp.linalg.eigh(cov)
    # two largest principal axes span the plane
    a1 = jnp.sqrt(jnp.maximum(w[2], _EPS)) * V[:, 2]
    a2 = jnp.sqrt(jnp.maximum(w[1], _EPS)) * V[:, 1]
    ctrl_w = jnp.stack([c0, c0 + a1, c0 + a2])  # (3, 3)

    # in-plane coordinates: p = c0 + b1 a1 + b2 a2
    B = jnp.stack([a1, a2], axis=-1)  # (3, 2)
    coeff = jnp.linalg.solve(B.T @ B + _EPS * jnp.eye(2, dtype=B.dtype),
                             B.T @ X.T).T  # (n, 2)
    alphas = jnp.concatenate(
        [1.0 - coeff[:, 0:1] - coeff[:, 1:2], coeff], axis=-1)  # (n, 3)
    return _epnp_candidates(ctrl_w, alphas, points, keypoints)


def _mean_reprojection_error(R, t, points, keypoints):
    P = points @ R.T + t
    err = jnp.linalg.norm(pi(P) - keypoints, axis=-1)
    err = jnp.where(P[:, 2] <= 0, 1e6, err)
    err = jnp.mean(err)
    # a degenerate branch (e.g. the general layout on an exactly-planar
    # scene, where the barycentric solve blows up in f32) must not
    # hijack the argmin with NaN
    return jnp.where(jnp.isfinite(err), err, 1e9)


def epnp_pose(points, keypoints):
    """EPnP estimate from n >= 5 correspondences.

    points: (n, 3) world, keypoints: (n, 2) normalized.  Returns (R, t).
    Four candidates are solved unconditionally — {general 4-control-point,
    planar 3-control-point} x {beta case N=1, N=2} — and the lowest mean
    reprojection error wins (branch-free select, vmappable).

    Note: camera-frame points are reconstructed as ``alphas @ ctrl_c`` and
    aligned to the world points by Kabsch — more robust than aligning the
    control points themselves when the nullvector mixes modes.
    """
    cands = _epnp_general(points, keypoints) + _epnp_planar(points,
                                                            keypoints)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    errs = jnp.stack([c[2] for c in cands])
    best = jnp.argmin(errs)
    return Rs[best], ts[best]
