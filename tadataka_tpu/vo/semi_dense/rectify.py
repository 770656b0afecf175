"""Stereo rectification for the semi-dense plane sweep.

Factorizes the epipolar sampling warp (reference:
/root/reference/src/semi_dense/epipolar.rs:38-54) into the one structure
that runs as plain vector work:

    per-pair rotation warp (bounded displacement, gather-free)
      + per-plane constant horizontal shift (a slice)

Fusiello-style rectification: rotate both cameras so their x-axes align
with the baseline.  In the rectified pair every epipolar line is a
horizontal scanline, corresponding rows are equal, and the correspondence
of key pixel (x, y) at inverse depth q sits at (x - fB q, y) in the
rectified ref image — disparity is LINEAR in inverse depth, so the
reference's +-2 sigma inverse-depth search range (hypothesis.rs:15) maps
to a per-pixel disparity window and the epipolar search becomes a classic
stereo sweep (vo/semi_dense/sweep_rect.py).

Degenerate regime: a baseline nearly orthogonal to the image x-axis
(forward or vertical motion) needs a large rectifying rotation whose
displacement exceeds the shift-warp budget; `rectification_feasible`
detects this on the host and callers fall back to the scattered-gather
estimator (estimator.py::update_depth).
"""

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

EPSILON = 1e-16


class Rectification(NamedTuple):
    """Device-side rectification of one (key, ref) pair.

    H_key / H_ref map original key / ref pixels to UNFLIPPED rectified
    pixels; the inverses map back.  Disparity at inverse KEY depth q is
    per-pixel LINEAR: d(x, q) = fB * v_z(x) * q, where
    v_z(x) = r1_z x~ + r2_z y~ + r3_z on the rectified normalized grid
    (= Z_key / Z_rect, the depth re-projection factor of the rectifying
    rotation; identically 1 for a pure-stereo pair).  ``vz`` holds
    (r1_z, r2_z, r3_z); ``fB`` is rect_focal_x * baseline.  The static
    x-flip chosen by the host (baseline toward -x) keeps d >= 0.
    """
    H_key: jnp.ndarray
    H_ref: jnp.ndarray
    H_key_inv: jnp.ndarray
    H_ref_inv: jnp.ndarray
    fB: jnp.ndarray
    vz: jnp.ndarray


def _K(focal, offset, dtype):
    return jnp.array([[focal[0], 0.0, offset[0]],
                      [0.0, focal[1], offset[1]],
                      [0.0, 0.0, 1.0]], dtype)


def _K_inv(focal, offset, dtype):
    return jnp.array([[1.0 / focal[0], 0.0, -offset[0] / focal[0]],
                      [0.0, 1.0 / focal[1], -offset[1] / focal[1]],
                      [0.0, 0.0, 1.0]], dtype)


def make_rectification(T_rk, key_focal, key_offset, ref_focal, ref_offset,
                       flip: bool) -> Rectification:
    """Build the rectifying homographies for one pair (jittable).

    T_rk: 4x4 rigid transform, P_ref = R P_key + t.  ``flip`` (static,
    from `baseline_flip`) selects the baseline sign so the rectifying
    rotation stays small; the caller applies the corresponding x-flip to
    the rectified images to keep disparity = +fB q.
    """
    dtype = T_rk.dtype
    R_rk = T_rk[:3, :3]
    t_rk = T_rk[:3, 3]
    b = -R_rk.T @ t_rk                       # ref camera center in key frame
    B = jnp.linalg.norm(b) + EPSILON
    sgn = -1.0 if flip else 1.0
    r1 = sgn * b / B
    z = jnp.array([0.0, 0.0, 1.0], dtype)
    r2 = jnp.cross(z, r1)
    r2 = r2 / (jnp.linalg.norm(r2) + EPSILON)
    r3 = jnp.cross(r1, r2)
    R_new = jnp.stack([r1, r2, r3])          # key-frame coords -> rect coords

    K_rect = _K(key_focal, key_offset, dtype)
    H_key = K_rect @ R_new @ _K_inv(key_focal, key_offset, dtype)
    H_ref = K_rect @ R_new @ R_rk.T @ _K_inv(ref_focal, ref_offset, dtype)
    return Rectification(
        H_key=H_key, H_ref=H_ref,
        H_key_inv=jnp.linalg.inv(H_key), H_ref_inv=jnp.linalg.inv(H_ref),
        fB=key_focal[0] * B,
        vz=jnp.stack([r1[2], r2[2], r3[2]]))


def baseline_flip(T_rk_np) -> bool:
    """Host-side: True when the baseline points toward -x, so the caller
    must pass flip=True and x-flip the rectified images."""
    R = np.asarray(T_rk_np)[:3, :3]
    t = np.asarray(T_rk_np)[:3, 3]
    b = -R.T @ t
    return bool(b[0] < 0.0)


def _np_homography_displacement(H33, image_shape, n=9):
    """Max |H x - x| over a coarse grid, per axis (host-side numpy)."""
    H33 = np.asarray(H33, np.float64)
    Hh, Ww = image_shape
    xs = np.linspace(0, Ww - 1.0, n)
    ys = np.linspace(0, Hh - 1.0, n)
    X, Y = np.meshgrid(xs, ys)
    P = np.stack([X.ravel(), Y.ravel(), np.ones(X.size)])
    Q = H33 @ P
    w = Q[2]
    if np.any(w <= 1e-9):
        return np.inf, np.inf
    U, V = Q[0] / w, Q[1] / w
    return float(np.abs(U - X.ravel()).max()), float(np.abs(V - Y.ravel()).max())


def rectification_feasible(T_rk_np, key_focal, key_offset, ref_focal,
                           ref_offset, image_shape, max_dx, max_dy):
    """Host-side gate: does this pair's rectification fit the shift-warp
    displacement budget?  Checks both homographies and their inverses on
    a coarse grid.  Returns (feasible, flip)."""
    T = np.asarray(T_rk_np, np.float64)
    flip = baseline_flip(T)
    R_rk, t_rk = T[:3, :3], T[:3, 3]
    b = -R_rk.T @ t_rk
    B = np.linalg.norm(b)
    if B < 1e-12:
        return False, flip
    sgn = -1.0 if flip else 1.0
    r1 = sgn * b / B
    r2 = np.cross([0.0, 0.0, 1.0], r1)
    n2 = np.linalg.norm(r2)
    if n2 < 1e-6:                    # baseline parallel to optical axis
        return False, flip
    r2 = r2 / n2
    R_new = np.stack([r1, r2, np.cross(r1, r2)])

    def K(f, c):
        return np.array([[f[0], 0, c[0]], [0, f[1], c[1]], [0, 0, 1.0]])

    K_rect = K(np.asarray(key_focal), np.asarray(key_offset))
    H_key = K_rect @ R_new @ np.linalg.inv(K(np.asarray(key_focal),
                                             np.asarray(key_offset)))
    H_ref = K_rect @ R_new @ R_rk.T @ np.linalg.inv(
        K(np.asarray(ref_focal), np.asarray(ref_offset)))
    for H in (H_key, H_ref, np.linalg.inv(H_key), np.linalg.inv(H_ref)):
        dx, dy = _np_homography_displacement(H, image_shape)
        if dx > max_dx or dy > max_dy:
            return False, flip
    return True, flip
