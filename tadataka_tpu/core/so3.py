"""SO(3): hat map, exponential and logarithm.

Parity surface: /root/reference/tadataka/so3.py (scipy-Rotation-based exp/log,
einsum hat map).  Here both maps are closed-form Rodrigues expressions with
small-angle Taylor guards so they are jit/vmap/grad-safe at theta = 0 — a
requirement of compiled array code that the scipy implementation never faced.
"""

import jax.numpy as jnp

# Taylor switchover: below this angle the series is more accurate in f32
# and, crucially, has finite gradients at exactly zero.
_SMALL = 1e-5


def hat_so3(v):
    """Skew-symmetric matrix [v]_x of omega (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ], axis=-2)


def _theta_terms(rotvec):
    """(small, sq, safe_theta) with gradient-safe guards.

    ``sq`` = theta^2 (polynomial in rotvec — clean gradients everywhere),
    ``safe_theta`` = theta clamped away from 0 for trig branches only.
    The pairing with double-where keeps gradients finite at theta == 0.
    """
    sq = jnp.sum(rotvec * rotvec, axis=-1)
    small = sq < _SMALL * _SMALL
    safe_theta = jnp.sqrt(jnp.where(small, 1.0, sq))
    return small, sq, safe_theta


def _safe_theta(rotvec):
    """Norm of rotvec with a zero-safe gradient path."""
    small, sq, safe_theta = _theta_terms(rotvec)
    return jnp.where(small, jnp.sqrt(sq + 1e-30), safe_theta)


def exp_so3(rotvec):
    """Rodrigues: exp([omega]_x) for rotvec (..., 3) -> (..., 3, 3)."""
    small, sq, safe = _theta_terms(rotvec)
    small, sq, safe = (x[..., None, None] for x in (small, sq, safe))
    K = hat_so3(rotvec)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rotvec.dtype), K.shape)

    a = jnp.where(small, 1.0 - sq / 6.0, jnp.sin(safe) / safe)
    b = jnp.where(small, 0.5 - sq / 24.0,
                  (1.0 - jnp.cos(safe)) / (safe * safe))
    return eye + a * K + b * KK


def log_so3(R):
    """Rotation matrix (..., 3, 3) -> rotvec (..., 3).

    Uses the quaternion route, which is stable for angles near 0 and near pi
    (the direct arccos formula loses precision at both ends in f32).
    """
    q = _quat_from_matrix(R)
    return _rotvec_from_quat(q)


def _quat_from_matrix(R):
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free.

    Shepperd's method: compute all four candidate constructions and select the
    best-conditioned one with where-chains (no data-dependent branching).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidates, each scaled by 4*component^2 (guaranteed >= 0 for one)
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-24))

    # construction from w
    sw = safe_sqrt(qw2) * 2.0
    cand_w = jnp.stack([sw / 4.0, (m21 - m12) / sw, (m02 - m20) / sw,
                        (m10 - m01) / sw], axis=-1)
    sx = safe_sqrt(qx2) * 2.0
    cand_x = jnp.stack([(m21 - m12) / sx, sx / 4.0, (m01 + m10) / sx,
                        (m02 + m20) / sx], axis=-1)
    sy = safe_sqrt(qy2) * 2.0
    cand_y = jnp.stack([(m02 - m20) / sy, (m01 + m10) / sy, sy / 4.0,
                        (m12 + m21) / sy], axis=-1)
    sz = safe_sqrt(qz2) * 2.0
    cand_z = jnp.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz,
                        sz / 4.0], axis=-1)

    vals = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    best = jnp.argmax(vals, axis=-1)[..., None]
    q = jnp.where(best == 0, cand_w,
                  jnp.where(best == 1, cand_x,
                            jnp.where(best == 2, cand_y, cand_z)))
    # canonicalize sign (w >= 0) and normalize
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def _rotvec_from_quat(q):
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    s = jnp.linalg.norm(xyz, axis=-1)
    theta = 2.0 * jnp.arctan2(s, w)
    small = s < _SMALL
    # theta/sin(theta/2) ~= 2 + theta^2/12 for small theta
    scale = jnp.where(small, 2.0 + theta * theta / 12.0,
                      theta / jnp.maximum(s, 1e-24))
    return xyz * scale[..., None]


def is_rotation_matrix(R, atol=1e-5):
    eye = jnp.eye(3, dtype=R.dtype)
    orth = jnp.allclose(R @ jnp.swapaxes(R, -1, -2), eye, atol=atol)
    det = jnp.allclose(jnp.linalg.det(R), 1.0, atol=atol)
    return jnp.logical_and(orth, det)
