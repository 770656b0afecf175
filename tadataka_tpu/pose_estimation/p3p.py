"""P3P: camera pose from three 2D-3D correspondences (Grunert's method).

The reference delegates minimal-solver pose estimation to cv2's RANSAC
(/root/reference/tadataka/pose.py:85, EPnP flag); P3P is the classical
minimal solver used alongside it.  This is a closed-form, branch-free
implementation — quartic roots via Ferrari's method with where-masked
discriminant branches — so one trial vmaps across thousands of RANSAC
samples on the device with no data-dependent control flow.

Math: squared side lengths a2/b2/c2 between the 3 world points, cosines of
the bearing angles, then distances s_i to the camera from the quartic in
v = s3/s1 (coefficients machine-derived by resultant elimination of
u = s2/s1; they match Grunert 1841 as catalogued by Haralick et al. 1994),
and absolute orientation (Kabsch) from the 3 recovered camera-frame points.
"""

import jax
import jax.numpy as jnp

NEWTON_POLISH_ITERS = 10


def _cbrt(x):
    return jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)


def _max_real_cubic_root(b, c, d):
    """Largest real root of z^3 + b z^2 + c z + d (branch-free)."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    off = -b / 3.0

    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # disc >= 0: single real root via Cardano
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    root_pos = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)

    # disc < 0: three real roots via the trigonometric method; take the max
    m = jnp.sqrt(jnp.maximum(-p / 3.0, 1e-30))
    arg = jnp.clip(3.0 * q / (2.0 * p * m), -1.0, 1.0)
    theta = jnp.arccos(arg) / 3.0
    ks = jnp.array([0.0, 1.0, 2.0])
    roots_trig = 2.0 * m * jnp.cos(theta - 2.0 * jnp.pi * ks / 3.0)
    root_neg = jnp.max(roots_trig)

    return jnp.where(disc >= 0.0, root_pos, root_neg) + off


def solve_quartic(c4, c3, c2, c1, c0):
    """Real roots of c4 x^4 + ... + c0 (Ferrari).  Returns (roots (4,),
    valid (4,)); invalid lanes hold 0."""
    scale = jnp.where(jnp.abs(c4) < 1e-20, 1.0, c4)
    p, q, r, s = c3 / scale, c2 / scale, c1 / scale, c0 / scale

    # depressed quartic y^4 + A y^2 + B y + C, x = y - p/4
    A = q - 3.0 * p * p / 8.0
    B = r - p * q / 2.0 + p ** 3 / 8.0
    C = s - p * r / 4.0 + p * p * q / 16.0 - 3.0 * p ** 4 / 256.0

    # resolvent cubic z^3 + 2A z^2 + (A^2 - 4C) z - B^2 = 0 has a root
    # z >= 0; the largest real root is it
    z = _max_real_cubic_root(2.0 * A, A * A - 4.0 * C, -B * B)
    z = jnp.maximum(z, 0.0)
    w = jnp.sqrt(z)

    # y^2 + w y + (A + z)/2 - B/(2w) = 0   and   y^2 - w y + ... + B/(2w)
    safe_w = jnp.where(w < 1e-12, 1.0, w)
    b_over = jnp.where(w < 1e-12, 0.0, B / (2.0 * safe_w))
    half = (A + z) / 2.0

    def quad(b_, c_):
        disc = b_ * b_ - 4.0 * c_
        # f32 tolerance: a near-double real root can show a marginally
        # negative discriminant — accept it (Newton polish recenters it;
        # genuinely complex pairs won't converge and score no inliers)
        tol = 1e-4 * (b_ * b_ + jnp.abs(4.0 * c_) + 1e-6)
        ok = disc >= -tol
        sd = jnp.sqrt(jnp.maximum(disc, 0.0))
        return (jnp.stack([(-b_ + sd) / 2.0, (-b_ - sd) / 2.0]),
                jnp.stack([ok, ok]))

    r1, ok1 = quad(w, half - b_over)
    r2, ok2 = quad(-w, half + b_over)
    roots = jnp.concatenate([r1, r2]) - p / 4.0
    valid = jnp.concatenate([ok1, ok2])
    valid = valid & (jnp.abs(c4) > 1e-20)

    # Newton polish on the original quartic (f32 Ferrari drifts)
    def poly(x):
        return (((c4 * x + c3) * x + c2) * x + c1) * x + c0

    def dpoly(x):
        return ((4.0 * c4 * x + 3.0 * c3) * x + 2.0 * c2) * x + c1

    for _ in range(NEWTON_POLISH_ITERS):
        d = dpoly(roots)
        roots = roots - poly(roots) / jnp.where(jnp.abs(d) < 1e-20, 1.0, d)
    return jnp.where(valid, roots, 0.0), valid


def _kabsch(P_world, Q_cam):
    """R, t with Q = R P + t (no scale; 3 non-collinear points)."""
    cw = jnp.mean(P_world, axis=0)
    cc = jnp.mean(Q_cam, axis=0)
    H = (P_world - cw).T @ (Q_cam - cc)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]).at[2].set(d))
    R = Vt.T @ D @ U.T
    t = cc - R @ cw
    return R, t


def p3p_solutions(points, keypoints):
    """All P3P solutions for 3 correspondences.

    points: (3, 3) world points; keypoints: (3, 2) normalized image coords.
    Returns (Rs (4, 3, 3), ts (4, 3), valid (4,)) with x_cam = R x_world + t.
    """
    f = jnp.concatenate([keypoints, jnp.ones((3, 1), keypoints.dtype)],
                        axis=-1)
    f = f / jnp.linalg.norm(f, axis=-1, keepdims=True)
    P1, P2, P3 = points[0], points[1], points[2]

    a2 = jnp.sum((P2 - P3) ** 2)
    b2 = jnp.sum((P1 - P3) ** 2)
    c2 = jnp.sum((P1 - P2) ** 2)
    ca = jnp.dot(f[1], f[2])
    cb = jnp.dot(f[0], f[2])
    cg = jnp.dot(f[0], f[1])

    # quartic in v = s3/s1 (sympy resultant; common b2^2 factor dropped)
    A4 = (a2 ** 2 - 2 * a2 * b2 - 2 * a2 * c2 + b2 ** 2
          - 4 * b2 * c2 * ca ** 2 + 2 * b2 * c2 + c2 ** 2)
    A3 = -4 * (a2 ** 2 * cb - a2 * b2 * ca * cg - a2 * b2 * cb
               - 2 * a2 * c2 * cb + b2 ** 2 * ca * cg
               - 2 * b2 * c2 * ca ** 2 * cb - b2 * c2 * ca * cg
               + b2 * c2 * cb + c2 ** 2 * cb)
    A2 = 2 * (2 * a2 ** 2 * cb ** 2 + a2 ** 2 - 4 * a2 * b2 * ca * cb * cg
              - 2 * a2 * b2 * cg ** 2 - 4 * a2 * c2 * cb ** 2 - 2 * a2 * c2
              + 2 * b2 ** 2 * ca ** 2 + 2 * b2 ** 2 * cg ** 2 - b2 ** 2
              - 2 * b2 * c2 * ca ** 2 - 4 * b2 * c2 * ca * cb * cg
              + 2 * c2 ** 2 * cb ** 2 + c2 ** 2)
    A1 = -4 * (a2 ** 2 * cb - a2 * b2 * ca * cg - 2 * a2 * b2 * cb * cg ** 2
               + a2 * b2 * cb - 2 * a2 * c2 * cb + b2 ** 2 * ca * cg
               - b2 * c2 * ca * cg - b2 * c2 * cb + c2 ** 2 * cb)
    A0 = (a2 ** 2 - 4 * a2 * b2 * cg ** 2 + 2 * a2 * b2 - 2 * a2 * c2
          + b2 ** 2 - 2 * b2 * c2 + c2 ** 2)

    vs, valid = solve_quartic(A4, A3, A2, A1, A0)

    # u = s2/s1 is linear in v:  (F1 - F2 elimination)
    denom_u = 2.0 * b2 * (cg - vs * ca)
    num_u = b2 * (1.0 - vs ** 2) + (a2 - c2) * (1.0 + vs ** 2 - 2 * vs * cb)
    safe_denom = jnp.where(jnp.abs(denom_u) < 1e-20, 1.0, denom_u)
    us = num_u / safe_denom
    valid = valid & (jnp.abs(denom_u) >= 1e-20)

    s1sq_denom = 1.0 + vs ** 2 - 2.0 * vs * cb
    s1 = jnp.sqrt(b2 / jnp.maximum(s1sq_denom, 1e-20))
    s2 = us * s1
    s3 = vs * s1
    valid = valid & (s1 > 0) & (s2 > 0) & (s3 > 0) & (s1sq_denom > 1e-20)

    def orient(si):
        Q = si[:, None] * f
        R, t = _kabsch(points, Q)
        # near-double quartic roots (v ~ 1, the common small-motion case)
        # carry ~sqrt(f32 eps) error; a short Gauss-Newton on the 3-point
        # reprojection system (6 residuals, 6 dof) restores full precision
        from tadataka_tpu.pose_estimation.pnp import _refine_gauss_newton
        return _refine_gauss_newton(R, t, points, keypoints,
                                    jnp.ones(3, points.dtype), 5)

    Rs, ts = jax.vmap(orient)(jnp.stack([s1, s2, s3], axis=-1))
    return Rs, ts, valid


def p3p_best_pose(points4, keypoints4):
    """RANSAC-trial entry: P3P on the first 3 correspondences, candidate
    disambiguated by the 4th point's reprojection error.

    points4: (4, 3); keypoints4: (4, 2) normalized.  Returns (R, t).
    """
    Rs, ts, valid = p3p_solutions(points4[:3], keypoints4[:3])

    def reproj_err(R, t):
        p = R @ points4[3] + t
        proj = p[:2] / jnp.where(jnp.abs(p[2]) < 1e-12, 1e-12, p[2])
        err = jnp.sum((proj - keypoints4[3]) ** 2)
        return jnp.where(p[2] > 0, err, jnp.inf)

    errs = jax.vmap(reproj_err)(Rs, ts)
    errs = jnp.where(valid, errs, jnp.inf)
    best = jnp.argmin(errs)
    return Rs[best], ts[best]
