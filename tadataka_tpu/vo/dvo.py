"""Direct photometric (RGB-D) visual odometry — Kerl-style DVO.

Parity surface: /root/reference/tadataka/vo/dvo/__init__.py (coarse-to-fine
robust Gauss-Newton with error-increase stop; residual I0 - I1 at the
original pixel grid, per-iteration 2x6 Jacobian at the warped points) and
/root/reference/tadataka/vo/dvo/jacobian.py (the analytic Jacobian).

Design: the whole per-level Gauss-Newton loop is one jitted
``lax.while_loop``; boolean compaction (``r[mask]``) becomes zero-weight
masking so shapes stay static.  J^T W J is a (N, 6)-matmul reduction
followed by a 6x6 solve.  The pyramid is a Python loop over static
shapes (one trace per level, cached across calls).
"""

from functools import partial
import math

import jax
import jax.numpy as jnp

from tadataka_tpu.camera import resize as camera_resize
from tadataka_tpu.core.gradients import np_gradient_2d
from tadataka_tpu.core.interpolation import interpolate
from tadataka_tpu.core.pose import Pose
from tadataka_tpu.core.shiftwarp import tent_sample
from tadataka_tpu.robust.weights import (
    compute_weights_huber, compute_weights_student_t, compute_weights_tukey)


def calc_jacobian(focal_length, gx, gy, P):
    """Analytic 2x6->1x6 image-gradient Jacobian rows, batched over pixels.

    Parity: calc_jacobian (/root/reference/tadataka/vo/dvo/jacobian.py:8-25).
    P: (N, 3) points in frame 1; gx, gy: (N,) sampled gradients of I1.
    """
    return jnp.stack(
        calc_jacobian_cols(focal_length, gx, gy,
                           P[:, 0], P[:, 1], P[:, 2]), axis=-1)


def calc_jacobian_cols(focal_length, gx, gy, x, y, z):
    """The six Jacobian columns as separate (N,) arrays (componentwise
    layout, no (N, 6) tensor with a tiny minor dimension)."""
    fx, fy = focal_length[0], focal_length[1]
    fgx, fgy = fx * gx, fy * gy
    z2 = z * z
    xy = x * y
    return (
        fgx / z,
        fgy / z,
        -(fgx * x + fgy * y) / z2,
        -(fgx * xy + fgy * (z2 + y * y)) / z2,
        (fgx * (z2 + x * x) + fgy * xy) / z2,
        (-fgx * y + fgy * x) / z,
    )


_SIGMA_I2 = 1e-3   # photometric noise floor for "depth-var" ([0,1] images)


def _resolve_weights(weight_kind, residuals, weight_map, mask,
                     dr_dq=None):
    if weight_kind == "none":
        return jnp.where(mask, 1.0, 0.0)
    if weight_kind == "map":
        return jnp.where(mask, weight_map, 0.0)
    if weight_kind == "depth-var":
        # LSD-SLAM tracking weights: residual covariance = photometric
        # noise + depth-noise propagated through the warp,
        # w = 1 / (sigma_I^2 + (dr/dq)^2 Var[q]) with q = inverse depth
        # and weight_map carrying Var[q].  Plain 1/Var[q] (or any purely
        # residual-based robust kernel) cannot fix the errors-in-variables
        # ATTENUATION a noisy depth map causes: the photometric optimum
        # shrinks toward identity (measured 0.047 vs 0.132 true ||t|| on
        # a one-frame-baseline map — r5 long-trajectory gate).
        var_q = weight_map
        w = 1.0 / (_SIGMA_I2 + dr_dq * dr_dq * var_q)
        return jnp.where(mask, w, 0.0)
    if weight_kind == "tukey":
        return compute_weights_tukey(residuals, mask=mask)
    if weight_kind == "student-t":
        return compute_weights_student_t(residuals, mask=mask)
    if weight_kind == "huber":
        return compute_weights_huber(residuals, mask=mask)
    raise ValueError(f"No such weights '{weight_kind}'")


def _estimate_level(camera_model0, camera_model1, I0, D0, I1, weight_map,
                    R10, t10, max_iter, weight_kind, sample_budget=0,
                    grid=None):
    """Gauss-Newton at one pyramid level; returns updated (R10, t10).

    Traced inside estimate_pose_pyramid — not jitted on its own.
    ``sample_budget`` as in _estimate_level_ic (here three channels —
    I1, GX1, GY1 — ride the same two tent passes)."""
    H, W = I0.shape
    f32 = I0.dtype
    if grid is not None:
        x0n, y0n = grid
    else:
        ux, uy = _grid_xy(D0.shape, f32)
        x0n, y0n = camera_model0.normalize_xy(ux, uy)
    d0 = D0.ravel()
    p0x, p0y, p0z = x0n * d0, y0n * d0, d0
    GX1, GY1 = np_gradient_2d(I1)
    IG1 = jnp.stack([I1, GX1, GY1])
    i0 = I0.ravel()
    wmap = weight_map.ravel()
    focal_length = camera_model1.camera_parameters.focal_length

    def cond(carry):
        k, R, t, R_best, t_best, prev_error, done = carry
        return jnp.logical_and(k < max_iter + 1, jnp.logical_not(done))

    def body(carry):
        k, R, t, R_best, t_best, prev_error, _ = carry
        p1x = R[0, 0] * p0x + R[0, 1] * p0y + R[0, 2] * p0z + t[0]
        p1y = R[1, 0] * p0x + R[1, 1] * p0y + R[1, 2] * p0z + t[1]
        p1z = R[2, 0] * p0x + R[2, 1] * p0y + R[2, 2] * p0z + t[2]
        x1 = p1x / (p1z + 1e-16)
        y1 = p1y / (p1z + 1e-16)
        us1x, us1y = camera_model1.unnormalize_xy(x1, y1)
        mask = _in_image_xy(us1x, us1y, GX1.shape) & (p1z > 0)

        # forward-compositional residual: r = I0(u0) - I1(warp(u0)).
        # (The reference freezes r = I0 - I1 at the original grid,
        # dvo/__init__.py:91 — recomputing converges strictly closer to the
        # true photometric minimum.)  The same residuals give the current
        # photometric error, so the error-increase stop costs no extra warp
        # (the reference re-warps the full image per iteration for it).
        if sample_budget > 0:
            ig1, ok = tent_sample(IG1, us1x.reshape(H, W),
                                  us1y.reshape(H, W),
                                  sample_budget, sample_budget)
            i1 = ig1[0].ravel()
            gx1 = ig1[1].ravel()
            gy1 = ig1[2].ravel()
            mask = mask & ok.ravel()
        else:
            us1 = jnp.stack([us1x, us1y], axis=-1)
            i1 = interpolate(I1, us1)
            gx1 = interpolate(GX1, us1)
            gy1 = interpolate(GY1, us1)
        any_valid = jnp.any(mask)
        residuals = jnp.where(mask, i0 - i1, 0.0)
        n_valid = jnp.maximum(jnp.sum(mask), 1)
        curr_error = jnp.sum(residuals * residuals) / n_valid

        improved = curr_error < prev_error
        R_best_new = jnp.where(improved, R, R_best)
        t_best_new = jnp.where(improved, t, t_best)
        done = jnp.logical_or(jnp.logical_not(any_valid),
                              jnp.logical_not(improved))
        # guard z against masked lanes to keep J finite
        p1z_safe = jnp.where(mask, p1z, 1.0)
        J_cols = calc_jacobian_cols(focal_length, gx1, gy1,
                                    p1x, p1y, p1z_safe)
        dr_dq = None
        if weight_kind == "depth-var":
            z2 = p1z_safe * p1z_safe
            dxdq = p0z * (t[0] * p1z_safe - t[2] * p1x) / z2
            dydq = p0z * (t[1] * p1z_safe - t[2] * p1y) / z2
            dr_dq = (focal_length[0] * gx1 * dxdq
                     + focal_length[1] * gy1 * dydq)
        w = _resolve_weights(weight_kind, residuals, wmap, mask, dr_dq)
        JtJ, Jtr = _normal_equations(J_cols, w, residuals)
        xi = jnp.linalg.solve(JtJ + 1e-12 * jnp.eye(6, dtype=JtJ.dtype), Jtr)

        dpose = Pose.from_se3(xi)
        R_new = dpose.R @ R
        t_new = (dpose.R @ t) + dpose.t

        err_out = jnp.where(improved, curr_error, prev_error)
        return (k + 1, R_new, t_new, R_best_new, t_best_new, err_out, done)

    _, _, _, R, t, _, _ = jax.lax.while_loop(
        cond, body, (0, R10, t10, R10, t10, jnp.asarray(jnp.inf, I0.dtype),
                     jnp.asarray(False)))
    return R, t


def _grid_xy(shape, dtype):
    """Flat (N,) pixel-coordinate components (no (N, 2) stacks)."""
    H, W = shape
    X, Y = jnp.meshgrid(jnp.arange(W, dtype=dtype),
                        jnp.arange(H, dtype=dtype))
    return X.ravel(), Y.ravel()


def _in_image_xy(x, y, shape):
    H, W = shape
    return (0.0 <= x) & (x <= W - 1.0) & (0.0 <= y) & (y <= H - 1.0)


def _normal_equations(J_cols, w, residuals):
    """6x6 J^T W J and J^T W r from six (N,) Jacobian columns.

    (6, N) stacks keep the pixel axis minor; the
    contraction runs as one dot_general.
    """
    Jt = jnp.stack(J_cols)                         # (6, N)
    Jw = Jt * w[None, :]
    JtJ = jax.lax.dot_general(Jw, Jt, (((1,), (1,)), ((), ())),
                              preferred_element_type=Jw.dtype)
    Jtr = Jw @ residuals
    return JtJ, Jtr


def _estimate_level_ic(camera_model0, camera_model1, I0, D0, I1, weight_map,
                       R10, t10, max_iter, weight_kind, sample_budget=0,
                       grid=None):
    """Inverse-compositional Gauss-Newton at one pyramid level.

    Baker-Matthews IC: the 2x6 Jacobian lives on the TEMPLATE (frame 0)
    and is computed once per level; each iteration costs one bilinear
    sample of I1 plus a (6, N) reduction — a 3x cut in gather traffic vs
    the forward-compositional loop.  All per-pixel state is carried as
    separate (N,) component arrays, not packed (N, 2)/(N, 3)/(N, 6)
    tensors.
    The pose increment composes on the template side:
    pose10 <- pose10 * exp(xi)^-1.

    ``sample_budget`` > 0 replaces the per-iteration scattered bilinear
    gather of I1 with the gather-free tent shift-sum resample
    (core/shiftwarp.py) bounded by that static pixel budget; lanes whose
    inter-frame flow exceeds it are masked out of the normal equations
    (the coarse-to-fine pyramid keeps residual flow small at every level
    for VO motion).
    """
    H, W = I0.shape
    f32 = I0.dtype
    if grid is not None:
        x0n, y0n = grid
    else:
        ux, uy = _grid_xy(D0.shape, f32)
        x0n, y0n = camera_model0.normalize_xy(ux, uy)
    d0 = D0.ravel()
    p0x, p0y, p0z = x0n * d0, y0n * d0, d0
    GX0, GY0 = np_gradient_2d(I0)
    gx0 = GX0.ravel()
    gy0 = GY0.ravel()
    i0 = I0.ravel()
    wmap = weight_map.ravel()
    focal_length = camera_model0.camera_parameters.focal_length

    # template-side Jacobian, once per level (identity warp, points in
    # frame-0 coordinates)
    J_cols = calc_jacobian_cols(focal_length, gx0, gy0, p0x, p0y,
                                jnp.maximum(p0z, 1e-6))

    def cond(carry):
        k, R, t, R_best, t_best, prev_error, done = carry
        return jnp.logical_and(k < max_iter + 1, jnp.logical_not(done))

    def body(carry):
        k, R, t, R_best, t_best, prev_error, _ = carry
        p1x = R[0, 0] * p0x + R[0, 1] * p0y + R[0, 2] * p0z + t[0]
        p1y = R[1, 0] * p0x + R[1, 1] * p0y + R[1, 2] * p0z + t[1]
        p1z = R[2, 0] * p0x + R[2, 1] * p0y + R[2, 2] * p0z + t[2]
        x1 = p1x / (p1z + 1e-16)
        y1 = p1y / (p1z + 1e-16)
        us1x, us1y = camera_model1.unnormalize_xy(x1, y1)
        mask = _in_image_xy(us1x, us1y, I1.shape) & (p1z > 0)

        if sample_budget > 0:
            i1_map, ok = tent_sample(I1, us1x.reshape(H, W),
                                     us1y.reshape(H, W),
                                     sample_budget, sample_budget)
            i1 = i1_map.ravel()
            mask = mask & ok.ravel()
        else:
            i1 = interpolate(I1, jnp.stack([us1x, us1y], axis=-1))
        any_valid = jnp.any(mask)

        residuals = jnp.where(mask, i1 - i0, 0.0)   # IC sign convention
        n_valid = jnp.maximum(jnp.sum(mask), 1)
        curr_error = jnp.sum(residuals * residuals) / n_valid

        improved = curr_error < prev_error
        R_best_new = jnp.where(improved, R, R_best)
        t_best_new = jnp.where(improved, t, t_best)
        done = jnp.logical_or(jnp.logical_not(any_valid),
                              jnp.logical_not(improved))

        dr_dq = None
        if weight_kind == "depth-var":
            # d(residual)/d(inverse depth): template gradient dotted with
            # the warp's depth derivative (see _resolve_weights)
            z2 = p1z * p1z + 1e-12
            dxdq = p0z * (t[0] * p1z - t[2] * p1x) / z2
            dydq = p0z * (t[1] * p1z - t[2] * p1y) / z2
            dr_dq = (focal_length[0] * gx0 * dxdq
                     + focal_length[1] * gy0 * dydq)
        w = _resolve_weights(weight_kind, residuals, wmap, mask, dr_dq)
        JtJ, Jtr = _normal_equations(J_cols, w, residuals)
        xi = jnp.linalg.solve(JtJ + 1e-12 * jnp.eye(6, dtype=JtJ.dtype), Jtr)

        # inverse composition: warp <- warp o exp(xi)^-1
        dpose = Pose.from_se3(xi).inv()
        R_new = R @ dpose.R
        t_new = (R @ dpose.t) + t

        err_out = jnp.where(improved, curr_error, prev_error)
        return (k + 1, R_new, t_new, R_best_new, t_best_new, err_out, done)

    _, _, _, R, t, _, _ = jax.lax.while_loop(
        cond, body, (0, R10, t10, R10, t10, jnp.asarray(jnp.inf, I0.dtype),
                     jnp.asarray(False)))
    return R, t


# Per-iteration resample of I1 for every backend: 0 = bilinear gather,
# > 0 = gather-free tent shift-sum with that pixel budget.  Chosen by
# timing both arms of SemiDenseVO and DvoTrajectory on an H100 (PERF.md).
DEFAULT_SAMPLE_BUDGET = 0


def _resize_image(image, shape):
    return jax.image.resize(image, shape, method="linear")


def level_to_scale(level, layer_size_ratio):
    return 1.0 / (layer_size_ratio ** level)


@partial(jax.jit, static_argnames=("n_levels", "max_iter",
                                   "layer_size_ratio", "weight_kind",
                                   "method", "sample_budget"))
def estimate_pose_pyramid(camera_model0, camera_model1, I0, D0, I1,
                          weight_map, R10, t10, n_levels, max_iter,
                          layer_size_ratio, weight_kind, method="ic",
                          sample_budget=0, grids=None):
    """The full coarse-to-fine estimation as ONE jitted program.

    All pyramid levels (static shapes), their resizes, and the per-level
    Gauss-Newton while_loops compile into a single XLA computation — one
    host dispatch per frame instead of dozens.

    ``sample_budget`` > 0 switches every level's per-iteration image
    resample to the gather-free tent shift-sum path with that static pixel
    budget; 0 keeps the bilinear gather.

    ``grids``: optional per-level (x0n, y0n) normalized template grids
    (finest level LAST, matching the reversed loop), precomputed once by
    the caller.  For distorted cameras the normalization runs a Newton
    undistort over the whole grid — identical every frame; precomputing
    it (PoseChangeEstimator does, via camera/table.py semantics) removes
    it from the per-frame program."""
    H, W = I0.shape
    R, t = R10, t10
    level_fn = _estimate_level_ic if method == "ic" else _estimate_level
    for k, level in enumerate(reversed(range(n_levels))):
        scale = level_to_scale(level, layer_size_ratio)
        shape = (max(int(math.ceil(H * scale)), 8),
                 max(int(math.ceil(W * scale)), 8))
        cm0 = camera_resize(camera_model0, scale)
        cm1 = camera_resize(camera_model1, scale)
        I0s = _resize_image(I0, shape)
        D0s = _resize_image(D0, shape)
        I1s = _resize_image(I1, shape)
        Ws = _resize_image(weight_map, shape)
        R, t = level_fn(cm0, cm1, I0s, D0s, I1s, Ws, R, t,
                        max_iter, weight_kind,
                        sample_budget=sample_budget,
                        grid=None if grids is None else grids[k])
    return R, t


@partial(jax.jit, static_argnames=("n_levels", "layer_size_ratio", "shape"))
def normalized_grids(camera_model0, n_levels, layer_size_ratio, shape):
    """Per-level (x0n, y0n) normalized template grids for
    ``estimate_pose_pyramid`` (finest level last) — the precomputed
    undistortion table of the DVO pyramid."""
    H, W = shape
    grids = []
    for level in reversed(range(n_levels)):
        scale = level_to_scale(level, layer_size_ratio)
        lshape = (max(int(math.ceil(H * scale)), 8),
                  max(int(math.ceil(W * scale)), 8))
        cm0 = camera_resize(camera_model0, scale)
        ux, uy = _grid_xy(lshape, jnp.float32)
        grids.append(cm0.normalize_xy(ux, uy))
    return tuple(grids)


class PoseChangeEstimator:
    """Coarse-to-fine DVO pose estimator.

    Parity: PoseChangeEstimator (/root/reference/tadataka/vo/dvo/__init__.py:
    114-150): default 5 levels, size ratio 1.5, <=20 GN iterations per level,
    weights in {None, array, "tukey", "student-t", "huber"}.
    """

    def __init__(self, camera_model0, camera_model1,
                 n_coarse_to_fine=5, max_iter=20, layer_size_ratio=1.5,
                 method="ic", sample_budget=None):
        """method: "ic" (inverse compositional, 3x fewer image samples per
        iteration) or "fc" (forward compositional, the reference's
        formulation with per-iteration re-linearization).

        sample_budget: static pixel budget for the gather-free tent
        resample of I1 (core/shiftwarp.py); lanes whose inter-frame flow
        exceeds it are dropped from the normal equations.  0 runs the
        exact bilinear gather; ``None`` takes ``DEFAULT_SAMPLE_BUDGET``."""
        self.camera_model0 = camera_model0
        self.camera_model1 = camera_model1
        self.n_coarse_to_fine = n_coarse_to_fine
        self.max_iter = max_iter
        self.layer_size_ratio = layer_size_ratio
        self.method = method
        if sample_budget is None:
            sample_budget = DEFAULT_SAMPLE_BUDGET
        self.sample_budget = sample_budget
        self._grids = {}      # image shape -> per-level normalized grids

    def __call__(self, I0, D0, I1, weights=None, pose10=None):
        assert I0.shape == D0.shape == I1.shape
        if pose10 is None:
            pose10 = Pose.identity(dtype=jnp.float32)
        shape = tuple(I0.shape)
        grids = self._grids.get(shape)
        if grids is None:
            grids = normalized_grids(self.camera_model0,
                                     self.n_coarse_to_fine,
                                     self.layer_size_ratio, shape)
            self._grids[shape] = grids

        if isinstance(weights, str):
            weight_kind = weights
            weight_map = jnp.ones_like(jnp.asarray(I0))
        elif weights is None:
            weight_kind = "none"
            weight_map = jnp.ones_like(jnp.asarray(I0))
        else:
            weight_kind = "map"
            weight_map = jnp.asarray(weights)

        R, t = estimate_pose_pyramid(
            self.camera_model0, self.camera_model1,
            jnp.asarray(I0, dtype=jnp.float32),
            jnp.asarray(D0, dtype=jnp.float32),
            jnp.asarray(I1, dtype=jnp.float32),
            weight_map.astype(jnp.float32),
            pose10.R, pose10.t,
            self.n_coarse_to_fine, self.max_iter, self.layer_size_ratio,
            weight_kind, self.method, self.sample_budget, grids)
        return Pose(R, t)
