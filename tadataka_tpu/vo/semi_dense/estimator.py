"""Per-pixel epipolar inverse-depth estimation, vmapped over the image.

Parity surface: /root/reference/src/semi_dense/semi_dense.rs (estimate /
update_depth), epipolar.rs, depth.rs, variance.rs, intensities.rs.

Design decisions vs the reference:
- The epipolar line gets a STATIC sample budget ``n_ref_samples``.  When the
  geometric range needs more samples than the budget, the step size grows to
  keep the full +-2 sigma search range covered (the reference instead walks
  an unbounded dynamic-length line, semi_dense.rs:139).
- Early exits become a priority chain of flags; every lane computes the full
  pipeline with numerically-guarded values and the flag decides whether the
  prior or the new hypothesis is written back.
- The normalized-SSD template search (intensities.rs:11-37) is a batched
  sliding-window computation with a masked argmin.
- The per-pixel age-indexed reference frame (semi_dense.rs:207) becomes a
  per-lane gather into the stacked refframe history.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tadataka_tpu.flags import Flag
from tadataka_tpu.core.gradients import sobel_x, sobel_y, gradient1d
from tadataka_tpu.core.transforms import (
    get_rotation, get_translation, inv_motion_matrix, to_homogeneous)
from tadataka_tpu.core.triangulation import calc_depth0
from tadataka_tpu.vo.semi_dense.frame import SemiDenseFrame
from tadataka_tpu.vo.semi_dense.hypothesis import (
    check_args_flag, clamped_range)
from tadataka_tpu.vo.semi_dense.params import (
    SemiDenseParams, N_KEY_SAMPLES, DEFAULT_N_REF_SAMPLES)

EPSILON = 1e-16


def safe_invert(v):
    return 1.0 / (v + EPSILON)


def _normalize_vec(v):
    n = jnp.linalg.norm(v)
    return jnp.where(n == 0.0, v, v / jnp.where(n == 0.0, 1.0, n))


def _warp_point(T, x, depth):
    """Normalized coord + depth through a 4x4 transform -> (coord, depth)."""
    P0 = jnp.array([x[0] * depth, x[1] * depth, depth])
    P1 = get_rotation(T) @ P0 + get_translation(T)
    return P1[:2] / (P1[2] + EPSILON), P1[2]


def _in_image(u, image_shape):
    H, W = image_shape
    return ((0.0 <= u[..., 0]) & (u[..., 0] <= W - 1.0)
            & (0.0 <= u[..., 1]) & (u[..., 1] <= H - 1.0))


def _interp_image(image, coords):
    """Bilinear sample of a single (H, W) image at (..., 2) [x, y] coords."""
    H, W = image.shape
    cx, cy = coords[..., 0], coords[..., 1]
    lx, ly = jnp.floor(cx), jnp.floor(cy)
    ax, ay = cx - lx, cy - ly
    x0 = jnp.clip(lx.astype(jnp.int32), 0, W - 1)
    y0 = jnp.clip(ly.astype(jnp.int32), 0, H - 1)
    x1 = jnp.clip(x0 + 1, 0, W - 1)
    y1 = jnp.clip(y0 + 1, 0, H - 1)
    v00, v01 = image[y0, x0], image[y0, x1]
    v10, v11 = image[y1, x0], image[y1, x1]
    return ((1 - ax) * (1 - ay) * v00 + ax * (1 - ay) * v01
            + (1 - ax) * ay * v10 + ax * ay * v11)


def _interp_stack(images, r, coords):
    """Bilinear sample of images (R, H, W) selected by scalar index r.

    Gathers the four corners with the frame index fused into the gather —
    NEVER materializes images[r] (under vmap that would broadcast the whole
    image per lane: f32[H*W, H, W]).
    """
    _, H, W = images.shape
    cx, cy = coords[..., 0], coords[..., 1]
    lx, ly = jnp.floor(cx), jnp.floor(cy)
    ax, ay = cx - lx, cy - ly
    x0 = jnp.clip(lx.astype(jnp.int32), 0, W - 1)
    y0 = jnp.clip(ly.astype(jnp.int32), 0, H - 1)
    x1 = jnp.clip(x0 + 1, 0, W - 1)
    y1 = jnp.clip(y0 + 1, 0, H - 1)
    rr = jnp.broadcast_to(r, x0.shape)
    v00 = images[rr, y0, x0]
    v01 = images[rr, y0, x1]
    v10 = images[rr, y1, x0]
    v11 = images[rr, y1, x1]
    return ((1 - ax) * (1 - ay) * v00 + ax * (1 - ay) * v01
            + (1 - ax) * ay * v10 + ax * ay * v11)


def _calc_ref_depth(T_rk, x_key, depth_key):
    """z-row of T_rk applied to the back-projected key point (depth.rs:6)."""
    p_key = jnp.array([x_key[0] * depth_key, x_key[1] * depth_key, depth_key])
    return T_rk[2, :3] @ p_key + T_rk[2, 3]


def _calc_alpha(T_rk, x_key, depth_range, prior_depth):
    """d(inverse depth)/d(epipolar position) (variance.rs:54-103)."""
    min_depth, max_depth = depth_range
    x_min_ref, _ = _warp_point(T_rk, x_key, min_depth)
    x_max_ref, _ = _warp_point(T_rk, x_key, max_depth)
    direction = _normalize_vec(x_max_ref - x_min_ref)

    R = get_rotation(T_rk)
    t = get_translation(T_rk)
    x_ref, _ = _warp_point(T_rk, x_key, prior_depth)
    y = to_homogeneous(x_key)

    def alpha_along(i):
        d = (R[2] @ y) * t[i] - (R[i] @ y) * t[2]
        n = x_ref[i] * t[2] - t[i]
        return direction[i] * d / (n * n + EPSILON)

    use_x = jnp.abs(direction[0]) > jnp.abs(direction[1])
    return jnp.where(use_x, alpha_along(0), alpha_along(1))


def _geo_var(x_key, t_rk, image_grad):
    """1 / <epipolar direction, image gradient>^2 (variance.rs:30-52)."""
    epipolar_direction = x_key - t_rk[:2] / (t_rk[2] + EPSILON)
    d = _normalize_vec(epipolar_direction)
    g = _normalize_vec(image_grad)
    p = jnp.dot(d, g)
    return jnp.where(p == 0.0, 1.0 / EPSILON, 1.0 / (p * p + EPSILON))


def _photo_var(gradient):
    return 2.0 / (gradient + EPSILON)


def _ssd_search(ref_intensities, key_intensities, n_valid):
    """Masked normalized-SSD template match (intensities.rs:11-37).

    ref_intensities: (N,), key_intensities: (K,), n_valid: dynamic count of
    valid ref samples.  Returns the matched sample index (argmin + K//2).
    """
    N = ref_intensities.shape[0]
    K = key_intensities.shape[0]
    M = N - K + 1
    # sliding windows (M, K) via static shifts
    windows = jnp.stack(
        [ref_intensities[i:i + M] for i in range(K)], axis=-1)
    wnorm = jnp.linalg.norm(windows, axis=-1, keepdims=True)
    windows_n = windows / (wnorm + EPSILON)
    kernel_n = key_intensities / (jnp.linalg.norm(key_intensities) + EPSILON)
    errors = jnp.sum((windows_n - kernel_n) ** 2, axis=-1)
    idx = jnp.arange(M)
    valid = idx <= n_valid - K
    errors = jnp.where(valid, errors, jnp.inf)
    argmin = jnp.argmin(errors)
    return argmin + K // 2


class PixelGeoScalars(NamedTuple):
    """Per-pixel epipolar geometry — SCALAR fields only.

    Two layout rules:
    - Components are SEPARATE x / y fields, never packed (..., 2) tensors:
      slicing a packed tensor's trailing axis materializes (N, S, 1)
      intermediates.
    - NO per-sample (5,) / (S,) arrays come out of the per-pixel vmap.
      vmap emits its outputs with the pixel axis in a minor physical
      layout, and image gathers consuming indices in that layout stride
      badly.  Sample coordinates are therefore built OUTSIDE the vmap by
      broadcasting these scalars against the sample-index axis (row-major
      by construction); see ``_key_coords`` / ``_ref_coords``.
    """
    x_key_x: jnp.ndarray      # normalized key coord
    x_key_y: jnp.ndarray
    x_min_ref_x: jnp.ndarray  # epipolar segment start (normalized, ref)
    x_min_ref_y: jnp.ndarray
    ref_dir_x: jnp.ndarray    # unit epipolar direction (ref)
    ref_dir_y: jnp.ndarray
    key_dir_x: jnp.ndarray    # unit epipolar direction (key)
    key_dir_y: jnp.ndarray
    step: jnp.ndarray         # ref sampling step (normalized units)
    key_step_size: jnp.ndarray
    n_samples: jnp.ndarray    # int32
    min_depth: jnp.ndarray
    max_depth: jnp.ndarray
    flag_neg_ref: jnp.ndarray
    flag_key_oob: jnp.ndarray
    flag_too_short: jnp.ndarray
    flag_close_oob: jnp.ndarray
    flag_far_oob: jnp.ndarray


def _key_coords(geo: PixelGeoScalars, steps, key_focal, key_offset):
    """Key-patch sample pixel coords from scalar geometry.

    ``steps`` carries the sample axis: (5,) per pixel, (5, 1) batched
    against (N,) scalar fields -> (5, N) row-major arrays.
    """
    us_key_x = ((geo.x_key_x + steps * (geo.key_step_size * geo.key_dir_x))
                * key_focal[0] + key_offset[0])
    us_key_y = ((geo.x_key_y + steps * (geo.key_step_size * geo.key_dir_y))
                * key_focal[1] + key_offset[1])
    return us_key_x, us_key_y


def _ref_coords(geo: PixelGeoScalars, idx, ref_focal_x, ref_focal_y,
                ref_offset_x, ref_offset_y):
    """Ref epipolar sample pixel coords; ``idx`` carries the sample axis."""
    us_ref_x = ((geo.x_min_ref_x + idx * (geo.step * geo.ref_dir_x))
                * ref_focal_x + ref_offset_x)
    us_ref_y = ((geo.x_min_ref_y + idx * (geo.step * geo.ref_dir_y))
                * ref_focal_y + ref_offset_y)
    return us_ref_x, us_ref_y


def _in_image_xy(x, y, image_shape):
    H, W = image_shape
    return (0.0 <= x) & (x <= W - 1.0) & (0.0 <= y) & (y <= H - 1.0)


def _interp_image_xy(image, x, y):
    """Bilinear sample at separate x / y arrays (any matching shape)."""
    H, W = image.shape
    flat = image.ravel()
    lx, ly = jnp.floor(x), jnp.floor(y)
    ax, ay = x - lx, y - ly
    x0 = jnp.clip(lx.astype(jnp.int32), 0, W - 1)
    y0 = jnp.clip(ly.astype(jnp.int32), 0, H - 1)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    b0 = y0 * W
    b1 = y1 * W
    v00 = jnp.take(flat, b0 + x0, mode="clip")
    v01 = jnp.take(flat, b0 + x1, mode="clip")
    v10 = jnp.take(flat, b1 + x0, mode="clip")
    v11 = jnp.take(flat, b1 + x1, mode="clip")
    return ((1 - ax) * (1 - ay) * v00 + ax * (1 - ay) * v01
            + (1 - ax) * ay * v10 + ax * ay * v11)


def _interp_stack_xy(images, r, x, y):
    """Bilinear sample of a (R, H, W) stack; ``r`` broadcasts against x/y."""
    R, H, W = images.shape
    flat = images.ravel()
    lx, ly = jnp.floor(x), jnp.floor(y)
    ax, ay = x - lx, y - ly
    x0 = jnp.clip(lx.astype(jnp.int32), 0, W - 1)
    y0 = jnp.clip(ly.astype(jnp.int32), 0, H - 1)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    base = jnp.broadcast_to(r * (H * W), x0.shape)
    b0 = base + y0 * W
    b1 = base + y1 * W
    v00 = jnp.take(flat, b0 + x0, mode="clip")
    v01 = jnp.take(flat, b0 + x1, mode="clip")
    v10 = jnp.take(flat, b1 + x0, mode="clip")
    v11 = jnp.take(flat, b1 + x1, mode="clip")
    return ((1 - ax) * (1 - ay) * v00 + ax * (1 - ay) * v01
            + (1 - ax) * ay * v10 + ax * ay * v11)


def _pixel_geometry(u_key, prior_inv_depth, prior_variance, T_rk, e_key,
                    key_focal, key_offset, key_shape,
                    ref_focal, ref_offset, ref_shape,
                    params: SemiDenseParams, n_ref_samples: int):
    """Pure per-pixel geometry (vmappable; no image gathers; scalars only).

    All sample-axis arrays ((5,) key patch, (S,) ref line) are derived
    later from these scalars via ``_key_coords`` / ``_ref_coords`` — see
    the layout note on :class:`PixelGeoScalars`.
    """
    f32 = u_key.dtype

    # prior search range (+-2 sigma clamped)
    lo, hi = clamped_range(prior_inv_depth, prior_variance,
                           params.min_inv_depth, params.max_inv_depth)
    min_depth = safe_invert(hi)
    max_depth = safe_invert(lo)

    x_key = (u_key - key_offset) / key_focal

    # step ratio: step size on key scales with inverse-depth ratio
    prior_depth = safe_invert(prior_inv_depth)
    ref_depth = _calc_ref_depth(T_rk, x_key, prior_depth)
    flag_neg_ref = ref_depth <= 0.0
    ratio = prior_inv_depth / safe_invert(jnp.maximum(ref_depth, EPSILON))

    # epipolar segment endpoints on the ref normalized plane
    x_min_ref, _ = _warp_point(T_rk, x_key, min_depth)
    x_max_ref, _ = _warp_point(T_rk, x_key, max_depth)
    ref_direction = x_max_ref - x_min_ref
    norm = jnp.linalg.norm(ref_direction)
    ref_dir_unit = ref_direction / (norm + EPSILON)

    # static budget: if the range needs more than n_ref_samples steps,
    # stretch the step to keep covering the full range (coarser sampling)
    step = jnp.maximum(params.ref_step_size,
                       norm / (n_ref_samples - 1))
    n_samples = jnp.floor(norm / step).astype(jnp.int32)

    # key-side patch direction; step size scales with inverse-depth ratio
    key_step_size = ratio * step
    d_key = x_key - e_key
    aligned = jnp.dot(ref_direction, d_key) > 0.0
    key_dir = jnp.where(aligned, 1.0, -1.0) * _normalize_vec(d_key)

    # key patch in-range test via its two ENDPOINTS (+-2 steps): the image
    # box is convex, so both endpoints in range <=> all 5 samples in range
    half = jnp.asarray(N_KEY_SAMPLES // 2, f32)
    e0x = ((x_key[0] - half * key_step_size * key_dir[0])
           * key_focal[0] + key_offset[0])
    e0y = ((x_key[1] - half * key_step_size * key_dir[1])
           * key_focal[1] + key_offset[1])
    e1x = ((x_key[0] + half * key_step_size * key_dir[0])
           * key_focal[0] + key_offset[0])
    e1y = ((x_key[1] + half * key_step_size * key_dir[1])
           * key_focal[1] + key_offset[1])
    flag_key_oob = jnp.logical_not(_in_image_xy(e0x, e0y, key_shape)
                                   & _in_image_xy(e1x, e1y, key_shape))

    flag_too_short = n_samples < N_KEY_SAMPLES
    u_near = x_min_ref * ref_focal + ref_offset
    x_far = x_min_ref + (n_samples.astype(f32) - 1.0) * step * ref_dir_unit
    u_far = x_far * ref_focal + ref_offset
    flag_close_oob = jnp.logical_not(
        _in_image_xy(u_near[0], u_near[1], ref_shape))
    flag_far_oob = jnp.logical_not(_in_image(u_far, ref_shape))

    return PixelGeoScalars(
        x_key_x=x_key[0], x_key_y=x_key[1],
        x_min_ref_x=x_min_ref[0], x_min_ref_y=x_min_ref[1],
        ref_dir_x=ref_dir_unit[0], ref_dir_y=ref_dir_unit[1],
        key_dir_x=key_dir[0], key_dir_y=key_dir[1],
        step=step, key_step_size=key_step_size, n_samples=n_samples,
        min_depth=min_depth, max_depth=max_depth,
        flag_neg_ref=flag_neg_ref, flag_key_oob=flag_key_oob,
        flag_too_short=flag_too_short, flag_close_oob=flag_close_oob,
        flag_far_oob=flag_far_oob)


def pixel_geometry_map(us_x, us_y, prior_inv_depth, prior_variance, T_rk,
                       e_key, key_focal, key_offset, key_shape,
                       ref_focal, ref_offset, ref_shape,
                       params: SemiDenseParams, n_ref_samples: int):
    """Whole-map componentwise :func:`_pixel_geometry` for ONE refframe.

    Same math, but written as plain (N,)-array component code instead of
    a per-pixel vmap: vmapping the scalar form turns every internal
    2/3-vector (``jnp.array([...])``, ``jnp.linalg.norm``) into an
    (N, 2)/(N, 3) tensor with a tiny minor dimension.  Callers run this
    once per ACTIVE
    refframe (T_rk is a single 4x4) and merge by age index.
    """
    f32 = us_x.dtype

    lo, hi = clamped_range(prior_inv_depth, prior_variance,
                           params.min_inv_depth, params.max_inv_depth)
    min_depth = safe_invert(hi)
    max_depth = safe_invert(lo)

    xk_x = (us_x - key_offset[0]) / key_focal[0]
    xk_y = (us_y - key_offset[1]) / key_focal[1]

    R = get_rotation(T_rk)
    t = get_translation(T_rk)
    # rows of R applied to the homogeneous key ray (xk_x, xk_y, 1)
    r0 = R[0, 0] * xk_x + R[0, 1] * xk_y + R[0, 2]
    r1 = R[1, 0] * xk_x + R[1, 1] * xk_y + R[1, 2]
    r2 = R[2, 0] * xk_x + R[2, 1] * xk_y + R[2, 2]

    def warp_xy(depth):
        """x/y of _warp_point(T_rk, x_key, depth), componentwise."""
        z = depth * r2 + t[2]
        return ((depth * r0 + t[0]) / (z + EPSILON),
                (depth * r1 + t[1]) / (z + EPSILON))

    # step ratio: step size on key scales with inverse-depth ratio
    prior_depth = safe_invert(prior_inv_depth)
    ref_depth = prior_depth * r2 + t[2]           # _calc_ref_depth
    flag_neg_ref = ref_depth <= 0.0
    ratio = prior_inv_depth / safe_invert(jnp.maximum(ref_depth, EPSILON))

    # epipolar segment endpoints on the ref normalized plane
    xmin_x, xmin_y = warp_xy(min_depth)
    xmax_x, xmax_y = warp_xy(max_depth)
    rdx = xmax_x - xmin_x
    rdy = xmax_y - xmin_y
    norm = jnp.sqrt(rdx * rdx + rdy * rdy)
    ref_dir_x = rdx / (norm + EPSILON)
    ref_dir_y = rdy / (norm + EPSILON)

    # static budget: if the range needs more than n_ref_samples steps,
    # stretch the step to keep covering the full range (coarser sampling)
    step = jnp.maximum(params.ref_step_size, norm / (n_ref_samples - 1))
    n_samples = jnp.floor(norm / step).astype(jnp.int32)

    # key-side patch direction; step size scales with inverse-depth ratio
    key_step_size = ratio * step
    dk_x = xk_x - e_key[0]
    dk_y = xk_y - e_key[1]
    aligned = rdx * dk_x + rdy * dk_y > 0.0
    dkn = jnp.sqrt(dk_x * dk_x + dk_y * dk_y)
    dkz = dkn == 0.0
    sign = jnp.where(aligned, 1.0, -1.0)
    key_dir_x = sign * jnp.where(dkz, dk_x, dk_x / jnp.where(dkz, 1.0, dkn))
    key_dir_y = sign * jnp.where(dkz, dk_y, dk_y / jnp.where(dkz, 1.0, dkn))

    # key patch in-range test via its two ENDPOINTS (+-2 steps)
    half = jnp.asarray(N_KEY_SAMPLES // 2, f32)
    e0x = (xk_x - half * key_step_size * key_dir_x) * key_focal[0] \
        + key_offset[0]
    e0y = (xk_y - half * key_step_size * key_dir_y) * key_focal[1] \
        + key_offset[1]
    e1x = (xk_x + half * key_step_size * key_dir_x) * key_focal[0] \
        + key_offset[0]
    e1y = (xk_y + half * key_step_size * key_dir_y) * key_focal[1] \
        + key_offset[1]
    flag_key_oob = jnp.logical_not(_in_image_xy(e0x, e0y, key_shape)
                                   & _in_image_xy(e1x, e1y, key_shape))

    flag_too_short = n_samples < N_KEY_SAMPLES
    un_x = xmin_x * ref_focal[0] + ref_offset[0]
    un_y = xmin_y * ref_focal[1] + ref_offset[1]
    nsf = n_samples.astype(f32) - 1.0
    uf_x = (xmin_x + nsf * step * ref_dir_x) * ref_focal[0] + ref_offset[0]
    uf_y = (xmin_y + nsf * step * ref_dir_y) * ref_focal[1] + ref_offset[1]
    flag_close_oob = jnp.logical_not(_in_image_xy(un_x, un_y, ref_shape))
    flag_far_oob = jnp.logical_not(_in_image_xy(uf_x, uf_y, ref_shape))

    return PixelGeoScalars(
        x_key_x=xk_x, x_key_y=xk_y,
        x_min_ref_x=xmin_x, x_min_ref_y=xmin_y,
        ref_dir_x=ref_dir_x, ref_dir_y=ref_dir_y,
        key_dir_x=key_dir_x, key_dir_y=key_dir_y,
        step=step, key_step_size=key_step_size, n_samples=n_samples,
        min_depth=min_depth, max_depth=max_depth,
        flag_neg_ref=flag_neg_ref, flag_key_oob=flag_key_oob,
        flag_too_short=flag_too_short, flag_close_oob=flag_close_oob,
        flag_far_oob=flag_far_oob)


def _pixel_estimate(geo: PixelGeoScalars, key_intensities, ref_intensities,
                    grad, prior_inv_depth, prior_variance, T_rk,
                    params: SemiDenseParams):
    """Per-pixel estimation from sampled intensities (vmappable)."""
    f32 = key_intensities.dtype
    x_key = jnp.stack([geo.x_key_x, geo.x_key_y])
    x_min_ref = jnp.stack([geo.x_min_ref_x, geo.x_min_ref_y])
    ref_dir_unit = jnp.stack([geo.ref_dir_x, geo.ref_dir_y])

    key_gradient = jnp.linalg.norm(gradient1d(key_intensities))
    flag_insufficient = key_gradient < params.min_gradient

    match_idx = _ssd_search(ref_intensities, key_intensities, geo.n_samples)
    x_ref_match = (x_min_ref
                   + match_idx.astype(f32) * geo.step * ref_dir_unit)

    key_depth = calc_depth0(T_rk, x_key, x_ref_match)
    new_inv_depth = safe_invert(key_depth)

    # variance model
    alpha = _calc_alpha(T_rk, x_key, (geo.min_depth, geo.max_depth),
                        key_depth)
    t_rk = get_translation(T_rk)
    geo_v = _geo_var(x_key, t_rk, grad)
    photo = _photo_var(key_gradient / (geo.key_step_size + EPSILON))
    a2 = alpha * alpha
    variance = a2 * (params.geo_coeff ** 2 * geo_v
                     + params.photo_coeff ** 2 * photo)

    result_flag = check_args_flag(new_inv_depth, variance,
                                  params.min_inv_depth, params.max_inv_depth)

    # priority chain, earliest failure wins (matches reference exit order)
    flag = result_flag
    flag = jnp.where(geo.flag_far_oob,
                     jnp.int32(Flag.REF_FAR_OUT_OF_RANGE), flag)
    flag = jnp.where(geo.flag_close_oob,
                     jnp.int32(Flag.REF_CLOSE_OUT_OF_RANGE), flag)
    flag = jnp.where(geo.flag_too_short,
                     jnp.int32(Flag.REF_EPIPOLAR_TOO_SHORT), flag)
    flag = jnp.where(flag_insufficient,
                     jnp.int32(Flag.INSUFFICIENT_GRADIENT), flag)
    flag = jnp.where(geo.flag_key_oob,
                     jnp.int32(Flag.KEY_OUT_OF_RANGE), flag)
    flag = jnp.where(geo.flag_neg_ref,
                     jnp.int32(Flag.NEGATIVE_REF_DEPTH), flag)

    success = flag == jnp.int32(Flag.SUCCESS)
    out_inv_depth = jnp.where(success, new_inv_depth, prior_inv_depth)
    out_variance = jnp.where(success, variance, prior_variance)
    return out_inv_depth, out_variance, flag


def estimate_pixel(u_key, prior_inv_depth, prior_variance,
                   T_rk, e_key,
                   key_focal, key_offset, key_image,
                   ref_focal, ref_offset, ref_images, ref_index,
                   grad_x_map, grad_y_map,
                   params: SemiDenseParams, n_ref_samples: int):
    """One pixel's inverse-depth update.  Returns (inv_depth, variance, flag).

    ``ref_images`` is the full (R, H, W) stack; ``ref_index`` the scalar
    frame choice for this pixel.  Mirrors estimate() (semi_dense.rs:91-158)
    as straight-line masked code.

    NOTE: image sampling here runs per pixel — fine for single-pixel use
    (estimate_debug); ``update_depth`` instead batches the gathers across
    the whole map OUTSIDE the per-pixel vmap.
    """
    key_shape = key_image.shape
    ref_shape = ref_images.shape[1:]
    f32 = u_key.dtype

    geo = _pixel_geometry(u_key, prior_inv_depth, prior_variance, T_rk,
                          e_key, key_focal, key_offset, key_shape,
                          ref_focal, ref_offset, ref_shape,
                          params, n_ref_samples)
    steps = jnp.arange(-(N_KEY_SAMPLES // 2), N_KEY_SAMPLES // 2 + 1,
                       dtype=f32)
    us_key_x, us_key_y = _key_coords(geo, steps, key_focal, key_offset)
    idx = jnp.arange(n_ref_samples, dtype=f32)
    us_ref_x, us_ref_y = _ref_coords(geo, idx, ref_focal[0], ref_focal[1],
                                     ref_offset[0], ref_offset[1])
    key_intensities = _interp_image_xy(key_image, us_key_x, us_key_y)
    ref_intensities = _interp_stack_xy(ref_images, ref_index,
                                       us_ref_x, us_ref_y)
    ux = jnp.clip(u_key[0].astype(jnp.int32), 0, key_shape[1] - 1)
    uy = jnp.clip(u_key[1].astype(jnp.int32), 0, key_shape[0] - 1)
    grad = jnp.stack([grad_x_map[uy, ux], grad_y_map[uy, ux]])
    return _pixel_estimate(geo, key_intensities, ref_intensities, grad,
                           prior_inv_depth, prior_variance, T_rk, params)


@partial(jax.jit, static_argnames=("n_ref_samples",))
def estimate_debug(u_key, prior_depth, prior_variance,
                   keyframe: SemiDenseFrame, refframe: SemiDenseFrame,
                   params: SemiDenseParams,
                   n_ref_samples: int = DEFAULT_N_REF_SAMPLES):
    """Single-pixel debug entry: (depth, variance, flag) for one pixel.

    Mirrors ``estimate_debug_`` (/root/reference/src/py/semi_dense.rs:235-246)
    which the reference's tests use to drive every per-pixel failure flag
    (/root/reference/tests/vo/semi_dense/test_semi_dense.py:76-149).
    ``u_key`` is an (x, y) pixel coordinate; priors are plain depth/variance.
    """
    f32 = keyframe.image.dtype
    T_wk = keyframe.transform_wf
    T_wr = refframe.transform_wf
    T_rk = inv_motion_matrix(T_wr) @ T_wk
    e_key = calc_key_epipole(T_wk, T_wr)
    gx = sobel_x(keyframe.image, mode="zero")
    gy = sobel_y(keyframe.image, mode="zero")

    u = jnp.asarray(u_key, dtype=f32)
    prior_inv = safe_invert(jnp.asarray(prior_depth, dtype=f32))
    prior_var = jnp.asarray(prior_variance, dtype=f32)

    inv_d, var, flag = estimate_pixel(
        u, prior_inv, prior_var, T_rk, e_key,
        keyframe.focal_length, keyframe.offset, keyframe.image,
        refframe.focal_length, refframe.offset, refframe.image[None],
        jnp.int32(0), gx, gy, params, n_ref_samples)

    # prior validity takes precedence, as in estimate() (semi_dense.rs:91-103)
    prior_flag = check_args_flag(prior_inv, prior_var,
                                 params.min_inv_depth, params.max_inv_depth)
    prior_bad = prior_flag != jnp.int32(Flag.SUCCESS)
    flag = jnp.where(prior_bad, prior_flag, flag)
    inv_d = jnp.where(prior_bad, prior_inv, inv_d)
    var = jnp.where(prior_bad, prior_var, var)
    return safe_invert(inv_d), var, flag


def calc_key_epipole(T_wk, T_wr):
    """Projection of the ref camera center into the keyframe (epipolar.rs:9)."""
    t_wk = get_translation(T_wk)
    t_wr = get_translation(T_wr)
    R_kw = get_rotation(inv_motion_matrix(T_wk))
    p_key = R_kw @ (t_wr - t_wk)
    return p_key[:2] / (p_key[2] + EPSILON)


@partial(jax.jit, static_argnames=("n_ref_samples", "fuse_prior"))
def update_depth(keyframe: SemiDenseFrame, refframes: SemiDenseFrame,
                 age_map, prior_depth, prior_variance,
                 params: SemiDenseParams,
                 n_ref_samples: int = DEFAULT_N_REF_SAMPLES,
                 row_offset=0, fuse_prior=False):
    """Full-map inverse-depth update.

    keyframe: single frame; refframes: stacked history (leading axis R,
    oldest first).  age selects ``refframes[R - age]`` per pixel
    (semi_dense.rs:207).  Returns (depth_map, variance_map, flag_map).

    The prior/age maps may be a row-block of the full image (multi-chip
    sharding: each device owns H/n rows); ``row_offset`` is the block's
    first global row so pixel coordinates stay global.  The key/ref images
    are always the full frames.
    """
    H, W = prior_depth.shape
    R_frames = refframes.image.shape[0]
    f32 = keyframe.image.dtype

    T_wk = keyframe.transform_wf
    # per-refframe relative transform and epipole, precomputed once
    T_rk_all = jax.vmap(
        lambda T_wr: inv_motion_matrix(T_wr) @ T_wk)(refframes.transform_wf)
    e_key_all = jax.vmap(
        lambda T_wr: calc_key_epipole(T_wk, T_wr))(refframes.transform_wf)

    gx = sobel_x(keyframe.image, mode="zero")
    gy = sobel_y(keyframe.image, mode="zero")

    xs = jnp.arange(W, dtype=f32)
    ys = jnp.arange(H, dtype=f32) + jnp.asarray(row_offset, f32)
    X, Y = jnp.meshgrid(xs, ys)
    us = jnp.stack([X.ravel(), Y.ravel()], axis=-1)     # (H*W, 2)

    age = age_map.ravel().astype(jnp.int32)
    prior_d = prior_depth.ravel().astype(f32)
    prior_v = prior_variance.ravel().astype(f32)
    prior_inv = safe_invert(prior_d)

    ridx = jnp.clip(R_frames - age, 0, R_frames - 1)

    # Layout discipline for every LARGE per-pixel tensor: the pixel axis N
    # must be the MINOR (last) dimension: column-major (5, N) / (16, N) /
    # (S, N) shapes keep memory access contiguous along pixels, where an
    # (N, 5) or (N, 4, 4) tensor strides over a tiny minor dimension.
    T_cols = T_rk_all.reshape(R_frames, 16).T[:, ridx]       # (16, N)
    e_cols = e_key_all.T[:, ridx]                            # (2, N)
    rf_cols = refframes.focal_length.T[:, ridx]              # (2, N)
    ro_cols = refframes.offset.T[:, ridx]                    # (2, N)

    key_shape = keyframe.image.shape
    ref_shape = refframes.image.shape[1:]

    # stage 1 (vmapped over pixels): pure geometry, SCALAR outputs only —
    # every field comes out (N,), so no vmap-chosen minor layout can leak
    # into the gather indices (see PixelGeoScalars)
    geo = jax.vmap(
        lambda u, pi, pv, T16, e, rf, ro: _pixel_geometry(
            u, pi, pv, T16.reshape(4, 4), e, keyframe.focal_length,
            keyframe.offset, key_shape, rf, ro, ref_shape, params,
            n_ref_samples),
        in_axes=(0, 0, 0, 1, 1, 1, 1), out_axes=0,
    )(us, prior_inv, prior_v, T_cols, e_cols, rf_cols, ro_cols)

    # stage 2 (batched, NOT vmapped): sample coordinates built by
    # broadcasting the (N,) scalars against the sample axis — (5, N) /
    # (S, N) row-major by construction — then all image gathers at once
    steps = jnp.arange(-(N_KEY_SAMPLES // 2), N_KEY_SAMPLES // 2 + 1,
                       dtype=f32)[:, None]                        # (5, 1)
    us_key_x, us_key_y = _key_coords(geo, steps, keyframe.focal_length,
                                     keyframe.offset)             # (5, N)
    idx = jnp.arange(n_ref_samples, dtype=f32)[:, None]           # (S, 1)
    us_ref_x, us_ref_y = _ref_coords(geo, idx, rf_cols[0], rf_cols[1],
                                     ro_cols[0], ro_cols[1])      # (S, N)
    key_int = _interp_image_xy(keyframe.image, us_key_x, us_key_y)
    ref_int = _interp_stack_xy(refframes.image, ridx[None, :],
                               us_ref_x, us_ref_y)                # (S, N)
    ux = jnp.clip(us[:, 0].astype(jnp.int32), 0, key_shape[1] - 1)
    uy = jnp.clip(us[:, 1].astype(jnp.int32), 0, key_shape[0] - 1)
    flat_idx = uy * key_shape[1] + ux
    grad = jnp.stack([jnp.take(gx.ravel(), flat_idx, mode="clip"),
                      jnp.take(gy.ravel(), flat_idx, mode="clip")],
                     axis=0)                                     # (2, N)

    # stage 3 (vmapped over the minor axis): SSD, depth, variance, flags
    def post(g, ki, ri, gr, p_inv, p_var, T16, a):
        inv_d, var, flag = _pixel_estimate(g, ki, ri, gr, p_inv, p_var,
                                           T16.reshape(4, 4), params)
        prior_flag = check_args_flag(p_inv, p_var, params.min_inv_depth,
                                     params.max_inv_depth)
        prior_bad = prior_flag != jnp.int32(Flag.SUCCESS)
        not_processed = a == 0

        flag = jnp.where(prior_bad, prior_flag, flag)
        flag = jnp.where(not_processed, jnp.int32(Flag.NOT_PROCESSED), flag)
        keep_prior = jnp.logical_or(not_processed, prior_bad)
        inv_d = jnp.where(keep_prior, p_inv, inv_d)
        var = jnp.where(keep_prior, p_var, var)
        if fuse_prior:
            # LSD-SLAM depth-filter update: fuse the new observation with
            # the prior instead of replacing it (see sweep.py::
            # postprocess_map — the reference replaces, which degrades
            # the map toward single-frame matching noise)
            from tadataka_tpu.vo.semi_dense.fusion import fusion
            f_mu, f_var = fusion(inv_d, p_inv, var, p_var)
            succ = flag == jnp.int32(Flag.SUCCESS)
            inv_d = jnp.where(succ, f_mu, inv_d)
            var = jnp.where(succ, f_var, var)
        return safe_invert(inv_d), var, flag

    depth, variance, flags = jax.vmap(
        post, in_axes=(0, 1, 1, 1, 0, 0, 1, 0), out_axes=0)(
        geo, key_int, ref_int, grad, prior_inv, prior_v, T_cols, age)
    return (depth.reshape(H, W), variance.reshape(H, W),
            flags.reshape(H, W))
