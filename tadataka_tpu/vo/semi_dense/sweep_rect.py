"""Rectified plane-sweep semi-dense depth update — the path for wide
lateral baselines.

Same per-pixel algorithm as the scattered estimator (estimator.py; the
reference's /root/reference/src/semi_dense/semi_dense.rs:91-158 +
intensities.rs:11-37), re-parametrized through stereo rectification
(rectify.py) so that NOTHING on the hot path is a gather:

  - rectify key/ref onto a common grid whose epipolar lines are
    horizontal scanlines — per-pair rotation warps with bounded
    displacement, executed as tent-weighted shift sums
    (core/shiftwarp.py::rot_warp);
  - in rectified space the sample at inverse depth q sits at
    (x - fB q, y): the sweep over inverse-depth planes is a sweep over
    integer DISPARITY planes — per-plane constant 1-px shifts (slices);
  - the reference's key template (epipolar.rs:22, 5 samples along the
    key line) becomes 5 horizontal 1-px shifts of the rectified key
    image: the key/ref arc-length ratio (semi_dense.rs:27) is exactly 1
    in rectified coordinates because both rectified cameras share Z;
  - the windowed normalized-SSD search + masked argmin runs in
    sweep.py::ssd_search with the +-2 sigma
    prior range (hypothesis.rs:15) mapped to per-pixel disparity-window
    bounds (disparity is linear in inverse depth);
  - parabolic subpixel interpolation of the SSD minimum recovers
    disparity below the 1-px plane spacing;
  - matched inverse depth, no-match and gradient maps are warped back to
    the key grid by the forward rotation warp, and depth / variance /
    flags come from the shared stage C (sweep.py::postprocess_pixel —
    semi_dense.rs:105-158, variance.rs).

Host-side gating: the rectifying rotation must fit the shift-warp
displacement budget (fails for near-forward / vertical baselines);
`update_depth_fast` checks each pair with `rectification_feasible` and
falls back to the scattered estimator when infeasible.
"""

from functools import partial

import jax
import jax.numpy as jnp

from tadataka_tpu.core.gradients import sobel_x, sobel_y
from tadataka_tpu.core.transforms import inv_motion_matrix
from tadataka_tpu.core.shiftwarp import rot_warp, const_shift_cols
from tadataka_tpu.vo.semi_dense.estimator import (
    EPSILON, safe_invert, pixel_geometry_map, calc_key_epipole)
from tadataka_tpu.vo.semi_dense.hypothesis import clamped_range
from tadataka_tpu.vo.semi_dense.params import SemiDenseParams, N_KEY_SAMPLES
from tadataka_tpu.vo.semi_dense.rectify import make_rectification
from tadataka_tpu.vo.semi_dense.sweep import (
    ssd_search, postprocess_map, _INF)

DEFAULT_N_PLANES = 64
DEFAULT_MAX_DX = 32
DEFAULT_MAX_DY = 32
_PLANE_TOL = 0.5      # half-plane window slack (matches sweep.py)


def _flip_x(arr):
    return jnp.flip(arr, axis=-1)


def _shift_stack(base, n, fill):
    """(n, H, W) stack: out[j, :, x] = base[:, x - j] (constant fill)."""
    H, W = base.shape
    padded = jnp.pad(base, ((0, 0), (n, 0)), constant_values=fill)
    return jnp.stack([padded[:, n - j:n - j + W] for j in range(n)])


def _key_template(key_rect, fill=-1.0):
    """(5, H, W) template: K[i, :, x] = key_rect[:, x - (i - 2)].

    Sample i of ref window m is plane m+i, whose rectified-x decreases by
    1 px per i; the matching key-side walk is 1 px in the same direction
    (ratio = 1 in rectified space)."""
    H, W = key_rect.shape
    half = N_KEY_SAMPLES // 2
    padded = jnp.pad(key_rect, ((0, 0), (half, half)), constant_values=fill)
    return jnp.stack([padded[:, half - k:half - k + W]
                      for k in range(-half, half + 1)])


@partial(jax.jit,
         static_argnames=("n_planes", "flips", "max_dx", "max_dy",
                          "fuse_prior"))
def update_depth_rect(keyframe, refframes, age_map, prior_depth,
                      prior_variance, params: SemiDenseParams,
                      n_planes: int = DEFAULT_N_PLANES,
                      flips=(False,),
                      max_dx: int = DEFAULT_MAX_DX,
                      max_dy: int = DEFAULT_MAX_DY,
                      fuse_prior=False):
    """Full-map inverse-depth update via rectified disparity sweep.

    Same contract as estimator.update_depth (semi_dense.rs:160-237).
    ``flips`` is the per-refframe baseline-sign tuple from the host
    (rectify.baseline_flip); use `update_depth_fast` to have it computed
    and feasibility-gated automatically.
    """
    H, W = prior_depth.shape
    R_frames = refframes.image.shape[0]
    f32 = keyframe.image.dtype
    assert len(flips) == R_frames

    T_wk = keyframe.transform_wf
    T_rk_all = jax.vmap(
        lambda T_wr: inv_motion_matrix(T_wr) @ T_wk)(refframes.transform_wf)
    e_key_all = jax.vmap(
        lambda T_wr: calc_key_epipole(T_wk, T_wr))(refframes.transform_wf)

    gx = sobel_x(keyframe.image, mode="zero")
    gy = sobel_y(keyframe.image, mode="zero")

    xs = jnp.arange(W, dtype=f32)
    ys = jnp.arange(H, dtype=f32)
    X, Y = jnp.meshgrid(xs, ys)
    us_x, us_y = X.ravel(), Y.ravel()

    age = age_map.ravel().astype(jnp.int32)
    prior_d = prior_depth.ravel().astype(f32)
    prior_v = prior_variance.ravel().astype(f32)
    prior_inv = safe_invert(prior_d)
    ridx = jnp.clip(R_frames - age, 0, R_frames - 1)

    key_shape = keyframe.image.shape
    ref_shape = refframes.image.shape[1:]

    def _select_ref(*per_ref):
        """Merge per-refframe (N,) arrays by each pixel's age index —
        a select chain, never a per-pixel transform gather (see
        sweep.py::update_depth_sweep)."""
        out = per_ref[0]
        for i in range(1, R_frames):
            out = jnp.where(ridx == i, per_ref[i], out)
        return out

    # stage A: per-pixel geometry scalars + failure flags on the KEY grid
    # (the componentwise whole-map form of the scattered estimator's
    # _pixel_geometry), per refframe + age select
    geos = [
        pixel_geometry_map(
            us_x, us_y, prior_inv, prior_v, T_rk_all[r], e_key_all[r],
            keyframe.focal_length, keyframe.offset, key_shape,
            refframes.focal_length[r], refframes.offset[r], ref_shape,
            params, n_planes)
        for r in range(R_frames)]
    geo = jax.tree.map(_select_ref, *geos)

    # +-2 sigma inverse-depth bounds on the key grid (hypothesis.rs:15)
    lo, hi = clamped_range(prior_inv, prior_v, params.min_inv_depth,
                           params.max_inv_depth)
    lo_map = lo.reshape(H, W)
    hi_map = hi.reshape(H, W)

    q_min = params.min_inv_depth.astype(f32)

    # per-refframe rectified sweep; per-pixel selection by age index
    q_star_map = jnp.zeros((H, W), f32)
    nomatch_map = jnp.ones((H, W), bool)
    kgrad_map = jnp.zeros((H, W), f32)
    ridx_map = ridx.reshape(H, W)
    for r in range(R_frames):
        rect = make_rectification(
            T_rk_all[r], keyframe.focal_length, keyframe.offset,
            refframes.focal_length[r], refframes.offset[r], flips[r])

        key_batch = jnp.stack([keyframe.image, lo_map, hi_map])
        key_rect_b, key_valid = rot_warp(key_batch, rect.H_key_inv,
                                         max_dx, max_dy, fill=-1.0)
        ref_rect, _ = rot_warp(refframes.image[r], rect.H_ref_inv,
                               max_dx, max_dy, fill=-1.0)
        # depth re-projection factor of the rectifying rotation, on the
        # UNFLIPPED rect grid: v_z = Z_key / Z_rect per pixel (see
        # Rectification) — disparity(q) = fB * v_z * q
        xs_n = (jnp.arange(W, dtype=f32)[None, :]
                - keyframe.offset[0]) / keyframe.focal_length[0]
        ys_n = (jnp.arange(H, dtype=f32)[:, None]
                - keyframe.offset[1]) / keyframe.focal_length[1]
        vz = (rect.vz[0] * xs_n + rect.vz[1] * ys_n
              + rect.vz[2] * jnp.ones((H, W), f32))

        if flips[r]:
            key_rect_b = _flip_x(key_rect_b)
            key_valid = _flip_x(key_valid)
            ref_rect = _flip_x(ref_rect)
            vz = _flip_x(vz)
        key_rect, lo_r, hi_r = key_rect_b

        # disparity plane grid: delta_j = delta0 + j, delta = fB * vz * q.
        # Starts half_w planes BELOW the smallest valid disparity so the
        # 5-plane template window exists for priors at the far-depth end
        # (without this, tight priors near max depth can never match).
        delta0 = rect.fB * q_min * jnp.min(vz) - (N_KEY_SAMPLES // 2)
        base = const_shift_cols(ref_rect, -delta0, fill=-1.0)
        V = _shift_stack(base, n_planes, fill=-1.0)           # (S, H, W)
        K = _key_template(key_rect)                           # (5, H, W)
        kgrad_rect = jnp.sqrt(jnp.sum(jnp.diff(K, axis=0) ** 2, axis=0))

        # per-pixel disparity window -> window-index bounds over planes
        half = N_KEY_SAMPLES // 2
        fB_eff = rect.fB * vz
        d_lo = fB_eff * lo_r - delta0
        d_hi = fB_eff * hi_r - delta0
        mlo = jnp.ceil(d_lo - _PLANE_TOL) - half
        mhi = jnp.floor(d_hi + _PLANE_TOL) - half
        key_ok = key_valid & jnp.all(K >= 0.0, axis=0)
        mlo = jnp.where(key_ok, mlo, 1e9)
        mhi = jnp.where(key_ok, mhi, -1e9)

        bm, ec, ep, en = ssd_search(V, K, mlo, mhi)

        # parabolic subpixel refinement in disparity units
        denom = ep - 2.0 * ec + en
        ok = (ep < _INF) & (en < _INF) & (jnp.abs(denom) > EPSILON)
        delta = jnp.where(
            ok, jnp.clip(0.5 * (ep - en) / jnp.where(ok, denom, 1.0),
                         -0.5, 0.5), 0.0)
        d_star = delta0 + bm.astype(f32) + half + delta
        q_rect = d_star / (fB_eff + EPSILON)
        nm_rect = (bm < 0).astype(f32)

        # back to the key grid: forward rotation warp of the result maps.
        # The disparity rides as a MATCH-WEIGHTED channel with the weight
        # alongside: renormalizing excludes no-match lanes from the
        # interpolation entirely instead of blending their placeholder
        # disparity into neighbors
        w_rect = 1.0 - nm_rect
        out_batch = jnp.stack([q_rect * w_rect, w_rect])
        if flips[r]:
            out_batch = _flip_x(out_batch)
        out_key, out_valid = rot_warp(out_batch, rect.H_key, max_dx, max_dy,
                                      fill=-1.0)
        w_key = out_key[1]
        q_r = out_key[0] / jnp.maximum(w_key, 1e-6)
        nm_r = (w_key < 0.5) | jnp.logical_not(out_valid)

        sel = ridx_map == r
        q_star_map = jnp.where(sel, q_r, q_star_map)
        nomatch_map = jnp.where(sel, nm_r, nomatch_map)

    q_star = jnp.clip(q_star_map.ravel(), lo, hi)
    no_match = nomatch_map.ravel()

    # Gradient gate at REFERENCE support, measured on the ORIGINAL key
    # image: the template's intensity variation over the +-2-step
    # epipolar walk is 2 * |dI/dpx . p| with p the per-sample pixel step
    # key_step_size * (dir * f).  (Measuring 1-px diffs on the RESAMPLED
    # rect grid and rescaling attenuates twice — bilinear resampling
    # low-passes the texture — and over-triggers INSUFFICIENT_GRADIENT
    # as the prior tightens; the scattered estimator samples the
    # original image, semi_dense.rs:134.)  The photometric variance
    # consumes the same (spacing-invariant) gradient density.
    from tadataka_tpu.core.gradients import np_gradient_2d
    gcx, gcy = np_gradient_2d(keyframe.image)
    px = geo.key_step_size * geo.key_dir_x * keyframe.focal_length[0]
    py = geo.key_step_size * geo.key_dir_y * keyframe.focal_length[1]
    kgrad_post = 2.0 * jnp.abs(gcx.ravel() * px + gcy.ravel() * py)
    ks_post = geo.key_step_size

    posts = [
        postprocess_map(q_star, no_match, kgrad_post, ks_post,
                        gx.ravel(), gy.ravel(), geo, prior_inv, prior_v,
                        T_rk_all[r], age, params=params,
                        fuse_prior=fuse_prior)
        for r in range(R_frames)]
    depth, variance, flags = (_select_ref(*[p[i] for p in posts])
                              for i in range(3))
    return (depth.reshape(H, W), variance.reshape(H, W),
            flags.reshape(H, W))


# Host-side planning and the three-way dispatcher (rect / tent / scatter)
# live in tadataka_tpu.vo.semi_dense.fast.
