"""Rectified-stereo block-matching depth estimation.

Role in the reference: the semi-dense examples bootstrap depth from a
rectified stereo pair (/root/reference/examples/estimate_depth_from_stereo.py)
and the NewTsukuba fixtures are rectified stereo with baseline 10
(/root/reference/tadataka/dataset/new_tsukuba.py).  The reference has no
dedicated block matcher (it reads depth ground truth from XML); this module
supplies one so depth can be recovered from images alone — e.g. when the
ground-truth depth files are unavailable.

Design: the cost volume is built with whole-image shifts + a separable
box filter — pure elementwise ops and convolutions, zero gathers.  One
jitted program produces disparity, a validity mask, and depth.
"""

from functools import partial

import jax
import jax.numpy as jnp


def _box_filter(x, radius):
    """Separable (2r+1)^2 moving sum over the last two axes."""
    k = 2 * radius + 1
    # cumulative-sum moving window along rows then columns
    pad_rows = [(0, 0)] * (x.ndim - 2) + [(radius, radius), (0, 0)]
    pad_cols = [(0, 0)] * (x.ndim - 2) + [(0, 0), (radius, radius)]
    xr = jnp.pad(x, pad_rows)
    xr = jnp.cumsum(xr, axis=-2)
    top = jnp.concatenate(
        [jnp.zeros_like(xr[..., :1, :]), xr[..., :-k, :]], axis=-2)
    xr = xr[..., k - 1:, :] - top
    xc = jnp.pad(xr, pad_cols)
    xc = jnp.cumsum(xc, axis=-1)
    left = jnp.concatenate(
        [jnp.zeros_like(xc[..., :1]), xc[..., :-k]], axis=-1)
    return xc[..., k - 1:] - left


@partial(jax.jit, static_argnames=("max_disparity", "radius"))
def match_stereo(image_l, image_r, max_disparity=96, radius=3):
    """SSD block matching with subpixel refinement and an LR-check mask.

    image_l, image_r: (H, W) grayscale, rectified (epipolar lines = rows;
    the matching right pixel sits at ``x - disparity``).
    Returns (disparity, valid): (H, W) float disparity (subpixel) and a
    boolean mask (left-right consistent, textured, in-range).
    """
    H, W = image_l.shape
    f32 = image_l.dtype
    xs = jnp.arange(W)

    BIG = jnp.asarray(1e9, f32)

    def cost_at(d):
        # right image sampled at x - d; penalize windows that touch x-d < 0
        # AFTER the box filter (poisoning the squared diffs before the
        # cumulative-sum filter wrecks f32 precision of the valid sums)
        diff = image_l - jnp.roll(image_r, d, axis=1)
        cost = _box_filter(diff * diff, radius)
        return jnp.where(xs[None, :] - radius < d, BIG, cost)

    costs = jax.vmap(cost_at)(jnp.arange(max_disparity))      # (D, H, W)
    disp = jnp.argmin(costs, axis=0)                          # (H, W) int

    # subpixel parabola fit around the winner
    d0 = jnp.clip(disp, 1, max_disparity - 2)
    take = lambda off: jnp.take_along_axis(
        costs, (d0 + off)[None], axis=0)[0]
    c_m, c_0, c_p = take(-1), take(0), take(+1)
    denom = c_m - 2.0 * c_0 + c_p
    delta = jnp.where(jnp.abs(denom) > 1e-12,
                      0.5 * (c_m - c_p) / jnp.where(denom == 0, 1.0, denom),
                      0.0)
    disp_sub = d0.astype(f32) + jnp.clip(delta, -1.0, 1.0)

    # right-image disparity for the LR consistency check (match left at x+d)
    def cost_at_r(d):
        diff = image_r - jnp.roll(image_l, -d, axis=1)
        cost = _box_filter(diff * diff, radius)
        return jnp.where(xs[None, :] + radius + d > W - 1, BIG, cost)

    costs_r = jax.vmap(cost_at_r)(jnp.arange(max_disparity))
    disp_r = jnp.argmin(costs_r, axis=0)

    # disp_r sampled at (x - disp(x)) should equal disp(x)
    x_r = jnp.clip(xs[None, :] - disp, 0, W - 1)
    disp_r_at = jnp.take_along_axis(disp_r, x_r, axis=1)
    lr_ok = jnp.abs(disp_r_at - disp) <= 1

    # texture gate: flat blocks match everywhere
    grad_x = jnp.abs(jnp.diff(image_l, axis=1, prepend=image_l[:, :1]))
    textured = _box_filter(grad_x, radius) > 0.5 * (2 * radius + 1) ** 2 * 0.01

    in_range = (disp > 0) & (disp < max_disparity - 1) \
        & (xs[None, :] >= max_disparity)
    valid = lr_ok & textured & in_range
    return disp_sub, valid


def depth_from_disparity(disparity, focal_length_x, baseline):
    """depth = f_x * B / disparity (rectified pinhole stereo)."""
    return focal_length_x * baseline / jnp.maximum(disparity, 1e-6)


def estimate_depth_from_stereo(camera_params, image_l, image_r, baseline,
                               max_disparity=96, radius=3):
    """(depth_map, valid_mask) for a rectified stereo pair."""
    disp, valid = match_stereo(jnp.asarray(image_l, jnp.float32),
                               jnp.asarray(image_r, jnp.float32),
                               max_disparity=max_disparity, radius=radius)
    fx = jnp.asarray(camera_params.focal_length)[0]
    return depth_from_disparity(disp, fx, baseline), valid
