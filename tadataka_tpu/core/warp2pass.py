"""Axis-aligned two-pass image warps (homography / small displacement).

Why this exists: a resample along ONE image axis (``take_along_axis``)
is a far cheaper access pattern than a generic scattered 2-D gather, so
any warp that can be decomposed into a horizontal resample followed by a
vertical resample avoids the scattered form.

A homography admits an exact such decomposition (Catmull & Smith 1980,
"3-D transformations of images in scanline order"): with

    out(x', y') = img(U(x', y'), V(x', y')),
    U = (h00 x' + h01 y' + h02) / D,   V = (h10 x' + h11 y' + h12) / D,
    D = h20 x' + h21 y' + h22,

pass B (vertical, last) gathers rows at V, and pass A (horizontal) must
pre-place, on ref row y, the value img(a(x', y), y) with

    a(x', y) = U(x', V^-1_{x'}(y)),
    V^-1_{x'}(y) = (y (h20 x' + h22) - (h10 x' + h12)) / (h11 - y h21),

so that out(x', y') = img(a(x', V), V) = img(U, V).  Each pass interpolates
linearly along its own axis; the composition is a separable resampling of
the same sample positions (it differs from direct bilinear only by the
second-order cross term of the reconstruction filter, not in the sample
positions themselves).

The decomposition degenerates when |h11 - y h21| ~ 0 (a ~90-degree image
rotation).  Visual-odometry homographies are near-identity, far from that
regime; affected lanes are flagged invalid.

Used by the plane-sweep semi-dense estimator (vo/semi_dense/sweep.py):
the per-plane key->ref map x_ref = pi(R x_key~ + q t) is the plane-induced
homography K_ref (R + q t e3^T) K_key^-1, so the whole epipolar sampling
volume becomes S two-pass warps instead of S*H*W scattered gathers.
Replaces the role of the reference's per-pixel epipolar sampling loop
(/root/reference/src/semi_dense/epipolar.rs:38-54).
"""

import jax.numpy as jnp

EPSILON = 1e-16


def gather_rows_bilinear(img, y):
    """out[i, j] = img interpolated at (row=y[i, j], col=j).

    ``y`` is float, clamped to [0, H-1]; shapes of ``img`` and ``y`` match.
    """
    H = img.shape[0]
    yc = jnp.clip(y, 0.0, H - 1.0)
    y0 = jnp.floor(yc)
    ay = yc - y0
    y0i = y0.astype(jnp.int32)
    y1i = jnp.minimum(y0i + 1, H - 1)
    v0 = jnp.take_along_axis(img, y0i, axis=0)
    v1 = jnp.take_along_axis(img, y1i, axis=0)
    return (1.0 - ay) * v0 + ay * v1


def gather_cols_bilinear(img, x):
    """out[i, j] = img interpolated at (row=i, col=x[i, j])."""
    W = img.shape[1]
    xc = jnp.clip(x, 0.0, W - 1.0)
    x0 = jnp.floor(xc)
    ax = xc - x0
    x0i = x0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, W - 1)
    v0 = jnp.take_along_axis(img, x0i, axis=1)
    v1 = jnp.take_along_axis(img, x1i, axis=1)
    return (1.0 - ax) * v0 + ax * v1


def homography_warp(img, H33, out_shape=None, fill=-1.0, eps=1e-6):
    """Warp ``img`` by the pixel-space homography ``H33``: for every output
    pixel (x', y'), out = img(U, V) with (U, V, 1) ~ H33 @ (x', y', 1).

    Returns (warped, valid): ``valid`` marks lanes whose source coordinates
    are inside the image, in front of the projection plane (D > eps), and
    away from the decomposition singularity; invalid lanes hold ``fill``.
    """
    if out_shape is None:
        out_shape = img.shape
    Ho, Wo = out_shape
    Hi, Wi = img.shape
    f32 = img.dtype

    h00, h01, h02 = H33[0, 0], H33[0, 1], H33[0, 2]
    h10, h11, h12 = H33[1, 0], H33[1, 1], H33[1, 2]
    h20, h21, h22 = H33[2, 0], H33[2, 1], H33[2, 2]

    xo = jnp.arange(Wo, dtype=f32)[None, :]      # (1, Wo)
    yo = jnp.arange(Ho, dtype=f32)[:, None]      # (Ho, 1)

    # direct maps for validity and for pass B's row coordinate
    D = h20 * xo + h21 * yo + h22                # (Ho, Wo)
    U = (h00 * xo + h01 * yo + h02) / jnp.where(D == 0.0, eps, D)
    V = (h10 * xo + h11 * yo + h12) / jnp.where(D == 0.0, eps, D)

    # pass A: on ref row y, place img(a(x', y), y) at column x'
    yi = jnp.arange(Hi, dtype=f32)[:, None]      # (Hi, 1)
    denom_a = h11 - yi * h21                     # (Hi, 1)
    sing_a = jnp.abs(denom_a) < eps
    denom_a = jnp.where(sing_a, eps, denom_a)
    y_src = (yi * (h20 * xo + h22) - (h10 * xo + h12)) / denom_a  # (Hi, Wo)
    D_a = h20 * xo + h21 * y_src + h22
    a = (h00 * xo + h01 * y_src + h02) / jnp.where(D_a == 0.0, eps, D_a)
    tmp = gather_cols_bilinear(img, a)           # (Hi, Wo)

    # pass B: gather rows of tmp at V
    out = gather_rows_bilinear(tmp, V)           # (Ho, Wo)

    valid = ((D > eps)
             & (U >= 0.0) & (U <= Wi - 1.0)
             & (V >= 0.0) & (V <= Hi - 1.0))
    return jnp.where(valid, out, fill), valid


def displacement_warp(img, dx, dy):
    """out(x, y) ~ img(x + dx(x, y), y + dy(x, y)) for smooth, small
    per-pixel displacement fields.

    Two-pass: horizontal resample at x + dx, then vertical at y + dy.  The
    composition evaluates dx on the row gathered by the vertical pass, so
    the result deviates from the exact scattered sample by
    O(dy * d(dx)/dy) — negligible for the smooth few-pixel fields this is
    used for (semi-dense key-patch sampling).  Returns (values, valid).
    """
    Hi, Wi = img.shape
    f32 = img.dtype
    xo = jnp.arange(Wi, dtype=f32)[None, :]
    yo = jnp.arange(Hi, dtype=f32)[:, None]
    X = xo + dx
    Y = yo + dy
    tmp = gather_cols_bilinear(img, X)
    out = gather_rows_bilinear(tmp, Y)
    valid = ((X >= 0.0) & (X <= Wi - 1.0)
             & (Y >= 0.0) & (Y <= Hi - 1.0))
    return out, valid
