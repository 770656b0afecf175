"""Image gradients: Sobel, central differences, 1-D forward differences.

Parity surface: /root/reference/src/gradient.rs (zero-padded Sobel used by the
semi-dense pipeline), /root/reference/tadataka/gradient.py (scipy reflect-mode
Sobel used by curvature), and np.gradient as used by DVO
(/root/reference/tadataka/vo/dvo/jacobian.py:27).

All are expressed as separable static shifts + FMAs rather than as a
single-channel 3x3 ``lax.conv``: the shifts fuse into the surrounding
elementwise work.
"""

import jax.numpy as jnp


def _sobel_x_valid(image):
    """VALID-region Sobel d/dx via the separable [1,2,1]^T (x) [-1,0,1]."""
    dx = image[:, 2:] - image[:, :-2]          # (H, W-2)
    return dx[:-2] + 2.0 * dx[1:-1] + dx[2:]   # (H-2, W-2)


def _sobel_y_valid(image):
    dy = image[2:, :] - image[:-2, :]          # (H-2, W)
    return dy[:, :-2] + 2.0 * dy[:, 1:-1] + dy[:, 2:]


def sobel_x(image, mode="zero"):
    """d/dx Sobel (smoothed, unnormalized — 4x the central difference).

    mode="zero": zero border like the Rust kernels (src/gradient.rs:4-26,
    sign-flipped to the standard positive-x convention);
    mode="reflect": scipy-compatible borders (tadataka/gradient.py:4).
    """
    return _apply_sobel(image, _sobel_x_valid, mode)


def sobel_y(image, mode="zero"):
    return _apply_sobel(image, _sobel_y_valid, mode)


def _apply_sobel(image, valid_fn, mode):
    if mode == "zero":
        return jnp.pad(valid_fn(image), 1)
    if mode == "reflect":
        # scipy.ndimage's "reflect" repeats the edge sample — numpy/jnp call
        # that "symmetric"
        return valid_fn(jnp.pad(image, 1, mode="symmetric"))
    raise ValueError(f"unknown border mode {mode!r}")


def grad_x(image):
    """scipy.ndimage.sobel(axis=1, mode='reflect') equivalent."""
    return sobel_x(image, mode="reflect")


def grad_y(image):
    return sobel_y(image, mode="reflect")


def np_gradient_2d(image):
    """np.gradient for 2-D arrays: central differences, one-sided edges.

    Returns (DX, DY) in the DVO convention (x-derivative first), matching
    calc_image_gradient (/root/reference/tadataka/vo/dvo/jacobian.py:27-29).
    """
    DY = _central_diff(image, axis=0)
    DX = _central_diff(image, axis=1)
    return DX, DY


def _central_diff(a, axis):
    upper = jnp.roll(a, -1, axis=axis)
    lower = jnp.roll(a, 1, axis=axis)
    interior = (upper - lower) / 2.0
    # one-sided at the borders
    first = jnp.take(a, jnp.array([1]), axis=axis) - \
        jnp.take(a, jnp.array([0]), axis=axis)
    last = jnp.take(a, jnp.array([a.shape[axis] - 1]), axis=axis) - \
        jnp.take(a, jnp.array([a.shape[axis] - 2]), axis=axis)
    out = interior
    idx_first = [slice(None)] * a.ndim
    idx_first[axis] = slice(0, 1)
    idx_last = [slice(None)] * a.ndim
    idx_last[axis] = slice(a.shape[axis] - 1, a.shape[axis])
    out = out.at[tuple(idx_first)].set(first)
    out = out.at[tuple(idx_last)].set(last)
    return out


def gradient1d(x):
    """Forward differences along the last axis: out[i] = x[i+1] - x[i].

    Parity: /root/reference/src/gradient.rs:28-35.  Output length n-1.
    """
    return x[..., 1:] - x[..., :-1]
