"""Bilinear image interpolation at float (x, y) coordinates.

Parity surface: /root/reference/src/interpolation.rs:9-43 and
/root/reference/tadataka/interpolation/__init__.py.  Coordinates follow the
reference convention: c = [x, y] indexes image[y, x].

Design: implemented as four clipped gathers + lerp, natively batched over
any leading shape.  Out-of-range coordinates are clamped — callers that need
range semantics combine with ``is_in_image_range`` masks (the reference raised
ValueError instead; masks are the XLA-native equivalent).
"""

import jax.numpy as jnp


def interpolate(image, coordinates):
    """Sample image (H, W) at coordinates (..., 2) in [x, y] order.

    Returns intensities with shape coordinates.shape[:-1].  Coordinates are
    clamped to the valid bilinear domain, so every lane produces a finite
    value; range checking is the caller's concern (mask-based).
    """
    H, W = image.shape
    cx = coordinates[..., 0]
    cy = coordinates[..., 1]

    lx = jnp.floor(cx)
    ly = jnp.floor(cy)
    # fractional offsets before clipping so exact-integer coords are exact
    ax = cx - lx
    ay = cy - ly

    lx0 = jnp.clip(lx.astype(jnp.int32), 0, W - 1)
    ly0 = jnp.clip(ly.astype(jnp.int32), 0, H - 1)
    lx1 = jnp.clip(lx0 + 1, 0, W - 1)
    ly1 = jnp.clip(ly0 + 1, 0, H - 1)

    v00 = image[ly0, lx0]
    v01 = image[ly0, lx1]
    v10 = image[ly1, lx0]
    v11 = image[ly1, lx1]

    return ((1.0 - ax) * (1.0 - ay) * v00 + ax * (1.0 - ay) * v01
            + (1.0 - ax) * ay * v10 + ax * ay * v11)


def interpolate_checked(image, coordinates, fill=0.0):
    """Bilinear sample + in-range mask.

    Returns (values, mask) where mask marks coordinates inside
    [0, W-1] x [0, H-1] (float-inclusive, matching
    /root/reference/src/image_range.rs:11).  Out-of-range lanes get ``fill``.
    """
    from tadataka_tpu.core.image_range import is_in_image_range
    mask = is_in_image_range(coordinates, image.shape)
    values = interpolate(image, coordinates)
    return jnp.where(mask, values, fill), mask
