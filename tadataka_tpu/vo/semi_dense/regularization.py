"""3x3 inverse-variance-weighted depth smoothing over SUCCESS pixels.

Parity surface: /root/reference/src/semi_dense/regularization.rs (written but
disabled in the reference, mod.rs:13; enabled here — as two 3x3 box-filter
convolutions it is nearly free).
"""

import jax
import jax.numpy as jnp

from tadataka_tpu.flags import Flag
from tadataka_tpu.vo.semi_dense.estimator import safe_invert


def _box3(x):
    """SAME zero-padded 3x3 box sum as separable shifts + adds (see
    core/gradients.py)."""
    p = jnp.pad(x, ((0, 0), (1, 1)))
    h = p[:, :-2] + p[:, 1:-1] + p[:, 2:]
    p2 = jnp.pad(h, ((1, 1), (0, 0)))
    return p2[:-2] + p2[1:-1] + p2[2:]


@jax.jit
def regularize(depth_map, variance_map, flag_map):
    """Weighted 3x3 smoothing of inverse depth; non-SUCCESS pixels keep
    their value and contribute nothing."""
    success = (flag_map == int(Flag.SUCCESS)).astype(depth_map.dtype)
    inv_depth = safe_invert(depth_map)
    inv_var = safe_invert(variance_map) * success

    numerator = _box3(inv_depth * inv_var)
    denominator = _box3(inv_var)

    smoothed = safe_invert(numerator / jnp.maximum(denominator, 1e-12))
    return jnp.where(denominator > 0, smoothed, depth_map)
