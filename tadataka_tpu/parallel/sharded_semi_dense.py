"""Multi-chip semi-dense depth update: pixel rows sharded across devices.

The per-pixel inverse-depth update is embarrassingly parallel (the reference
walks it serially, semi_dense.rs:186-228); on a mesh each device owns H/n
pixel rows of the prior/age maps while the (small) key/ref images replicate.

Design: an explicit ``shard_map`` rather than device_put + GSPMD inference —
each device runs ``update_depth`` on its local row block (with the block's
global row offset), so the compiled per-device program provably contains no
collectives; there is nothing for the partitioner to guess.
"""

from functools import partial

import jax
from jax.sharding import PartitionSpec as P

from tadataka_tpu.vo.semi_dense.estimator import update_depth
from tadataka_tpu.vo.semi_dense.params import DEFAULT_N_REF_SAMPLES

def _local_update(keyframe, refframes, age_map, prior_depth, prior_variance,
                  params, n_ref_samples, rows_per_device, axis):
    offset = jax.lax.axis_index(axis) * rows_per_device
    return update_depth(keyframe, refframes, age_map, prior_depth,
                        prior_variance, params,
                        n_ref_samples=n_ref_samples, row_offset=offset)


def sharded_update_depth(mesh, keyframe, refframes, age_map, prior_depth,
                         prior_variance, params,
                         n_ref_samples=DEFAULT_N_REF_SAMPLES):
    """update_depth with the pixel grid row-sharded over ``mesh``.

    Requires H to divide evenly by the mesh size (pad rows otherwise).
    Returns (depth_map, variance_map, flag_map), row-sharded.
    """
    f = make_sharded_update_depth(mesh, prior_depth.shape,
                                  n_ref_samples=n_ref_samples)
    return f(keyframe, refframes, age_map, prior_depth, prior_variance,
             params)


def make_sharded_update_depth(mesh, shape, n_ref_samples=DEFAULT_N_REF_SAMPLES):
    """Build the jitted row-sharded update for a (H, W) map shape."""
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    H, _W = shape
    if H % n != 0:
        raise ValueError(f"H={H} must divide by the mesh size {n}")
    local = partial(_local_update, n_ref_samples=n_ref_samples,
                    rows_per_device=H // n, axis=axis)
    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
        check_vma=True,
    ))


# --------------------------- fast path: column-sharded plane sweep

def make_sharded_update_sweep(mesh, shape, plan, regularize=True):
    """Multi-chip FAST depth update: the planned tent plane sweep with
    the pixel grid COLUMN-sharded over ``mesh``.

    Column sharding is the zero-communication axis for the sweep's
    two-pass tent warps: pass A (columns) reads a bounded column slab of
    the REPLICATED key/ref images at the device's own columns, and pass
    B (rows) is column-local — the per-device program contains no
    collectives at all (sweep.py::update_depth_sweep ``col_offset``
    mode).  The only collective in the whole step is the 1-column
    ``ppermute`` halo exchange of the 3x3 regularization
    (``_regularize_halo``), whose result matches the single-device
    ``regularization.regularize`` exactly (zero-padding at the true
    image edges = unmatched ppermute lanes).

    ``plan`` is a fast.UpdatePlan with path == 'tent' (host-planned).
    Returns a jitted callable (keyframe, refframes, age, prior_depth,
    prior_variance, params) -> (depth, variance, flags), column-sharded.
    """
    from tadataka_tpu.vo.semi_dense.sweep import update_depth_sweep
    from tadataka_tpu.vo.semi_dense.fast import KEY_BUDGET

    n = mesh.devices.size
    axis = mesh.axis_names[0]
    _H, W = shape
    if W % n != 0:
        raise ValueError(f"W={W} must divide by the mesh size {n}")
    if plan.path != 'tent':
        raise ValueError("sharded fast update supports the tent plan; "
                         f"got {plan.path!r}")
    cols_per_device = W // n

    def local(keyframe, refframes, age_map, prior_depth, prior_variance,
              params):
        col0 = jax.lax.axis_index(axis) * cols_per_device
        d, v, f = update_depth_sweep(
            keyframe, refframes, age_map, prior_depth, prior_variance,
            params, n_planes=plan.n_planes, warp_budget=plan.warp_budget,
            key_budget=KEY_BUDGET, redirect=plan.redirect, col_offset=col0)
        if regularize:
            d = _regularize_halo(d, v, f, axis)
        return d, v, f

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(None, axis), P(None, axis), P(None, axis),
                  P()),
        out_specs=P(None, axis),
        check_vma=True,
    ))


def _regularize_halo(depth_map, variance_map, flag_map, axis):
    """3x3 inverse-variance-weighted smoothing under column sharding.

    Exchanges one column of the two conv INPUT maps with each neighbor
    via ``ppermute`` (unmatched edge lanes arrive as zeros — exactly the
    zero padding the single-device conv applies at the image borders),
    then convolves the 3-column-extended block with row-only padding.
    Parity: vo/semi_dense/regularization.py (regularization.rs:5-49).
    """
    import jax.numpy as jnp
    from jax import lax
    from tadataka_tpu.flags import Flag
    from tadataka_tpu.vo.semi_dense.estimator import safe_invert

    success = (flag_map == int(Flag.SUCCESS)).astype(depth_map.dtype)
    inv_depth = safe_invert(depth_map)
    inv_var = safe_invert(variance_map) * success
    num_in = inv_depth * inv_var                       # conv inputs
    den_in = inv_var

    n_dev = lax.axis_size(axis)
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev - 1)]
    bwd = [((i + 1) % n_dev, i) for i in range(n_dev - 1)]

    def extend(x):
        left = lax.ppermute(x[:, -1:], axis, fwd)      # from left neighbor
        right = lax.ppermute(x[:, :1], axis, bwd)      # from right neighbor
        return jnp.concatenate([left, x, right], axis=1)

    def box3_rows(x):
        # 3x3 box sum, rows zero-padded, columns VALID (the 3-column
        # halo extension supplies the column taps) — separable shifts,
        # not a single-channel conv (see core/gradients.py)
        h = x[:, :-2] + x[:, 1:-1] + x[:, 2:]
        p = jnp.pad(h, ((1, 1), (0, 0)))
        return p[:-2] + p[1:-1] + p[2:]

    numerator = box3_rows(extend(num_in))
    denominator = box3_rows(extend(den_in))
    smoothed = safe_invert(numerator / jnp.maximum(denominator, 1e-12))
    return jnp.where(denominator > 0, smoothed, depth_map)
