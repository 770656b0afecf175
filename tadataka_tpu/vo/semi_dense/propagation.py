"""Depth/variance map propagation to the next frame.

Parity surface: /root/reference/src/semi_dense/propagation.rs — warp every
pixel's hypothesis into the next frame; variance inflates by the
inverse-depth ratio to the 4th power plus a bias; colliding hypotheses fuse
when statistically compatible, otherwise the nearer surface wins.

Design: the reference resolves collisions with a sequential HashMap whose
result depends on scan order (propagation.rs:59-81).  Here the resolution is
a deterministic two-pass scatter: (1) ``scatter-min`` on depth elects the
nearest hypothesis per target pixel, (2) every hypothesis compatible with
its cell's winner joins a precision-weighted (Gaussian product) fusion via
``scatter-add``.  This is order-independent and parallel — and *more*
faithful to the underlying occlusion/fusion model than the scan-order
heuristic it replaces.
"""

from functools import partial

import jax
import jax.numpy as jnp

from tadataka_tpu.core.coordinates import image_coordinates
from tadataka_tpu.core.transforms import get_rotation, get_translation
from tadataka_tpu.core.warp import warp2d
from tadataka_tpu.vo.semi_dense.fusion import are_statistically_same
from tadataka_tpu.vo.semi_dense.estimator import safe_invert


def propagate_variance(depth0, depth1, variance0, uncertainty_bias):
    """(inv_d1 / inv_d0)^4 * var0 + bias (propagation.rs:9-19)."""
    ratio = safe_invert(depth1) / safe_invert(depth0)
    return ratio ** 4 * variance0 + uncertainty_bias


@jax.jit
def propagate(T10, camera_params0, camera_params1,
              depth_map0, variance_map0,
              default_depth, default_variance, uncertainty_bias):
    """Warp (depth, variance) maps from frame 0 into frame 1.

    camera_params0/1: CameraParameters or CameraModel-like with
    normalize/unnormalize.  Returns (depth_map1, variance_map1).
    """
    H, W = depth_map0.shape
    f32 = depth_map0.dtype

    us0 = image_coordinates((H, W), dtype=f32)
    us1, depths1 = warp2d(T10, camera_params0, camera_params1,
                          us0, depth_map0.ravel())

    # round-to-nearest cell assignment (the reference truncates,
    # propagation.rs:72 — rounding is unbiased and immune to f32 roundoff
    # pushing exact-integer warps across a cell boundary)
    tx = jnp.round(us1[:, 0]).astype(jnp.int32)
    ty = jnp.round(us1[:, 1]).astype(jnp.int32)
    valid = ((0 <= tx) & (tx <= W - 1) & (0 <= ty) & (ty <= H - 1)
             & (depths1 > 0))
    tx = jnp.clip(tx, 0, W - 1)
    ty = jnp.clip(ty, 0, H - 1)
    cell = ty * W + tx

    variance1 = propagate_variance(depth_map0.ravel(), depths1,
                                   variance_map0.ravel(), uncertainty_bias)

    big = jnp.asarray(jnp.inf, dtype=f32)
    src_depth = jnp.where(valid, depths1, big)

    # pass 1: nearest-depth winner per cell
    win_depth = jnp.full((H * W,), big, dtype=f32).at[cell].min(src_depth)

    # pass 2: precision-weighted fusion of every hypothesis compatible with
    # its cell's winner (in inverse-depth space, like the reference fusion)
    inv_d = safe_invert(depths1)
    win_inv = safe_invert(win_depth[cell])
    # winner variance: take variance of the lane that achieved the min
    is_winner = valid & (depths1 == win_depth[cell])
    win_var_acc = jnp.full((H * W,), big, dtype=f32).at[cell].min(
        jnp.where(is_winner, variance1, big))
    win_var = win_var_acc[cell]

    compat = valid & are_statistically_same(inv_d, win_inv,
                                            variance1, win_var)
    w = jnp.where(compat, 1.0 / jnp.maximum(variance1, 1e-12), 0.0)
    sum_w = jnp.zeros((H * W,), dtype=f32).at[cell].add(w)
    sum_mu = jnp.zeros((H * W,), dtype=f32).at[cell].add(w * inv_d)

    occupied = jnp.isfinite(win_depth) & (sum_w > 0)
    fused_inv = sum_mu / jnp.maximum(sum_w, 1e-12)
    fused_var = 1.0 / jnp.maximum(sum_w, 1e-12)

    depth1 = jnp.where(occupied, safe_invert(fused_inv),
                       jnp.asarray(default_depth, f32))
    variance1 = jnp.where(occupied, fused_var,
                          jnp.asarray(default_variance, f32))
    return depth1.reshape(H, W), variance1.reshape(H, W)


@partial(jax.jit, static_argnames=("bounds",))
def propagate_tent(T10, camera_params0, camera_params1,
                   depth_map0, variance_map0, age_map0,
                   default_depth, default_variance, uncertainty_bias,
                   bounds):
    """Fused propagate + increment_age with ZERO scatter/gather ops.

    `propagate` runs four whole-map scatters plus three gathers.  For
    inter-frame VO the displacement of
    the depth-induced warp is bounded, so the scatter becomes a static
    TAP LOOP: for each integer displacement (kx, ky) inside ``bounds``,
    the sources whose rounded target cell is exactly (x+kx, y+ky) are
    selected by one integer compare of a precomputed tap code and
    accumulated into the statically-shifted output window — pure
    shift + select + min/add elementwise work, the scatter analogue of the tent
    shift-sum warps (core/shiftwarp.py).

    ``bounds`` = (dx_lo, dx_hi, dy_lo, dy_hi), static ints from the
    host-side planner (fast.plan_flow_bounds): per-axis SIGNED cell
    displacement range.  Sources whose displacement falls outside the
    bounds are dropped (same "exact within budget, invalid beyond"
    contract as every tent path); the planner sizes the bounds from the
    full valid depth range so in-range hypotheses always fit.

    Semantics per target cell (matching `propagate` + `increment_age`):
    nearest-depth winner (ties -> smaller variance; equal pairs break by
    tap order), precision-weighted fusion of the hypotheses compatible
    with the winner, variance inflation by the inverse-depth ratio ^4 +
    bias, age = max(age0 + 1) over arriving sources (0 where none).
    Returns (depth_map1, variance_map1, age_map1).
    """
    H, W = depth_map0.shape
    f32 = depth_map0.dtype
    dx_lo, dx_hi, dy_lo, dy_hi = bounds
    INF = jnp.asarray(jnp.inf, f32)

    # componentwise depth-induced warp (no (N, 2)/(N, 3) stacks)
    X = jnp.broadcast_to(jnp.arange(W, dtype=f32), (H, W))
    Y = jnp.broadcast_to(jnp.arange(H, dtype=f32)[:, None], (H, W))
    xk, yk = camera_params0.normalize_xy(X, Y)
    R = get_rotation(T10)
    t = get_translation(T10)
    r0 = R[0, 0] * xk + R[0, 1] * yk + R[0, 2]
    r1 = R[1, 0] * xk + R[1, 1] * yk + R[1, 2]
    r2 = R[2, 0] * xk + R[2, 1] * yk + R[2, 2]
    d0 = depth_map0
    p1z = d0 * r2 + t[2]
    eps = 1e-16
    x1 = (d0 * r0 + t[0]) / (p1z + eps)
    y1 = (d0 * r1 + t[1]) / (p1z + eps)
    u1x, u1y = camera_params1.unnormalize_xy(x1, y1)
    tx = jnp.round(u1x).astype(jnp.int32)
    ty = jnp.round(u1y).astype(jnp.int32)
    in_image = ((0 <= tx) & (tx <= W - 1) & (0 <= ty) & (ty <= H - 1))

    dxi = tx - X.astype(jnp.int32)
    dyi = ty - Y.astype(jnp.int32)
    in_budget = ((dx_lo <= dxi) & (dxi <= dx_hi)
                 & (dy_lo <= dyi) & (dyi <= dy_hi))
    ny = dy_hi - dy_lo + 1
    code = jnp.where(in_image & in_budget,
                     (dxi - dx_lo) * ny + (dyi - dy_lo), -1)

    variance1 = propagate_variance(d0, p1z, variance_map0,
                                   uncertainty_bias)
    valid = in_image & in_budget & (p1z > 0)
    src_depth = jnp.where(valid, p1z, INF)
    src_var = jnp.where(valid, variance1, INF)
    age_src = jnp.where(in_image & in_budget,
                        age_map0.astype(jnp.int32) + 1, 0)

    px = max(abs(dx_lo), abs(dx_hi))
    py = max(abs(dy_lo), abs(dy_hi))

    def padded(arr, fill):
        return jnp.pad(arr, ((py, py), (px, px)), constant_values=fill)

    code_p = padded(code, -1)

    def taps():
        for kx in range(dx_lo, dx_hi + 1):
            for ky in range(dy_lo, dy_hi + 1):
                tc = (kx - dx_lo) * ny + (ky - dy_lo)
                ys = slice(py - ky, py - ky + H)
                xs = slice(px - kx, px - kx + W)
                yield tc, ys, xs

    def tree(op, items):
        """Balanced pairwise reduction — a SERIAL accumulation chain of
        hundreds of selects makes an XLA pass superlinear (153 unrolled
        taps took >6 min to compile; the tree compiles in seconds)."""
        items = list(items)
        while len(items) > 1:
            nxt = [op(items[i], items[i + 1])
                   for i in range(0, len(items) - 1, 2)]
            if len(items) % 2:
                nxt.append(items[-1])
            items = nxt
        return items[0]

    # phase 1: nearest-depth winner (+ its variance) per target cell.
    # Tie semantics match `propagate`: min depth, then min variance among
    # the lanes achieving it.
    depth_p = padded(src_depth, INF)
    var_p = padded(src_var, INF)
    tap_list = list(taps())
    cds = [jnp.where(code_p[ys, xs] == tc, depth_p[ys, xs], INF)
           for tc, ys, xs in tap_list]
    win_d = tree(jnp.minimum, cds)
    win_v = tree(jnp.minimum, [
        jnp.where((cd == win_d) & (cd < INF), var_p[ys, xs], INF)
        for (tc, ys, xs), cd in zip(tap_list, cds)])

    # winner stats back at each SOURCE's target cell: the inverse tap
    # loop (exact — each source reads the cell its own tap points at;
    # shifts are opposite-signed vs the scatter phase; each source
    # matches exactly one tap, so a masked tree-sum reconstructs it)
    win_d_p = padded(win_d, 0.0)
    win_v_p = padded(win_v, 0.0)

    def tap_gather(win_p):
        parts = []
        for kx in range(dx_lo, dx_hi + 1):
            for ky in range(dy_lo, dy_hi + 1):
                tc = (kx - dx_lo) * ny + (ky - dy_lo)
                ys = slice(py + ky, py + ky + H)
                xs = slice(px + kx, px + kx + W)
                parts.append(jnp.where(code == tc, win_p[ys, xs], 0.0))
        return tree(jnp.add, parts)

    win_d_src = jnp.where(code >= 0, tap_gather(win_d_p), INF)
    win_v_src = jnp.where(code >= 0, tap_gather(win_v_p), INF)

    # phase 2: precision-weighted fusion of compatible hypotheses + age
    inv_d = safe_invert(p1z)
    compat = valid & are_statistically_same(
        inv_d, safe_invert(win_d_src), variance1, win_v_src)
    w_src = jnp.where(compat, 1.0 / jnp.maximum(variance1, 1e-12), 0.0)
    wmu_src = w_src * inv_d

    w_p = padded(w_src, 0.0)
    wmu_p = padded(wmu_src, 0.0)
    age_p = padded(age_src, 0)
    sum_w = tree(jnp.add, [
        jnp.where(code_p[ys, xs] == tc, w_p[ys, xs], 0.0)
        for tc, ys, xs in tap_list])
    sum_mu = tree(jnp.add, [
        jnp.where(code_p[ys, xs] == tc, wmu_p[ys, xs], 0.0)
        for tc, ys, xs in tap_list])
    age1 = tree(jnp.maximum, [
        jnp.where(code_p[ys, xs] == tc, age_p[ys, xs], 0)
        for tc, ys, xs in tap_list])

    occupied = jnp.isfinite(win_d) & (sum_w > 0)
    fused_inv = sum_mu / jnp.maximum(sum_w, 1e-12)
    fused_var = 1.0 / jnp.maximum(sum_w, 1e-12)
    depth1 = jnp.where(occupied, safe_invert(fused_inv),
                       jnp.asarray(default_depth, f32))
    variance_out = jnp.where(occupied, fused_var,
                             jnp.asarray(default_variance, f32))
    return depth1, variance_out, age1
