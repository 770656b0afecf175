"""Gather-free bounded-displacement image warps (tent-weighted shift sums).

Why: it replaces a scattered gather with static shifts (slices) and
elementwise FMA, which every backend runs as plain vector work.
Bilinear sampling at ``x + dx`` with ``|dx| <= D`` is a tent-function
convolution with spatially-varying weights:

    out[., x] = sum_{k=-D..D} relu(1 - |x_map - (x + k)|) * img[., x + k]

i.e. (2D+1) shifted fused multiply-adds — no gathers anywhere.  For each
lane at most two ``k`` terms are non-zero, and they are exactly the two
bilinear taps, so the result equals direct bilinear sampling wherever
``|x_map - x| <= D``; lanes that exceed the budget are reported invalid.

This caps the warp's displacement, which is exactly the regime of
*rotation-only* (infinity) homographies between VO frames — the basis of
the rectified plane sweep (vo/semi_dense/sweep_rect.py): rectification
rotations move pixels by tens of pixels, while the unbounded translation
parallax is handled separately as per-plane constant shifts.

Role in the reference: replaces the per-pixel epipolar warps of
/root/reference/src/warp.rs and src/semi_dense/epipolar.rs:38-54 on the
semi-dense hot path.
"""

import jax.numpy as jnp

EPSILON = 1e-16


def _tent_pass(img, coord_map, axis_idx, max_shift, axis):
    """Shared tent shift-sum along ``axis`` (0=rows, 1=cols).

    img: (..., H, W); coord_map: (H, W) float target coordinate along
    ``axis``; axis_idx: (H, W) the identity coordinate grid along ``axis``.
    Returns (out, in_budget) where ``in_budget`` marks lanes whose
    displacement fits the static budget.
    """
    n = img.shape[axis - 2]  # H for axis 0, W for axis 1
    c = jnp.clip(coord_map, 0.0, n - 1.0)
    disp = c - axis_idx
    in_budget = jnp.abs(disp) <= max_shift

    pad = [(0, 0)] * (img.ndim - 2) + [(0, 0), (0, 0)]
    pad[axis - 2] = (max_shift, max_shift)
    padded = jnp.pad(img, pad, mode="edge")

    out = jnp.zeros_like(img)
    for k in range(-max_shift, max_shift + 1):
        if axis == 1:
            shifted = padded[..., :, k + max_shift:k + max_shift + n]
        else:
            shifted = padded[..., k + max_shift:k + max_shift + n, :]
        w = jnp.maximum(0.0, 1.0 - jnp.abs(disp - k))
        out = out + w * shifted
    return out, in_budget


def shift_warp_cols(img, x_map, max_shift):
    """Bilinear horizontal resample: out[..., y, x] = img[..., y, x_map[y, x]].

    ``x_map`` is float (clamped to the image); exact wherever
    ``|x_map - x| <= max_shift`` (static int), invalid beyond.
    Returns (out, in_budget).
    """
    W = img.shape[-1]
    H = img.shape[-2]
    xs = jnp.broadcast_to(jnp.arange(W, dtype=x_map.dtype), (H, W))
    return _tent_pass(img, x_map, xs, max_shift, axis=1)


def shift_warp_cols_block(img, x_map, max_shift, x0, w):
    """Column tent resample restricted to output columns [x0, x0+w):

        out[..., y, j] = img[..., y, x_map[y, j]]   (x_map in GLOBAL cols)

    ``x0`` may be a traced scalar (multi-chip column sharding: each
    device computes its own block from the REPLICATED image with zero
    collectives); ``w`` is static.  Taps come from a (2*max_shift)-padded
    column slab around the block, so results are bit-identical to the
    full-width pass sliced to [x0, x0+w).  Returns (out, in_budget).
    """
    import jax.lax as lax
    W = img.shape[-1]
    f32 = img.dtype
    w_slab = min(w + 2 * max_shift, W)
    x0 = jnp.asarray(x0, jnp.int32)
    slab_start = jnp.clip(x0 - max_shift, 0, W - w_slab)
    starts = (0,) * (img.ndim - 1) + (slab_start,)
    slab = lax.dynamic_slice(img, starts, img.shape[:-1] + (w_slab,))
    pad = [(0, 0)] * (img.ndim - 1) + [(max_shift, max_shift)]
    padded = jnp.pad(slab, pad, mode="edge")

    xg = x0 + jnp.arange(w, dtype=f32)            # global output columns
    c = jnp.clip(x_map, 0.0, W - 1.0)
    disp = c - xg
    in_budget = jnp.abs(disp) <= max_shift

    base = x0 - slab_start                        # traced, in [0, 2B]
    out = jnp.zeros(img.shape[:-1] + (w,), dtype=f32)
    for k in range(-max_shift, max_shift + 1):
        st = (0,) * (img.ndim - 1) + (base + k + max_shift,)
        pslice = lax.dynamic_slice(padded, st, img.shape[:-1] + (w,))
        wk = jnp.maximum(0.0, 1.0 - jnp.abs(disp - k))
        out = out + wk * pslice
    return out, in_budget


def shift_warp_rows(img, y_map, max_shift):
    """Bilinear vertical resample: out[..., y, x] = img[..., y_map[y, x], x]."""
    W = img.shape[-1]
    H = img.shape[-2]
    ys = jnp.broadcast_to(jnp.arange(H, dtype=y_map.dtype)[:, None], (H, W))
    return _tent_pass(img, y_map, ys, max_shift, axis=0)


def tent_sample(img, x_map, y_map, max_dx, max_dy):
    """Bilinear sample at arbitrary smooth coordinate maps, gather-free:

        out[..., y, x] ~ img[..., y_map[y, x], x_map[y, x]]

    Two tent shift-sum passes (cols then rows).  Exact wherever the
    displacement fits the static budgets AND the column map varies slowly
    along rows (the pass-B row mix reads pass-A values computed at nearby
    rows; deviation is O(|y_map - y| * d(x_map)/dy) — negligible for the
    smooth depth-induced flow fields of inter-frame VO).  ``img`` may be
    (H, W) or (C, H, W).

    Returns (out, valid); ``valid`` requires both budgets, with the pass-A
    budget mask warped THROUGH pass B (as an extra channel) so it holds at
    the source rows pass B actually reads, not merely at the output grid.
    """
    single = img.ndim == 2
    stack = img[None] if single else img
    tmp, ok_a = shift_warp_cols(stack, x_map, max_dx)
    carried = jnp.concatenate([tmp, ok_a.astype(img.dtype)[None]], axis=0)
    out_all, ok_b = shift_warp_rows(carried, y_map, max_dy)
    out = out_all[:-1]
    ok_a_warped = out_all[-1] > 0.999
    valid = ok_b & ok_a_warped
    return (out[0] if single else out), valid


def rot_warp_cols_block(img, H33, max_dx, max_dy, x0, w,
                        fill=-1.0, eps=1e-6):
    """rot_warp restricted to output columns [x0, x0+w) (x0 may be a
    TRACED scalar — the multi-chip column-sharded path).

    Column sharding is the zero-communication axis for the two-pass
    warp: pass A (columns) reads only a +-max_dx column slab of the
    REPLICATED image at the device's own output columns, and pass B
    (rows) is column-local — each device owns full rows of its columns.
    Results are bit-identical to the full warp sliced to the block.
    """
    Hi, Wi = img.shape[-2:]
    f32 = img.dtype

    h00, h01, h02 = H33[0, 0], H33[0, 1], H33[0, 2]
    h10, h11, h12 = H33[1, 0], H33[1, 1], H33[1, 2]
    h20, h21, h22 = H33[2, 0], H33[2, 1], H33[2, 2]

    xo = (x0 + jnp.arange(w, dtype=f32))[None, :]           # global cols
    yo = jnp.arange(Hi, dtype=f32)[:, None]

    D = h20 * xo + h21 * yo + h22
    U = (h00 * xo + h01 * yo + h02) / jnp.where(D == 0.0, eps, D)
    V = (h10 * xo + h11 * yo + h12) / jnp.where(D == 0.0, eps, D)

    # pass A: on source row y, place img(a(x', y), y) at column x'
    denom_a = h11 - yo * h21
    sing_a = jnp.abs(denom_a) < eps
    denom_a = jnp.where(sing_a, eps, denom_a)
    y_src = (yo * (h20 * xo + h22) - (h10 * xo + h12)) / denom_a
    D_a = h20 * xo + h21 * y_src + h22
    a = (h00 * xo + h01 * y_src + h02) / jnp.where(D_a == 0.0, eps, D_a)

    tmp, ok_a = shift_warp_cols_block(img, a, max_dx, x0, w)
    out, ok_b = _tent_pass(
        tmp, jnp.clip(jnp.broadcast_to(V, (Hi, w)), 0.0, Hi - 1.0),
        jnp.broadcast_to(yo, (Hi, w)), max_dy, axis=0)

    # same validity semantics as rot_warp (ok_a at the output grid)
    valid = ((D > eps)
             & (U >= 0.0) & (U <= Wi - 1.0)
             & (V >= 0.0) & (V <= Hi - 1.0)
             & ok_b & jnp.logical_not(sing_a) & ok_a)
    return jnp.where(valid, out, fill), valid


def rot_warp(img, H33, max_dx, max_dy, fill=-1.0, eps=1e-6,
             out_rows=None):
    """Homography warp by two tent shift-sum passes (Catmull-Smith order).

    out(x', y') = img(U, V) with (U, V, 1) ~ H33 @ (x', y', 1), for
    homographies whose displacement field is bounded by the static budgets
    (max_dx, max_dy) — rotation-only / rectification homographies.

    img may be (H, W) or (C, H, W) (channels warped identically).
    Returns (warped, valid); invalid lanes (out of image, behind the
    plane, over budget, or near the scanline-decomposition singularity)
    hold ``fill``.

    ``out_rows=(y0, n)`` (static ints) computes only output rows
    [y0, y0+n) — the multi-chip row-sharded path: each device warps its
    own block (plus a max_dy source apron read from the REPLICATED
    image), so no collective is ever needed for the warp itself.

    Math identical to core/warp2pass.py::homography_warp — pass A places
    img(a(x', y), y) on ref row y with a = U(x', V^-1_{x'}(y)), pass B
    gathers rows at V — but with both per-axis resamples executed as
    shift sums instead of gathers.
    """
    Hi, Wi = img.shape[-2:]
    f32 = img.dtype
    if out_rows is None:
        y0_out, n_out = 0, Hi
    else:
        y0_out, n_out = out_rows

    h00, h01, h02 = H33[0, 0], H33[0, 1], H33[0, 2]
    h10, h11, h12 = H33[1, 0], H33[1, 1], H33[1, 2]
    h20, h21, h22 = H33[2, 0], H33[2, 1], H33[2, 2]

    # source rows feeding pass B for this output block
    y_lo = max(y0_out - max_dy, 0)
    y_hi = min(y0_out + n_out + max_dy, Hi)
    n_src = y_hi - y_lo

    xo = jnp.arange(Wi, dtype=f32)[None, :]
    yo = (jnp.arange(n_out, dtype=f32) + y0_out)[:, None]   # global rows

    D = h20 * xo + h21 * yo + h22
    U = (h00 * xo + h01 * yo + h02) / jnp.where(D == 0.0, eps, D)
    V = (h10 * xo + h11 * yo + h12) / jnp.where(D == 0.0, eps, D)

    # pass A on the source-row slab: place img(a(x', y), y) at column x'
    ys = (jnp.arange(n_src, dtype=f32) + y_lo)[:, None]     # global rows
    denom_a = h11 - ys * h21
    sing_row = jnp.abs(denom_a) < eps
    denom_a = jnp.where(sing_row, eps, denom_a)
    y_src = (ys * (h20 * xo + h22) - (h10 * xo + h12)) / denom_a
    D_a = h20 * xo + h21 * y_src + h22
    a = (h00 * xo + h01 * y_src + h02) / jnp.where(D_a == 0.0, eps, D_a)

    slab = img[..., y_lo:y_hi, :]
    tmp, ok_a = shift_warp_cols(slab, a, max_dx)

    # pass B over the slab: local row coordinate = V - y_lo.  V is
    # clamped to the IMAGE (validity separately requires V in range);
    # in-budget lanes always land inside the slab by construction.
    # Output row i sits at slab row i + off, so the tent sum slices the
    # padded slab at a static offset (same math as _tent_pass).
    off = y0_out - y_lo
    V_full = jnp.clip(jnp.broadcast_to(V, (n_out, Wi)), 0.0, Hi - 1.0)
    c = jnp.clip(V_full - y_lo, 0.0, n_src - 1.0)
    base = (jnp.arange(n_out, dtype=f32) + off)[:, None]
    disp = c - base
    ok_b = jnp.abs(disp) <= max_dy
    pad = [(0, 0)] * (tmp.ndim - 2) + [(max_dy, max_dy), (0, 0)]
    padded = jnp.pad(tmp, pad, mode="edge")
    out = jnp.zeros(tmp.shape[:-2] + (n_out, Wi), dtype=f32)
    for k in range(-max_dy, max_dy + 1):
        shifted = padded[..., off + k + max_dy:off + k + max_dy + n_out, :]
        w = jnp.maximum(0.0, 1.0 - jnp.abs(disp - k))
        out = out + w * shifted

    # pass A singularity rows, seen from the output grid
    denom_o = h11 - yo * h21
    sing_o = jnp.abs(denom_o) < eps

    valid = ((D > eps)
             & (U >= 0.0) & (U <= Wi - 1.0)
             & (V >= 0.0) & (V <= Hi - 1.0)
             & ok_b & jnp.logical_not(sing_o))
    # pass A's budget must hold at the rows pass B reads; V within budget
    # of y' and ok_a smooth — approximated by requiring ok_a at (y', x').
    # Warping ok_a through pass B (as tent_sample does) would make this
    # exact but adds a full extra channel to EVERY plane's row pass —
    # ~+50% warp cost across the sweep stack for a boundary-lane nicety;
    # affected lanes sit within max_dy rows of a budget edge and their
    # slightly-clamped values still enter a normalized SSD vote.
    ok_a_out = ok_a[y0_out - y_lo:y0_out - y_lo + n_out]
    valid = valid & ok_a_out
    return jnp.where(valid, out, fill), valid


def rot_warp_batch(img, H33s, max_dx, max_dy, fill=-1.0, eps=1e-6):
    """Batched :func:`rot_warp`: S homographies of ONE image in one pass.

    img (H, W), H33s (S, 3, 3) -> (warped (S, H, W), valid (S, H, W)).

    Same math and validity semantics as rot_warp per plane, but the
    source image is padded ONCE and every tap's shifted slice is shared
    by all S planes — the per-plane pad/shift fusion overhead that made a
    lax.scan of single-plane warps overhead-bound disappears, and every
    elementwise op runs at (S, H, W) width.
    """
    Hi, Wi = img.shape[-2:]
    f32 = img.dtype

    def c(i, j):
        return H33s[:, i, j][:, None, None]                 # (S, 1, 1)

    xo = jnp.arange(Wi, dtype=f32)[None, None, :]
    yo = jnp.arange(Hi, dtype=f32)[None, :, None]

    D = c(2, 0) * xo + c(2, 1) * yo + c(2, 2)
    U = (c(0, 0) * xo + c(0, 1) * yo + c(0, 2)) / jnp.where(D == 0.0, eps, D)
    V = (c(1, 0) * xo + c(1, 1) * yo + c(1, 2)) / jnp.where(D == 0.0, eps, D)

    # pass A scanline decomposition (same as rot_warp): on source row y,
    # place img(a(x', y), y) at column x'
    denom_a = c(1, 1) - yo * c(2, 1)                        # (S, H, 1)
    sing_a = jnp.abs(denom_a) < eps
    denom_a = jnp.where(sing_a, eps, denom_a)
    y_src = (yo * (c(2, 0) * xo + c(2, 2))
             - (c(1, 0) * xo + c(1, 2))) / denom_a
    D_a = c(2, 0) * xo + c(2, 1) * y_src + c(2, 2)
    a = (c(0, 0) * xo + c(0, 1) * y_src + c(0, 2)) / jnp.where(
        D_a == 0.0, eps, D_a)

    ca = jnp.clip(a, 0.0, Wi - 1.0)
    dispA = ca - xo                                         # (S, H, W)
    okA = jnp.abs(dispA) <= max_dx
    padded = jnp.pad(img, [(0, 0)] * (img.ndim - 1)
                     + [(max_dx, max_dx)], mode="edge")
    tmp = jnp.zeros(dispA.shape, f32)
    for k in range(-max_dx, max_dx + 1):
        w = jnp.maximum(0.0, 1.0 - jnp.abs(dispA - k))
        tmp = tmp + w * padded[None, :, k + max_dx:k + max_dx + Wi]

    cV = jnp.clip(V, 0.0, Hi - 1.0)
    dispB = cV - yo                                         # (S, H, W)
    okB = jnp.abs(dispB) <= max_dy
    tpad = jnp.pad(tmp, [(0, 0), (max_dy, max_dy), (0, 0)], mode="edge")
    out = jnp.zeros(dispA.shape, f32)
    for k in range(-max_dy, max_dy + 1):
        w = jnp.maximum(0.0, 1.0 - jnp.abs(dispB - k))
        out = out + w * tpad[:, k + max_dy:k + max_dy + Hi, :]

    valid = ((D > eps)
             & (U >= 0.0) & (U <= Wi - 1.0)
             & (V >= 0.0) & (V <= Hi - 1.0)
             & okB & jnp.logical_not(sing_a) & okA)
    return jnp.where(valid, out, fill), valid


def shift_warp_multi(img, x_maps, y_maps, max_dx, max_dy, with_valid=True):
    """Batched two-pass tent resample of ONE image at C coordinate maps:

        out[c, y, x] = img(y_maps[c, y, x], x_maps[c, y, x])

    img (H, W), x_maps/y_maps (C, H, W) -> (out (C, H, W), valid).
    Pads the source once per pass; every tap FMA runs (C, H, W) wide —
    the batched form of shift_warp_cols + shift_warp_rows used by the
    key-patch stack.  With ``with_valid`` the
    validity matches ``tent_sample`` (pass-A budget warped through
    pass B); ``with_valid=False`` skips the extra carried channels
    (~half the pass-B cost) and returns ``valid=None``.
    """
    Hi, Wi = img.shape
    f32 = img.dtype
    xo = jnp.arange(Wi, dtype=f32)[None, None, :]
    yo = jnp.arange(Hi, dtype=f32)[None, :, None]

    cx = jnp.clip(x_maps, 0.0, Wi - 1.0)
    dispA = cx - xo
    okA = jnp.abs(dispA) <= max_dx
    padded = jnp.pad(img, [(0, 0), (max_dx, max_dx)], mode="edge")
    tmp = jnp.zeros(dispA.shape, f32)
    for k in range(-max_dx, max_dx + 1):
        w = jnp.maximum(0.0, 1.0 - jnp.abs(dispA - k))
        tmp = tmp + w * padded[None, :, k + max_dx:k + max_dx + Wi]

    cy = jnp.clip(y_maps, 0.0, Hi - 1.0)
    dispB = cy - yo
    okB = jnp.abs(dispB) <= max_dy
    if with_valid:
        # carry pass-A validity through pass B as an extra channel block
        carried = jnp.concatenate([tmp, okA.astype(f32)], axis=0)
        dispB2 = jnp.concatenate([dispB, dispB], axis=0)
    else:
        carried = tmp
        dispB2 = dispB
    tpad = jnp.pad(carried, [(0, 0), (max_dy, max_dy), (0, 0)], mode="edge")
    out = jnp.zeros(dispB2.shape, f32)
    for k in range(-max_dy, max_dy + 1):
        w = jnp.maximum(0.0, 1.0 - jnp.abs(dispB2 - k))
        out = out + w * tpad[:, k + max_dy:k + max_dy + Hi, :]
    if not with_valid:
        return out, None
    C = x_maps.shape[0]
    valid = okB & (out[C:] > 0.999)
    return out[:C], valid


def const_shift_cols(img, shift, fill=-1.0):
    """Bilinear resample at a single *traced* column shift:
    out[..., y, x] = img[..., y, x + shift]; positions falling outside
    the image (or touching it with only one tap) hold ``fill``.

    Uses one dynamic slice pair on a padded buffer — O(1) ops however
    large the shift, unlike the tent sum.  ``shift`` is a traced scalar;
    its magnitude must be < the image width.
    """
    import jax.lax as lax
    W = img.shape[-1]
    sf = jnp.floor(shift)
    frac = shift - sf
    si = sf.astype(jnp.int32)
    pad_spec = [(0, 0)] * (img.ndim - 1) + [(W, W + 1)]
    padded = jnp.pad(img, pad_spec, constant_values=fill)
    mask = jnp.pad(jnp.ones(img.shape[-1:], img.dtype),
                   [(W, W + 1)], constant_values=0.0)
    start = jnp.clip(si + W, 0, padded.shape[-1] - W - 1)
    starts0 = (0,) * (img.ndim - 1) + (start,)
    starts1 = (0,) * (img.ndim - 1) + (start + 1,)
    v0 = lax.dynamic_slice(padded, starts0, img.shape)
    v1 = lax.dynamic_slice(padded, starts1, img.shape)
    m0 = lax.dynamic_slice(mask, (start,), (W,))
    m1 = lax.dynamic_slice(mask, (start + 1,), (W,))
    out = (1.0 - frac) * v0 + frac * v1
    valid = (1.0 - frac) * m0 + frac * m1 > 0.999
    return jnp.where(valid, out, fill)
