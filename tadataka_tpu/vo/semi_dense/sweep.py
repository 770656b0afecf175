"""Plane-sweep semi-dense depth update — the fast path.

Parity surface: the same per-pixel algorithm as estimator.py (and the
reference's /root/reference/src/semi_dense/semi_dense.rs:91-158 /
intensities.rs:11-37), re-parametrized so the image sampling is dense
instead of scattered:

For inverse depth q, every key pixel's epipolar sample position in the ref
image is x_ref = pi(R x~ + q t) — i.e. ALL pixels' samples at hypothesis q
form one plane-induced homography warp H_q = K_ref (R + q t e3^T) K_key^-1
of the ref image onto the key grid.  Sweeping S inverse-depth planes
replaces the per-pixel scattered epipolar gathers with S dense warps
(core/warp2pass.py, core/shiftwarp.py), and the per-pixel epipolar line
becomes the plane axis of the warped stack: 5 consecutive planes are 5
consecutive samples along the pixel's epipolar line.

Differences vs the scattered estimator (estimator.py), by design:
- Samples are uniform in INVERSE DEPTH (shared planes) instead of uniform
  in epipolar arc length per pixel; the +-2 sigma prior range becomes a
  per-pixel window mask over planes, padded by half a plane so narrow
  ranges still match their nearest plane.
- The SSD minimum is refined to subpixel precision by parabolic
  interpolation over the three errors around the winning window — depth
  resolution is not limited to the plane spacing.
- Per-pixel failure flags keep the reference's priority chain; geometry
  flags come from the same ``_pixel_geometry`` as the scattered path.

The normalized-SSD window search + masked argmin + neighbor extraction
(the reference's inner loop, intensities.rs:11-37) is ``ssd_search``.
"""

from functools import partial

import jax
import jax.numpy as jnp

from tadataka_tpu.flags import Flag
from tadataka_tpu.core.gradients import sobel_x, sobel_y
from tadataka_tpu.core.transforms import (
    get_rotation, get_translation, inv_motion_matrix)
from tadataka_tpu.core.warp2pass import homography_warp, displacement_warp
from tadataka_tpu.core.shiftwarp import (
    rot_warp, rot_warp_batch, rot_warp_cols_block, shift_warp_cols,
    shift_warp_cols_block, shift_warp_multi, shift_warp_rows)
from tadataka_tpu.vo.semi_dense.estimator import (
    EPSILON, safe_invert, pixel_geometry_map, _photo_var,
    calc_key_epipole)
from tadataka_tpu.vo.semi_dense.hypothesis import (
    clamped_range, check_args_flag)
from tadataka_tpu.vo.semi_dense.params import SemiDenseParams, N_KEY_SAMPLES

DEFAULT_N_PLANES = 64
_INF = 3.0e38  # error of an invalid window (a plain float constant)


# ------------------------------------------------------------ plane warps

def plane_homography(T_rk, q, key_focal, key_offset, ref_focal, ref_offset):
    """Pixel-space homography of the inverse-depth-q plane: key -> ref.

    x_ref_px ~ K_ref (R + q t e3^T) K_key^-1 x_key_px.
    """
    R = get_rotation(T_rk)
    t = get_translation(T_rk)
    A = R + q * t[:, None] * jnp.array([0.0, 0.0, 1.0], T_rk.dtype)[None, :]
    K_ref = jnp.array(
        [[ref_focal[0], 0.0, ref_offset[0]],
         [0.0, ref_focal[1], ref_offset[1]],
         [0.0, 0.0, 1.0]], T_rk.dtype)
    K_key_inv = jnp.array(
        [[1.0 / key_focal[0], 0.0, -key_offset[0] / key_focal[0]],
         [0.0, 1.0 / key_focal[1], -key_offset[1] / key_focal[1]],
         [0.0, 0.0, 1.0]], T_rk.dtype)
    return K_ref @ A @ K_key_inv


def warp_plane_stack(ref_image, T_rk, qs, key_focal, key_offset,
                     ref_focal, ref_offset):
    """(S, H, W) stack of the ref image warped onto the key grid at each
    inverse-depth plane; out-of-image / behind-camera lanes hold -1.

    Gather-based (take_along_axis) variant — the reference for the
    gather-free `warp_plane_stack_tent` that the planned path runs."""

    def one(_, q):
        H33 = plane_homography(T_rk, q, key_focal, key_offset,
                               ref_focal, ref_offset)
        warped, _ = homography_warp(ref_image, H33, fill=-1.0)
        return None, warped

    _, stack = jax.lax.scan(one, None, qs)
    return stack


def warp_plane_stack_tent(ref_image, T_rk, qs, key_focal, key_offset,
                          ref_focal, ref_offset, budget: int,
                          out_rows=None):
    """Gather-free plane stack via per-plane tent shift-sum warps.

    V_j(x) = ref(H_{q_j} x), each plane one bounded-displacement warp
    (core/shiftwarp.py::rot_warp) — a SINGLE bilinear resample per
    plane, so sample values match the gather-based stack exactly within
    the static displacement ``budget`` (rotation + parallax); lanes
    exceeding it come out invalid (-1).  Feasible exactly when the
    inter-frame motion is small (consecutive VO frames, any direction —
    including forward, where scanline rectification is impossible).

    ``out_rows=(y0, n)`` warps only those KEY-grid rows (multi-chip row
    sharding: the ref image replicates, so each device builds its own
    block of the stack with zero collectives).

    The full-image path runs ALL planes in one batched two-pass warp
    (core/shiftwarp.py::rot_warp_batch): the source pad and every tap's
    shifted slice are shared across planes, so the per-plane fusion
    overhead of a lax.scan of single-plane warps disappears.
    """
    if out_rows is None:
        H33s = jax.vmap(
            lambda q: plane_homography(T_rk, q, key_focal, key_offset,
                                       ref_focal, ref_offset))(qs)
        stack, _ = rot_warp_batch(ref_image, H33s, budget, budget,
                                  fill=-1.0)
        return stack

    def one(_, q):
        H_q = plane_homography(T_rk, q, key_focal, key_offset,
                               ref_focal, ref_offset)
        warped, _ = rot_warp(ref_image, H_q, budget, budget, fill=-1.0,
                             out_rows=out_rows)
        return None, warped

    _, stack = jax.lax.scan(one, None, qs)
    return stack


# ----------------------------------------------------------- SSD search

def _window_errors(V, K, mlo, mhi):
    """(M, H, W) masked normalized-SSD errors of every template window."""
    S = V.shape[0]
    Kw = K.shape[0]
    M = S - Kw + 1
    Kn = jnp.sqrt(jnp.sum(K * K, axis=0)) + EPSILON        # (H, W)
    errs = []
    for m in range(M):
        w = [V[m + k] for k in range(Kw)]
        corr = sum(wk * K[k] for k, wk in enumerate(w))
        wn2 = sum(wk * wk for wk in w)
        valid = w[0] >= 0.0
        for wk in w[1:]:
            valid = valid & (wk >= 0.0)
        valid = valid & (jnp.float32(m) >= mlo) & (jnp.float32(m) <= mhi)
        err = 2.0 - 2.0 * corr / (jnp.sqrt(wn2) * Kn + EPSILON)
        errs.append(jnp.where(valid, err, _INF))
    return jnp.stack(errs)


def ssd_search(V, K, mlo, mhi):
    """Masked normalized-SSD window search over the plane stack.

    Returns (best_m (H,W) i32 with -1 = no valid window, err_center,
    err_prev, err_next).  Plain XLA: on an H100 a fused Pallas-Triton
    form of this search that never wrote the error volume was 2.4x
    faster alone but no faster end to end (PERF.md), so it was removed.
    """
    errs = _window_errors(V, K, mlo, mhi)                  # (M, H, W)
    M = errs.shape[0]
    best_m = jnp.argmin(errs, axis=0)                      # (H, W)
    ec = jnp.take_along_axis(errs, best_m[None], axis=0)[0]
    ep = jnp.take_along_axis(errs, jnp.maximum(best_m - 1, 0)[None],
                             axis=0)[0]
    en = jnp.take_along_axis(errs, jnp.minimum(best_m + 1, M - 1)[None],
                             axis=0)[0]
    ep = jnp.where(best_m == 0, _INF, ep)
    en = jnp.where(best_m == M - 1, _INF, en)
    no_match = ec >= _INF
    return (jnp.where(no_match, -1, best_m).astype(jnp.int32),
            ec, ep, en)


# ------------------------------------------------------------- key patch

def _key_patch_stack(key_image, key_focal, step_size_map, dir_x_map,
                     dir_y_map, budget: int = 0, col_block=None):
    """(5, H, W) key-patch samples at offsets -2..2 along the per-pixel
    epipolar direction (epipolar.rs:22), via two-pass displacement warps.

    ``budget`` > 0 switches to the gather-free tent shift-sum passes
    (core/shiftwarp.py) with that static displacement budget — the
    planned path; 0 keeps the take_along_axis form.

    ``col_block=(x0, w)`` (x0 may be traced) computes only those key
    columns from the full ``key_image`` — the column-sharded multi-chip
    path (requires budget > 0); the per-pixel maps are then (H, w)."""
    H, W = key_image.shape
    f32 = key_image.dtype
    half = N_KEY_SAMPLES // 2
    if col_block is None:
        x0, w = 0, W
        key_local = key_image
    else:
        assert budget > 0, "column-sharded key patch needs the tent path"
        x0, w = col_block
        key_local = jax.lax.dynamic_slice(key_image, (0, x0), (H, w))
    xs = x0 + jnp.broadcast_to(jnp.arange(w, dtype=f32), (H, w))
    ys = jnp.broadcast_to(jnp.arange(H, dtype=f32)[:, None], (H, w))
    if budget > 0 and col_block is None:
        # all four offset planes in one batched two-pass warp (shared
        # source pads / tap slices)
        offs = [k for k in range(-half, half + 1) if k != 0]
        x_maps = jnp.stack(
            [xs + k * step_size_map * dir_x_map * key_focal[0]
             for k in offs])
        y_maps = jnp.stack(
            [ys + k * step_size_map * dir_y_map * key_focal[1]
             for k in offs])
        warped, _ = shift_warp_multi(key_image, x_maps, y_maps,
                                     budget, budget, with_valid=False)
        planes = [warped[i] for i in range(len(offs))]
        planes.insert(half, key_local)
        return jnp.stack(planes)
    planes = []
    for k in range(-half, half + 1):
        if k == 0:
            planes.append(key_local)
            continue
        dx = k * step_size_map * dir_x_map * key_focal[0]
        dy = k * step_size_map * dir_y_map * key_focal[1]
        if budget > 0:
            tmp, _ = shift_warp_cols_block(key_image, xs + dx,
                                           budget, x0, w)
            warped, _ = shift_warp_rows(tmp, ys + dy, budget)
        else:
            warped, _ = displacement_warp(key_image, dx, dy)
        planes.append(warped)
    return jnp.stack(planes)


# ----------------------------------------------------- shared postprocess

def postprocess_map(q_m, nomatch, kgrad, ks, gx_v, gy_v, g, p_inv,
                    p_var, T_rk, age, *, params, fuse_prior=False):
    """Stage C shared by the plane-sweep estimators, over the WHOLE map
    at once: depth / variance / flag arrays from the matched inverse
    depth ``q_m`` (semi_dense.rs:105-158, variance.rs).

    All array arguments are flat (N,); ``g`` is the PixelGeoScalars tree
    of (N,) fields; ``T_rk`` is ONE refframe's 4x4 relative transform —
    callers run this once per active refframe and merge by age index.
    Plain whole-array code, NOT a per-pixel vmap: the vmapped form built
    (N, 2)/(N, 3) stacks with a tiny minor dimension.
    """
    R = get_rotation(T_rk)
    t = get_translation(T_rk)
    xk_x, xk_y = g.x_key_x, g.x_key_y

    # rows of R applied to the homogeneous key ray (xk_x, xk_y, 1)
    r0 = R[0, 0] * xk_x + R[0, 1] * xk_y + R[0, 2]
    r1 = R[1, 0] * xk_x + R[1, 1] * xk_y + R[1, 2]
    r2 = R[2, 0] * xk_x + R[2, 1] * xk_y + R[2, 2]

    def warp_xy(depth):
        """x/y of _warp_point(T_rk, x_key, depth), componentwise."""
        z = depth * r2 + t[2]
        return ((depth * r0 + t[0]) / (z + EPSILON),
                (depth * r1 + t[1]) / (z + EPSILON))

    flag_insufficient = kgrad < params.min_gradient
    key_depth = safe_invert(q_m)
    new_inv_depth = q_m

    # _calc_alpha (variance.rs:54-103), componentwise
    xmin_x, xmin_y = warp_xy(g.min_depth)
    xmax_x, xmax_y = warp_xy(g.max_depth)
    ddx = xmax_x - xmin_x
    ddy = xmax_y - xmin_y
    dn = jnp.sqrt(ddx * ddx + ddy * ddy)
    dz = dn == 0.0
    dirx = jnp.where(dz, ddx, ddx / jnp.where(dz, 1.0, dn))
    diry = jnp.where(dz, ddy, ddy / jnp.where(dz, 1.0, dn))
    xr_x, xr_y = warp_xy(key_depth)
    num0 = r2 * t[0] - r0 * t[2]
    den0 = xr_x * t[2] - t[0]
    a_x = dirx * num0 / (den0 * den0 + EPSILON)
    num1 = r2 * t[1] - r1 * t[2]
    den1 = xr_y * t[2] - t[1]
    a_y = diry * num1 / (den1 * den1 + EPSILON)
    alpha = jnp.where(jnp.abs(dirx) > jnp.abs(diry), a_x, a_y)

    # _geo_var (variance.rs:30-52), componentwise
    ex = xk_x - t[0] / (t[2] + EPSILON)
    ey = xk_y - t[1] / (t[2] + EPSILON)
    en_ = jnp.sqrt(ex * ex + ey * ey)
    ez = en_ == 0.0
    exn = jnp.where(ez, ex, ex / jnp.where(ez, 1.0, en_))
    eyn = jnp.where(ez, ey, ey / jnp.where(ez, 1.0, en_))
    gn = jnp.sqrt(gx_v * gx_v + gy_v * gy_v)
    gz = gn == 0.0
    gxn = jnp.where(gz, gx_v, gx_v / jnp.where(gz, 1.0, gn))
    gyn = jnp.where(gz, gy_v, gy_v / jnp.where(gz, 1.0, gn))
    p = exn * gxn + eyn * gyn
    geo_v = jnp.where(p == 0.0, 1.0 / EPSILON, 1.0 / (p * p + EPSILON))

    photo = _photo_var(kgrad / (ks + EPSILON))
    a2 = alpha * alpha
    variance = a2 * (params.geo_coeff ** 2 * geo_v
                     + params.photo_coeff ** 2 * photo)

    result_flag = check_args_flag(new_inv_depth, variance,
                                  params.min_inv_depth,
                                  params.max_inv_depth)
    flag = result_flag
    flag = jnp.where(nomatch,
                     jnp.int32(Flag.REF_CLOSE_OUT_OF_RANGE), flag)
    flag = jnp.where(g.flag_far_oob,
                     jnp.int32(Flag.REF_FAR_OUT_OF_RANGE), flag)
    flag = jnp.where(g.flag_close_oob,
                     jnp.int32(Flag.REF_CLOSE_OUT_OF_RANGE), flag)
    flag = jnp.where(g.flag_too_short,
                     jnp.int32(Flag.REF_EPIPOLAR_TOO_SHORT), flag)
    flag = jnp.where(flag_insufficient,
                     jnp.int32(Flag.INSUFFICIENT_GRADIENT), flag)
    flag = jnp.where(g.flag_key_oob,
                     jnp.int32(Flag.KEY_OUT_OF_RANGE), flag)
    flag = jnp.where(g.flag_neg_ref,
                     jnp.int32(Flag.NEGATIVE_REF_DEPTH), flag)

    prior_flag = check_args_flag(p_inv, p_var, params.min_inv_depth,
                                 params.max_inv_depth)
    prior_bad = prior_flag != jnp.int32(Flag.SUCCESS)
    not_processed = age == 0
    flag = jnp.where(prior_bad, prior_flag, flag)
    flag = jnp.where(not_processed, jnp.int32(Flag.NOT_PROCESSED), flag)

    success = flag == jnp.int32(Flag.SUCCESS)
    if fuse_prior:
        # LSD-SLAM-style depth-filter UPDATE: precision-weighted fusion
        # of the new observation with the prior hypothesis.  The
        # reference REPLACES the hypothesis (semi_dense.rs:221-225),
        # which lets every frame's small-baseline matching noise
        # overwrite an accumulated estimate — over tens of frames the
        # map degrades toward single-frame noise and the photometric
        # tracking scale collapses (r5 long-trajectory gate).  success
        # implies the prior passed check_args, so the fusion inputs are
        # valid.
        from tadataka_tpu.vo.semi_dense.fusion import fusion
        f_mu, f_var = fusion(new_inv_depth, p_inv, variance, p_var)
        out_inv = jnp.where(success, f_mu, p_inv)
        out_var = jnp.where(success, f_var, p_var)
    else:
        out_inv = jnp.where(success, new_inv_depth, p_inv)
        out_var = jnp.where(success, variance, p_var)
    return safe_invert(out_inv), out_var, flag


# ------------------------------------------------------------- full update

def _per_ref_tuple(value, R_frames):
    """Broadcast an int to a per-refframe tuple; validate tuples."""
    if isinstance(value, int):
        return (value,) * R_frames
    value = tuple(value)
    assert len(value) == R_frames, (value, R_frames)
    return value


def _budget_segments(b):
    """Normalize a per-refframe warp budget to ((b_far, b_near)): an int
    means one budget for the whole plane grid; a (far, near) pair gives
    the far (low inverse depth) half of the grid its own, usually
    smaller, tent budget (displacement grows with inverse depth)."""
    if isinstance(b, int):
        return (b, b)
    b = tuple(int(x) for x in b)
    assert len(b) == 2, b
    return b


@partial(jax.jit, static_argnames=("n_planes", "warp_budget",
                                   "key_budget", "redirect", "fuse_prior"))
def update_depth_sweep(keyframe, refframes, age_map, prior_depth,
                       prior_variance, params: SemiDenseParams,
                       n_planes=DEFAULT_N_PLANES, warp_budget=0,
                       key_budget: int = 0, redirect=None, col_offset=None,
                       fuse_prior=False):
    """Full-map inverse-depth update via plane sweep.

    Same contract as estimator.update_depth (semi_dense.rs:160-237):
    keyframe + stacked refframe history, per-pixel age-indexed refframe,
    returns (depth_map, variance_map, flag_map).

    ``warp_budget`` / ``key_budget`` > 0 switch the plane and key-patch
    warps to the gather-free tent shift-sum path
    (warp_plane_stack_tent) with those static displacement budgets —
    planned host-side by fast.plan_update; 0 keeps the gather-based
    warps.

    ``n_planes`` and ``warp_budget`` may be per-refframe tuples: each
    refframe's sweep pays only for ITS epipolar span and displacement
    (both grow with how far back the refframe is — the planner sizes
    them so the whole history stays on the fast path instead of one
    worst-case budget pricing every frame).  ``redirect`` (static
    tuple, len R) reassigns pixels whose age selects refframe r to
    redirect[r] — the planner points refframes whose warp exceeds the
    tent budget cap at the nearest feasible one, trading a slightly
    different baseline for staying off the scattered path.

    ``col_offset`` (a traced scalar) switches to the COLUMN-SHARDED
    multi-chip mode: ``age_map``/``prior_*`` are each device's local
    (H, w) column block starting at that global column, while the
    keyframe/refframe images stay replicated.  Column sharding is the
    zero-communication axis for the two-pass warps — pass A reads a
    bounded column slab of the replicated image, pass B is column-local
    — so the per-device program contains NO collectives and matches the
    single-device result to float-fusion precision (tests/parallel).
    Requires warp_budget/key_budget > 0 (the tent path).
    """
    H, W = prior_depth.shape
    R_frames = refframes.image.shape[0]
    f32 = keyframe.image.dtype
    N = H * W
    S_all = _per_ref_tuple(n_planes, R_frames)
    B_all = _per_ref_tuple(warp_budget, R_frames)
    if redirect is None:
        redirect = tuple(range(R_frames))
    B_all = tuple(_budget_segments(b) if b != 0 else (0, 0)
                  for b in B_all)
    sharded = col_offset is not None
    if sharded:
        assert min(min(b) for b in B_all) > 0 and key_budget > 0, (
            "column-sharded sweep requires the tent warp path")
        col_offset = jnp.asarray(col_offset, jnp.int32)

    T_wk = keyframe.transform_wf
    T_rk_all = jax.vmap(
        lambda T_wr: inv_motion_matrix(T_wr) @ T_wk)(refframes.transform_wf)
    e_key_all = jax.vmap(
        lambda T_wr: calc_key_epipole(T_wk, T_wr))(refframes.transform_wf)

    gx_full = sobel_x(keyframe.image, mode="zero")
    gy_full = sobel_y(keyframe.image, mode="zero")
    if sharded:
        gx = jax.lax.dynamic_slice(gx_full, (0, col_offset), (H, W))
        gy = jax.lax.dynamic_slice(gy_full, (0, col_offset), (H, W))
        xs = col_offset.astype(f32) + jnp.arange(W, dtype=f32)
    else:
        gx, gy = gx_full, gy_full
        xs = jnp.arange(W, dtype=f32)
    ys = jnp.arange(H, dtype=f32)
    X, Y = jnp.meshgrid(xs, ys)
    us_x, us_y = X.ravel(), Y.ravel()

    age = age_map.ravel().astype(jnp.int32)
    prior_d = prior_depth.ravel().astype(f32)
    prior_v = prior_variance.ravel().astype(f32)
    prior_inv = safe_invert(prior_d)
    ridx = jnp.clip(R_frames - age, 0, R_frames - 1)
    ridx = jnp.take(jnp.asarray(redirect, jnp.int32), ridx)
    active = sorted(set(redirect))

    key_shape = keyframe.image.shape
    ref_shape = refframes.image.shape[1:]

    def _select_active(*per_ref):
        """Merge per-active-refframe (N,) arrays by each pixel's ridx.

        A select chain, not a gather: computing each active refframe's
        whole-image geometry and selecting avoids per-pixel gathers of
        tiny tables and (16, N) broadcast transform columns for the short
        histories VO keeps.
        """
        out = per_ref[0]
        for i in range(1, len(active)):
            out = jnp.where(ridx == active[i], per_ref[i], out)
        return out

    # stage A: per-pixel geometry scalars + failure flags (the
    # componentwise whole-map form of estimator.py::_pixel_geometry),
    # computed per active refframe — no (16, N) transform columns, no
    # vmap-induced (N, 2)/(N, 3) minor-axis tensors
    geos = [
        pixel_geometry_map(
            us_x, us_y, prior_inv, prior_v, T_rk_all[r], e_key_all[r],
            keyframe.focal_length, keyframe.offset, key_shape,
            refframes.focal_length[r], refframes.offset[r], ref_shape,
            params, S_all[r])
        for r in active]
    geo = jax.tree.map(_select_active, *geos)

    # plane grids (uniform in inverse depth over the valid global range)
    q0 = params.min_inv_depth.astype(f32)
    q1 = params.max_inv_depth.astype(f32)

    # per-pixel valid window index bounds from the +-2 sigma range;
    # half-plane tolerance so a narrow range still matches its nearest plane
    lo, hi = clamped_range(prior_inv, prior_v, params.min_inv_depth,
                           params.max_inv_depth)
    half_w = N_KEY_SAMPLES // 2

    # Per-pixel epipolar arc length of one plane step: consecutive windows
    # move along the pixel's epipolar line by the distance between
    # consecutive plane projections, NOT by the scattered path's
    # ``ref_step_size`` — the key template must be sampled at the sweep's
    # own spacing for the SSD scales to match (semi_dense.rs:27's ratio
    # rule applied to the plane parametrization).
    def _arc_step_map(T, n):
        # n planes include the 2*half_w grid extension; the [q0, q1] arc
        # spans (n - 2*half_w - 1) plane steps.  Componentwise warp of
        # the key ray at the two range endpoints (no (N, 2) stacks).
        R = get_rotation(T)
        t = get_translation(T)
        r0 = R[0, 0] * geo.x_key_x + R[0, 1] * geo.x_key_y + R[0, 2]
        r1 = R[1, 0] * geo.x_key_x + R[1, 1] * geo.x_key_y + R[1, 2]
        r2 = R[2, 0] * geo.x_key_x + R[2, 1] * geo.x_key_y + R[2, 2]

        def warp_xy(depth):
            z = depth * r2 + t[2]
            return ((depth * r0 + t[0]) / (z + EPSILON),
                    (depth * r1 + t[1]) / (z + EPSILON))

        xa_x, xa_y = warp_xy(safe_invert(q1))
        xb_x, xb_y = warp_xy(safe_invert(q0))
        dx = xb_x - xa_x
        dy = xb_y - xa_y
        return (jnp.sqrt(dx * dx + dy * dy)
                / (n - 2 * (N_KEY_SAMPLES // 2) - 1))

    step_sweep = _select_active(*[
        _arc_step_map(T_rk_all[r], S_all[r]) for r in active])      # (N,)
    ratio = geo.key_step_size / (geo.step + EPSILON)
    key_step_sweep = ratio * step_sweep                             # (N,)

    # key patch stack + its gradient (epipolar.rs:22, semi_dense.rs:134).
    # geo.key_dir is aligned with the scattered path's sample order, which
    # walks the line from min depth (q=hi) toward max depth (q=lo); the
    # plane axis runs in INCREASING q, so the patch direction flips.
    step_map = key_step_sweep.reshape(H, W)
    dirx_map = -geo.key_dir_x.reshape(H, W)
    diry_map = -geo.key_dir_y.reshape(H, W)
    K_stack = _key_patch_stack(
        keyframe.image, keyframe.focal_length, step_map, dirx_map,
        diry_map, budget=key_budget,
        col_block=(col_offset, W) if sharded else None)        # (5, H, W)
    key_grad_map = jnp.sqrt(
        jnp.sum(jnp.diff(K_stack, axis=0) ** 2, axis=0))       # (H, W)

    # Gradient gate at REFERENCE support: the sweep may sample finer than
    # the reference's floored step (semi_dense.rs:27 + the ref_step_size
    # floor), which would shrink the template diffs and over-trigger
    # INSUFFICIENT_GRADIENT.  Scale the measured gradient to the
    # reference-equivalent template spacing (geo.key_step_size); the
    # photometric variance uses the (spacing-invariant) gradient DENSITY
    # either way, so passing the scaled pair keeps it unchanged.
    gate_scale = geo.key_step_size / (key_step_sweep + EPSILON)
    kgrad_post = key_grad_map.ravel() * gate_scale
    ks_post = geo.key_step_size

    # Per-refframe plane-stack warps, merged into ONE hybrid volume by
    # each pixel's age-selected refframe, then a SINGLE SSD search with
    # per-pixel window bounds/spacing — the search cost no longer scales
    # with the history length (only the warps do, and they are sized
    # per-refframe by the planner).
    #
    # Plane-grid semantics per refframe r: the 5-sample template window
    # needs half_w planes on BOTH sides of a hypothesis, so the grid
    # extends half_w planes past the valid range at each end (clamped
    # positive) — otherwise priors within 2 planes of either end of
    # [q0, q1] could never match and silently degraded to no-match as
    # their variance tightened.  Window m is centered on q0 + m*dq_r.
    lo_map = lo.reshape(H, W)
    hi_map = hi.reshape(H, W)
    ridx_map = ridx.reshape(H, W)
    S_max = max(S_all[r] for r in active)
    dq_table = [0.0] * R_frames
    V_sel = jnp.full((S_max, H, W), -1.0, f32)
    for r in active:
        S_r = S_all[r]
        dq = (q1 - q0) / (S_r - 2 * half_w - 1)
        dq_table[r] = dq
        qs = q0 + dq * (jnp.arange(S_r, dtype=f32) - half_w)
        qs = jnp.maximum(qs, jnp.asarray(EPSILON, f32))
        # split the plane grid at its midpoint: the far (low-q) half
        # uses its own, usually smaller, tent budget
        b_far, b_near = B_all[r]
        if b_far == b_near:
            seg = [(qs, b_near)]
        else:
            k = S_r // 2
            seg = [(qs[:k], b_far), (qs[k:], b_near)]
        if sharded:
            parts = []
            for qs_s, b_s in seg:
                def one(_, q, b_s=b_s):
                    H_q = plane_homography(
                        T_rk_all[r], q, keyframe.focal_length,
                        keyframe.offset, refframes.focal_length[r],
                        refframes.offset[r])
                    warped, _ = rot_warp_cols_block(
                        refframes.image[r], H_q, b_s, b_s,
                        col_offset, W, fill=-1.0)
                    return None, warped
                _, V_s = jax.lax.scan(one, None, qs_s)
                parts.append(V_s)
            V = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        elif b_near > 0:
            parts = [warp_plane_stack_tent(
                refframes.image[r], T_rk_all[r], qs_s,
                keyframe.focal_length, keyframe.offset,
                refframes.focal_length[r], refframes.offset[r], b_s)
                for qs_s, b_s in seg]
            V = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        else:
            V = warp_plane_stack(refframes.image[r], T_rk_all[r], qs,
                                 keyframe.focal_length, keyframe.offset,
                                 refframes.focal_length[r],
                                 refframes.offset[r])
        if S_r < S_max:
            V = jnp.pad(V, [(0, S_max - S_r), (0, 0), (0, 0)],
                        constant_values=-1.0)
        V_sel = jnp.where(ridx_map[None] == r, V, V_sel)

    # select chain, not a table gather
    dq_sel = jnp.zeros((N,), f32)
    for r in active:
        dq_sel = jnp.where(ridx == r, jnp.asarray(dq_table[r], f32),
                           dq_sel)
    dq_sel = dq_sel.reshape(H, W)
    tol = 0.5 * dq_sel
    mlo = jnp.ceil((lo_map - tol - q0) / dq_sel)
    mhi = jnp.floor((hi_map + tol - q0) / dq_sel)
    bm, ec, ep, en = ssd_search(V_sel, K_stack, mlo, mhi)

    # parabolic subpixel refinement in inverse-depth units
    denom = ep - 2.0 * ec + en
    ok = (ep < _INF) & (en < _INF) & (jnp.abs(denom) > EPSILON)
    delta = jnp.where(ok,
                      jnp.clip(0.5 * (ep - en) / jnp.where(
                          ok, denom, 1.0), -0.5, 0.5),
                      0.0)
    q_star_map = q0 + (bm.astype(f32) + delta) * dq_sel

    q_star = jnp.clip(q_star_map.ravel(), lo, hi)
    no_match = (bm < 0).ravel()

    # stage C: depth / variance / flags over the whole map
    # (semi_dense.rs:105-158), per active refframe + ridx select
    posts = [
        postprocess_map(q_star, no_match, kgrad_post, ks_post,
                        gx.ravel(), gy.ravel(), geo, prior_inv, prior_v,
                        T_rk_all[r], age, params=params,
                        fuse_prior=fuse_prior)
        for r in active]
    depth, variance, flags = (_select_active(*[p[i] for p in posts])
                              for i in range(3))
    return (depth.reshape(H, W), variance.reshape(H, W),
            flags.reshape(H, W))
