"""Host-side planner + dispatcher for the semi-dense depth update.

Picks, per (keyframe, refframe-history) geometry, the fastest path
that is exact for that geometry, in preference order:

  tent    — homography plane sweep with tent shift-sum warps (sweep.py::
            warp_plane_stack_tent), per-refframe budgets/plane counts.
            Preferred whenever every refframe's warp fits the budget
            cap: it measures everything on the key grid (no cross-grid
            interpolation of priors or results) and handles ANY motion
            direction, including forward.
  rect    — rectified disparity sweep (sweep_rect.py).  Chosen when the
            tent budget is exceeded but every pair's rectifying rotation
            fits the shift-warp budget — big LATERAL baselines (stereo
            pairs); the per-plane warp degenerates to a constant 1-px
            shift, so cost stays flat however wide the baseline.
  tent+redirect — tent with over-budget refframes redirected to the
            nearest feasible one (slightly different baseline beats
            falling off the fast path).
  scatter — the general vmapped estimator (estimator.py::update_depth).
            Always correct; the fallback of last resort.

All plan quantities (plane counts, shift budgets, baseline signs) are
STATIC jit arguments, derived on the host from the 4x4 poses (tiny
host-side numpy; the image tensors never leave the device); they are
bucketed so a VO run compiles each path a handful of times, not per
frame.

Reference scope: this whole module replaces the implicit "one Rust loop
fits all" dispatch of /root/reference/src/semi_dense/semi_dense.rs:160
with geometry-specialized programs.
"""

from typing import NamedTuple

import numpy as np

from tadataka_tpu.vo.semi_dense.params import N_KEY_SAMPLES
from tadataka_tpu.vo.semi_dense.rectify import (
    rectification_feasible, _np_homography_displacement)

RECT_MAX_DX = 32
RECT_MAX_DY = 32
TENT_BUDGET_MAX = 32   # per-plane warp budget cap (rotation + parallax)
KEY_BUDGET = 8
MAX_PLANES = 256
_BUDGET_BUCKETS = (4, 8, 12, 16, 24, 32, 48)


class UpdatePlan(NamedTuple):
    path: str            # 'rect' | 'tent' | 'scatter'
    n_planes: tuple      # per-refframe for tent; (n,) global for rect
    flips: tuple         # rect only
    warp_budget: tuple   # tent only, per-refframe
    redirect: tuple      # tent only: age index -> swept refframe index


def _bucket_budget(v):
    for b in _BUDGET_BUCKETS:
        if v <= b:
            return b
    return None


def _bucket_planes(v, cap=MAX_PLANES):
    n = int(np.ceil(max(v, 8) / 16.0)) * 16
    return min(n, cap)


def _np_K(f, c):
    return np.array([[f[0], 0, c[0]], [0, f[1], c[1]], [0, 0, 1.0]])


def _plane_H(T_rk, q, key_f, key_c, ref_f, ref_c):
    R, t = T_rk[:3, :3], T_rk[:3, 3]
    A = R + q * np.outer(t, [0.0, 0.0, 1.0])
    return _np_K(ref_f, ref_c) @ A @ np.linalg.inv(_np_K(key_f, key_c))


def _np_homography_span(Ha, Hb, image_shape, n=9):
    """Max |Ha x - Hb x| over a coarse grid (host-side numpy) — the
    longest epipolar track between two planes."""
    Hh, Ww = image_shape
    xs = np.linspace(0, Ww - 1.0, n)
    ys = np.linspace(0, Hh - 1.0, n)
    X, Y = np.meshgrid(xs, ys)
    P = np.stack([X.ravel(), Y.ravel(), np.ones(X.size)])
    Qa = Ha @ P
    Qb = Hb @ P
    if np.any(Qa[2] <= 1e-9) or np.any(Qb[2] <= 1e-9):
        return np.inf
    return float(np.hypot(Qa[0] / Qa[2] - Qb[0] / Qb[2],
                          Qa[1] / Qa[2] - Qb[1] / Qb[2]).max())


# Tap-scatter propagation cap (nx * ny), the same for every backend.  The
# tap grid unrolls into whole-image selects whose compile time grows
# steeply with the tap count: on an H100, XLA:GPU took 162 s and 242 s for
# grids of 238 and 255 taps and 11 min for one of several hundred.  Wider
# flows take the scatter path, which compiles in seconds.
FLOW_TAPS_MAX = 64
_FLOW_BUCKET = 4


def plan_flow_bounds(T10, focal, offset, image_shape, q0, q1,
                     margin=2, taps_max=FLOW_TAPS_MAX):
    """Per-axis SIGNED cell-displacement bounds of the depth-induced
    warp frame0 -> frame1 over the valid inverse-depth range — the
    static tap grid for propagation.propagate_tent.

    Host-side numpy on the (predicted) relative pose; bounds are
    bucketed to multiples of 4 so a VO run compiles a handful of tap
    grids, not one per frame.  Returns (dx_lo, dx_hi, dy_lo, dy_hi) or
    None when the grid would exceed ``taps_max`` (fall back to the
    scatter path).
    """
    Hh, Ww = image_shape
    xs = np.linspace(0, Ww - 1.0, 9)
    ys = np.linspace(0, Hh - 1.0, 9)
    X, Y = np.meshgrid(xs, ys)
    P = np.stack([X.ravel(), Y.ravel(), np.ones(X.size)])
    K = _np_K(focal, offset)
    K_inv = np.linalg.inv(K)
    dxs, dys = [], []
    qm = np.sqrt(max(q0, 1e-12) * q1)
    for q in (q0, qm, 0.5 * (q0 + q1), q1):
        A = T10[:3, :3] + q * np.outer(T10[:3, 3], [0.0, 0.0, 1.0])
        Q = K @ A @ K_inv @ P
        if np.any(Q[2] <= 1e-9):
            return None
        dxs.append(Q[0] / Q[2] - P[0])
        dys.append(Q[1] / Q[2] - P[1])
    dxs = np.concatenate(dxs)
    dys = np.concatenate(dys)

    def lo_hi(d):
        lo = int(np.floor(d.min())) - margin
        hi = int(np.ceil(d.max())) + margin
        lo = -_FLOW_BUCKET * int(np.ceil(-lo / _FLOW_BUCKET)) \
            if lo < 0 else lo
        hi = _FLOW_BUCKET * int(np.ceil(hi / _FLOW_BUCKET)) \
            if hi > 0 else hi
        return lo, hi

    dx_lo, dx_hi = lo_hi(dxs)
    dy_lo, dy_hi = lo_hi(dys)
    n_taps = (dx_hi - dx_lo + 1) * (dy_hi - dy_lo + 1)
    if n_taps > taps_max:
        return None
    return (dx_lo, dx_hi, dy_lo, dy_hi)


def plan_update(keyframe, refframes, params) -> UpdatePlan:
    """Choose the update path for this keyframe + refframe history.

    Reads the poses/intrinsics to the host (a device sync per array —
    fine offline; the VO driver keeps host-side pose bookkeeping and
    calls :func:`plan_update_np` instead, which never touches the
    device).
    """
    return plan_update_np(
        np.asarray(keyframe.transform_wf, np.float64),
        np.asarray(keyframe.focal_length, np.float64),
        np.asarray(keyframe.offset, np.float64),
        tuple(keyframe.image.shape),
        np.asarray(refframes.transform_wf, np.float64),
        np.asarray(refframes.focal_length, np.float64),
        np.asarray(refframes.offset, np.float64),
        float(np.asarray(params.min_inv_depth)),
        float(np.asarray(params.max_inv_depth)))


def plan_update_np(key_T, key_f, key_c, image_shape,
                   R_T, ref_fs, ref_cs, q0, q1) -> UpdatePlan:
    """Pure-numpy planner core: no device arrays, no syncs.

    ``key_T`` may be the PREDICTED keyframe pose (the VO driver plans
    from a constant-velocity extrapolation so it never has to block on
    the device pose); budget buckets absorb the prediction error.
    """
    n_refs = R_T.shape[0]

    # --- rect feasibility + disparity range -------------------------------
    rect_ok = True
    flips = []
    rect_range_px = 8.0
    for r in range(n_refs):
        T_rk = np.linalg.inv(R_T[r]) @ key_T
        # rect needs a real baseline: near-zero translation (e.g. the
        # first tracked frame planned from an identity pose prediction)
        # makes the disparity-to-depth map degenerate
        if np.linalg.norm(T_rk[:3, 3]) < 1e-5:
            rect_ok = False
            break
        ok, flip = rectification_feasible(
            T_rk, key_f, key_c, ref_fs[r], ref_cs[r], image_shape,
            RECT_MAX_DX, RECT_MAX_DY)
        if not ok:
            rect_ok = False
            break
        flips.append(flip)
        Rr, tr = T_rk[:3, :3], T_rk[:3, 3]
        b = -Rr.T @ tr
        B = np.linalg.norm(b)
        fB = key_f[0] * B
        # per-pixel v_z spread over the image corners (the depth
        # re-projection factor of the rectifying rotation): coverage must
        # span [min_vz * q0, max_vz * q1] disparities, not a flat 10%
        # headroom (which silently truncated windows)
        sgn = -1.0 if flip else 1.0
        r1 = sgn * b / B
        r2 = np.cross([0.0, 0.0, 1.0], r1)
        r2 = r2 / max(np.linalg.norm(r2), 1e-12)
        r3 = np.cross(r1, r2)
        Hh, Ww = image_shape
        cx = (np.array([0.0, Ww - 1.0]) - key_c[0]) / key_f[0]
        cy = (np.array([0.0, Hh - 1.0]) - key_c[1]) / key_f[1]
        vz = np.array([r1[2] * x + r2[2] * y + r3[2]
                       for x in cx for y in cy])
        span = fB * (vz.max() * q1 - vz.min() * q0)
        rect_range_px = max(rect_range_px, span)
    rect_plan = None
    if rect_ok and rect_range_px + N_KEY_SAMPLES + 4 <= MAX_PLANES:
        rect_plan = UpdatePlan(
            'rect',
            (_bucket_planes(rect_range_px + N_KEY_SAMPLES + 4),),
            tuple(flips), (), ())

    # --- tent sweep feasibility, PER refframe ---------------------------
    # Each refframe gets its own budget/plane count (both grow with how
    # far back it is); refframes over the budget cap are redirected to
    # the nearest feasible one instead of dragging the whole history onto
    # the scattered path.
    q_mid = 0.5 * (q0 + q1)
    budgets = []   # per-refframe (far-half, near-half) bucketed budgets
    planes = []
    for r in range(n_refs):
        T_rk = np.linalg.inv(R_T[r]) @ key_T
        d_by_q = {}
        Hs = {}
        feasible = True
        for q in (q0, q_mid, q1):
            H_q = _plane_H(T_rk, q, key_f, key_c, ref_fs[r], ref_cs[r])
            dx, dy = _np_homography_displacement(H_q, image_shape)
            if not np.isfinite(dx) or not np.isfinite(dy):
                feasible = False
                break
            d_by_q[q] = max(dx, dy)
            Hs[q] = H_q
        span = 8.0
        if feasible:
            span = _np_homography_span(Hs[q0], Hs[q1], image_shape)
            feasible = np.isfinite(span)
        if feasible:
            # displacement grows with inverse depth (parallax ~ q plus a
            # rotation floor), so the FAR half of the plane grid gets its
            # own, smaller tent budget — roughly halves the warp cost of
            # wide-baseline refframes at identical results
            b_far = _bucket_budget(max(d_by_q[q0], d_by_q[q_mid]) + 1.0)
            b_near = _bucket_budget(max(d_by_q.values()) + 1.0)
        else:
            b_far = b_near = None
        if b_near is None or b_near > TENT_BUDGET_MAX:
            budgets.append(None)
            planes.append(0)
        else:
            budgets.append((b_far, b_near))
            # ~1-px plane spacing along this refframe's epipolar track,
            # plus the 2*half_w template-window grid extension
            planes.append(_bucket_planes(max(span, 8.0) + 10, cap=128))

    feasible_idx = [r for r in range(n_refs) if budgets[r] is not None]
    tent_plan = None
    if feasible_idx:
        redirect = tuple(
            r if budgets[r] is not None
            else min(feasible_idx, key=lambda j: (abs(j - r), j))
            for r in range(n_refs))
        tent_plan = UpdatePlan(
            'tent',
            tuple(planes[redirect[r]] for r in range(n_refs)),
            (),
            tuple(budgets[redirect[r]] or 0 for r in range(n_refs)),
            redirect)

    # Preference order: full-coverage tent (measures everything on the
    # key grid — no cross-grid interpolation of priors/results) > rect
    # (exact per-refframe geometry at ANY lateral baseline; the stereo
    # path) > tent with age redirects (approximate refframe choice) >
    # scatter.  EXCEPT on cost: tent warp work grows as
    # sum_r planes_r * budget_r (wide-baseline refframes dominate — a
    # budget-32, 64-plane history member costs ~5x the whole near-frame
    # sweep), while the rect path's per-plane work is a constant 1-px
    # shift whatever the baseline; when every refframe is rectifiable and
    # the tent tap work clearly exceeds rect's, rect is the faster exact
    # path (r5: the 5-refframe real-clip update dropped ~2x).
    full_tent = tent_plan is not None and len(feasible_idx) == n_refs
    if full_tent and rect_plan is not None:
        tent_cost = sum(
            s * (b[0] + b[1] + 1) / 2.0
            for s, b in zip(tent_plan.n_planes,
                            (budgets[redirect[r]] for r in range(n_refs))))
        rect_cost = (n_refs * 4 * (2 * RECT_MAX_DX + 1)
                     + 6 * rect_plan.n_planes[0])
        # fire only on decisively expensive histories: tent measures on
        # the key grid (no cross-grid interpolation) and should win all
        # close calls
        if tent_cost > max(3.0 * rect_cost, 3000.0):
            return rect_plan
    if full_tent:
        return tent_plan
    if rect_plan is not None:
        return rect_plan
    if tent_plan is not None:
        return tent_plan

    return UpdatePlan('scatter', (), (), (), ())


def update_depth_fast(keyframe, refframes, age_map, prior_depth,
                      prior_variance, params, plan=None, fuse_prior=False):
    """Dispatching semi-dense depth update; contract of
    estimator.update_depth (semi_dense.rs:160-237)."""
    from tadataka_tpu.vo.semi_dense.estimator import update_depth
    from tadataka_tpu.vo.semi_dense.sweep import update_depth_sweep
    from tadataka_tpu.vo.semi_dense.sweep_rect import update_depth_rect

    if plan is None:
        plan = plan_update(keyframe, refframes, params)
    if plan.path == 'rect':
        return update_depth_rect(
            keyframe, refframes, age_map, prior_depth, prior_variance,
            params, n_planes=plan.n_planes[0], flips=plan.flips,
            max_dx=RECT_MAX_DX, max_dy=RECT_MAX_DY, fuse_prior=fuse_prior)
    if plan.path == 'tent':
        return update_depth_sweep(
            keyframe, refframes, age_map, prior_depth, prior_variance,
            params, n_planes=plan.n_planes, warp_budget=plan.warp_budget,
            key_budget=KEY_BUDGET, redirect=plan.redirect,
            fuse_prior=fuse_prior)
    return update_depth(keyframe, refframes, age_map, prior_depth,
                        prior_variance, params, fuse_prior=fuse_prior)
