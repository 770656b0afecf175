"""Semi-dense VO pipeline: DVO tracking + semi-dense depth mapping.

Parity surface: /root/reference/examples/semi_dense_vo.py:152-207 (the
flagship loop): per frame — pose by DVO against the previous depth map
(bootstrap by feature-based essential estimation), age increment, depth/
variance propagation, full-map epipolar depth update, refframe history.

Library-class form; the reference's hard process-exit on age/history
mismatch (semi_dense.rs:203-205) becomes an age clamp.

Device structure.  A host<->device sync stalls the host until the queue
drains, and every dispatch costs host time, so the per-frame step is at
most TWO device programs and ZERO blocking host reads:

  1. ``_track``: DVO pyramid + age increment
     + hypothesis propagation + device-side pose composition
     T_wc(t) = T_wc(t-1) @ T10^-1, fused into one jitted program;
  2. ``_update``: refframe stacking + age clamp + the PLANNED depth
     update (vo/semi_dense/fast.py — tent/rect plane sweeps with
     per-refframe budgets) + 3x3 regularization, one jitted program per
     (plan, history-length) bucket.

The planner needs host pose values, so the driver keeps a host-side pose
chain fed by one-frame-lagged ASYNC fetches of T10 and plans from a
constant-velocity extrapolation of the keyframe pose — the budget
buckets absorb the prediction error, and nothing ever blocks on the
device.  ``SemiDenseVO.estimate`` itself is what the benchmark times
(the product and the bench must not diverge).  The
scattered estimator remains as ``depth_update="scatter"`` for exact
reference-parity runs.
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from tadataka_tpu.camera import CameraParameters
from tadataka_tpu.core.pose import Pose
from tadataka_tpu.core.transforms import inv_motion_matrix, motion_matrix
from tadataka_tpu.dataset.image_io import rgb2gray
from tadataka_tpu.vo.dvo import DEFAULT_SAMPLE_BUDGET, estimate_pose_pyramid
from tadataka_tpu.vo.semi_dense import (
    SemiDenseParams, make_frame, update_depth, propagate, propagate_tent,
    increment_age, regularize)
from tadataka_tpu.vo.semi_dense.estimator import safe_invert
from tadataka_tpu.vo.semi_dense.fast import (
    plan_flow_bounds, plan_update_np, update_depth_fast)
from tadataka_tpu.vo.semi_dense.frame import SemiDenseFrame, stack_frames


class SemiDenseVOState(NamedTuple):
    pose_wc: Pose          # camera -> world of the latest frame (on device)
    depth_map: jnp.ndarray
    variance_map: jnp.ndarray
    age_map: jnp.ndarray
    flag_map: Optional[jnp.ndarray]


# NOTE on pose fetches: the pose chain drains with a plain np.asarray one
# frame later, when the buffer is long since computed — the fetch then
# overlaps with the device working on the current frame.


# Module-level jitted per-frame programs: shared across SemiDenseVO
# instances (a per-instance closure would re-trace the whole pipeline for
# every new VO object — seconds per frame on short clips).

@jax.jit
def _to_gray_f32(image_u8):
    """uint8 [0, 255] -> f32 [0, 1] on device (images upload as uint8:
    4x less host->device traffic per frame)."""
    return image_u8.astype(jnp.float32) / 255.0


def _propagate_step(cam, T10, D0, V0, age0, dd, dv, bias, flow_bounds):
    """Age + hypothesis propagation: the tap-scatter fast path when the
    planner supplied static flow bounds, else the general scatter path
    (propagation.py::propagate_tent docstring)."""
    if flow_bounds is not None:
        return propagate_tent(T10, cam, cam, D0, V0, age0, dd, dv, bias,
                              flow_bounds)
    age1 = increment_age(age0, cam, cam, T10, D0)
    d1, v1 = propagate(T10, cam, cam, D0, V0, dd, dv, bias)
    return d1, v1, age1


@partial(jax.jit, static_argnames=("cfg", "flow_bounds"))
def _track_fn(cm, cam, I0, D0, V0, age0, I1_u8, R_prev, t_prev, *, cfg,
              flow_bounds=None):
    n_levels, budget, dd, dv, bias = cfg
    I1 = I1_u8.astype(jnp.float32) / 255.0
    weights = safe_invert(V0)
    R10, t10 = estimate_pose_pyramid(
        cm, cm, I0, D0, I1, weights,
        jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, dtype=jnp.float32),
        n_levels, 20, 1.5, "map", "ic", budget)
    T10 = motion_matrix(R10, t10)
    T_wk = motion_matrix(R_prev, t_prev) @ inv_motion_matrix(T10)
    d1, v1, age1 = _propagate_step(cam, T10, D0, V0, age0, dd, dv, bias,
                                   flow_bounds)
    return I1, T10, T_wk, T_wk[:3, :3], T_wk[:3, 3], age1, d1, v1


@partial(jax.jit, static_argnames=("cfg", "flow_bounds"))
def _age_propagate_fn(cam, I1_u8, T10, D0, V0, age0, R_prev, t_prev,
                      *, cfg, flow_bounds=None):
    dd, dv, bias = cfg
    I1 = I1_u8.astype(jnp.float32) / 255.0
    T_wk = motion_matrix(R_prev, t_prev) @ inv_motion_matrix(T10)
    d1, v1, age1 = _propagate_step(cam, T10, D0, V0, age0, dd, dv, bias,
                                   flow_bounds)
    return I1, T_wk, T_wk[:3, :3], T_wk[:3, 3], age1, d1, v1


@partial(jax.jit, static_argnames=("plan", "cfg"))
def _update_fn(cam, params, image, T_wk, ref_frames, age1, d1, v1,
               *, plan, cfg):
    do_reg, n_ref_samples, fuse_prior = cfg
    keyframe = make_frame(cam, image, T_wk)
    refs = stack_frames(ref_frames)
    age_c = jnp.clip(age1, 0, refs.image.shape[0])
    if plan is None:
        d2, v2, flags = update_depth(
            keyframe, refs, age_c, d1, v1, params,
            n_ref_samples=n_ref_samples, fuse_prior=fuse_prior)
    else:
        d2, v2, flags = update_depth_fast(
            keyframe, refs, age_c, d1, v1, params, plan=plan,
            fuse_prior=fuse_prior)
    if do_reg:
        d2 = regularize(d2, v2, flags)
    return d2, v2, flags


@partial(jax.jit, static_argnames=("track_cfg", "update_cfg", "plan",
                                   "flow_bounds"))
def _step_fn(cm, cam, params, I0, D0, V0, age0, I1_u8, R_prev, t_prev,
             ref_frames, *, track_cfg, update_cfg, plan, flow_bounds):
    """The whole per-frame step (DVO track + age/propagate + planned
    depth update + regularize) as ONE device program — the plan comes
    from the host-side constant-velocity prediction, never from this
    frame's device values, so nothing forces a mid-frame dispatch break
    (one program saves dispatches and lets XLA overlap the stages)."""
    I1, T10, T_wk, R_wk, t_wk, age1, d1, v1 = _track_fn(
        cm, cam, I0, D0, V0, age0, I1_u8, R_prev, t_prev,
        cfg=track_cfg, flow_bounds=flow_bounds)
    d2, v2, flags = _update_fn(cam, params, I1, T_wk, ref_frames,
                               age1, d1, v1, plan=plan, cfg=update_cfg)
    return I1, T10, T_wk, R_wk, t_wk, age1, d2, v2, flags


class SemiDenseVO:
    def __init__(self, camera_params: CameraParameters,
                 params: SemiDenseParams = None,
                 default_depth=200.0, default_variance=100.0,
                 uncertainty_bias=1.0, depth_range=(60.0, 1000.0),
                 history_size=8, n_ref_samples=64,
                 n_coarse_to_fine=5, regularize_depth=True,
                 initial_pose_fn=None, seed=0,
                 depth_update="fast", dvo_sample_budget=None,
                 metrics=None, initial_depth_map=None,
                 initial_variance_map=None, fuse_prior=True):
        """``initial_pose_fn(image0, image1) -> Pose`` optionally supplies
        the scale-ambiguous bootstrap pose for the second frame (the
        reference uses feature matching + essential estimation with a
        manual scale, examples/semi_dense_vo.py:124-127).

        ``depth_update``: "fast" routes the full-map update through the
        host-planned tent/rect plane sweeps (fast.plan_update_np);
        "scatter" forces the general vmapped estimator on every frame.
        ``dvo_sample_budget``: see vo/dvo.py (None = DEFAULT_SAMPLE_BUDGET).
        ``metrics``: optional utils.observability.MetricsLogger; every
        frame logs the planner's decision (path, plane counts, warp
        budgets, propagation tap bounds) so a silent fall to the 40x
        slower scattered path is visible.

        ``fuse_prior``: precision-weighted fusion of each frame's new
        depth observation with the prior hypothesis (the LSD-SLAM depth
        filter).  The reference REPLACES the hypothesis every frame
        (semi_dense.rs:221-225), which lets small-baseline matching
        noise erase accumulated estimates over long sequences; fusion is
        the default here (set False for exact reference semantics).

        ``initial_depth_map`` / ``initial_variance_map``: optional (H, W)
        bootstrap prior (e.g. from a stereo pair, as the NewTsukuba
        example does).  Without one the map initializes RANDOM in
        ``depth_range`` — the reference's convention — but note that
        frame-to-frame photometric tracking against a noisy bootstrap
        map is weakly observable at narrow FOV (the optimum trades
        translation for rotation; measured r5): prefer a real prior for
        metric trajectories."""
        self.camera_params = camera_params
        self.params = params or SemiDenseParams.create(
            depth_range[0], depth_range[1],
            geo_coeff=0.01, photo_coeff=0.01,
            ref_step_size=0.01, min_gradient=0.2)
        self.depth_range = depth_range
        self.default_depth = default_depth
        self.default_variance = default_variance
        self.uncertainty_bias = uncertainty_bias
        self.history_size = history_size
        self.n_ref_samples = n_ref_samples
        self.n_coarse_to_fine = n_coarse_to_fine
        self.regularize_depth = regularize_depth
        self.fuse_prior = fuse_prior
        self.initial_pose_fn = initial_pose_fn
        self.initial_depth_map = initial_depth_map
        self.initial_variance_map = initial_variance_map
        self.seed = seed
        assert depth_update in ("fast", "scatter")
        self.depth_update = depth_update
        if dvo_sample_budget is None:
            dvo_sample_budget = DEFAULT_SAMPLE_BUDGET
        self.dvo_sample_budget = dvo_sample_budget

        from tadataka_tpu.camera import CameraModel
        self._camera_model = CameraModel.create(camera_params)

        # planner constants, read ONCE (never per frame)
        self._q0 = float(np.asarray(self.params.min_inv_depth))
        self._q1 = float(np.asarray(self.params.max_inv_depth))
        self._focal_np = np.asarray(camera_params.focal_length, np.float64)
        self._offset_np = np.asarray(camera_params.offset, np.float64)

        self.refframes = []            # device SemiDenseFrames
        self._ref_Ts_host = []         # host 4x4 poses of the refframes
        self.state: Optional[SemiDenseVOState] = None
        self._prev_image = None
        self._image_shape = None

        # host-side pose chain: exact but LAGGED.  A device->host fetch
        # serializes behind the compute queue (a full sync), so T10s are
        # drained in batches of ``pose_drain_interval`` frames; in
        # between, keyframe poses are constant-velocity predictions
        # (bucketed plan budgets absorb the error, and refframe poses are
        # corrected when the batch lands).
        self._pose_wc_host = np.eye(4)
        self._T10_host = np.eye(4)
        self._pending = []             # [(frame_id, T10 device array)]
        self._frame_id = 0
        self._ref_ids = []
        self.pose_drain_interval = 4

        self._track = self._build_track()
        self._age_propagate = self._build_age_propagate()
        self._update = self._build_update()
        self._step = self._build_step()

        # An image upload is a BLOCKING host call; a one-worker uploader
        # lets the driver overlap the next frame's gray conversion + upload
        # with the current frame's device step (see :meth:`prefetch`).
        self._uploader = ThreadPoolExecutor(max_workers=1)
        self._upload_futures = {}
        self._plan_cache = {}
        self.metrics = metrics

    # ------------------------------------------------------- device steps

    def _build_track(self):
        cm = self._camera_model
        cam = self.camera_params
        cfg = (self.n_coarse_to_fine, self.dvo_sample_budget,
               self.default_depth, self.default_variance,
               self.uncertainty_bias)
        return lambda *args, flow_bounds=None: _track_fn(
            cm, cam, *args, cfg=cfg, flow_bounds=flow_bounds)

    def _build_age_propagate(self):
        cam = self.camera_params
        cfg = (self.default_depth, self.default_variance,
               self.uncertainty_bias)
        return lambda *args, flow_bounds=None: _age_propagate_fn(
            cam, *args, cfg=cfg, flow_bounds=flow_bounds)

    def _build_step(self):
        cm = self._camera_model
        cam = self.camera_params
        params = self.params
        track_cfg = (self.n_coarse_to_fine, self.dvo_sample_budget,
                     self.default_depth, self.default_variance,
                     self.uncertainty_bias)
        update_cfg = (self.regularize_depth, self.n_ref_samples,
                      self.fuse_prior)
        return lambda *args: _step_fn(
            cm, cam, params, *args[:-3], ref_frames=args[-3],
            track_cfg=track_cfg, update_cfg=update_cfg,
            plan=args[-2], flow_bounds=args[-1])

    def _flow_bounds(self):
        """Static tap bounds for this frame's propagation, planned from
        the constant-velocity T10 prediction (host numpy; bucketed so a
        run compiles a handful of tap grids).  None -> scatter path."""
        if self.depth_update != "fast":
            return None
        return plan_flow_bounds(self._T10_host, self._focal_np,
                                self._offset_np, self._image_shape,
                                self._q0, self._q1)

    def _build_update(self):
        params = self.params
        cam = self.camera_params
        cfg = (self.regularize_depth, self.n_ref_samples, self.fuse_prior)
        return lambda image, T_wk, refs, age1, d1, v1, plan: _update_fn(
            cam, params, image, T_wk, refs, age1, d1, v1,
            plan=plan, cfg=cfg)

    # --------------------------------------------------- host pose chain

    def _advance_pose_chain(self, force=False):
        """Fold pending T10 fetches into the host pose chain and correct
        the refframe poses that were pushed as predictions.  Drains only
        when the batch is full (or ``force``) — each drain costs one
        device->host round trip that overlaps with current device work."""
        if not self._pending:
            return
        if not force and len(self._pending) < self.pose_drain_interval:
            return
        for fid, T10_dev in self._pending:
            self._T10_host = np.asarray(T10_dev, np.float64)
            self._pose_wc_host = (
                self._pose_wc_host @ np.linalg.inv(self._T10_host))
            if fid in self._ref_ids:
                self._ref_Ts_host[self._ref_ids.index(fid)] = \
                    self._pose_wc_host
        self._pending = []

    def _plan(self, key_T_pred):
        """Plan the depth update from the best available host estimate of
        the keyframe pose — exact for the bootstrap frame, a
        constant-velocity prediction otherwise (host numpy only; zero
        device syncs).  Memoized on the ROUNDED relative transforms: the
        plan is bucketed anyway, and under smooth motion consecutive
        frames hit the cache (~2 ms of host numpy per frame saved)."""
        n = min(len(self._ref_Ts_host), self.history_size)
        ref_Ts = np.stack(self._ref_Ts_host[-n:])
        rels = np.stack([np.linalg.inv(T) @ key_T_pred for T in ref_Ts])
        key = (n, tuple(np.round(rels[:, :3, :].ravel(), 3)))
        hit = self._plan_cache.get(key)
        if hit is not None:
            return hit
        f = np.broadcast_to(self._focal_np, (n, 2))
        c = np.broadcast_to(self._offset_np, (n, 2))
        plan = plan_update_np(key_T_pred, self._focal_np, self._offset_np,
                              self._image_shape, ref_Ts, f, c,
                              self._q0, self._q1)
        self._plan_cache[key] = plan
        return plan

    # ------------------------------------------------------------- driver

    def _prepare_image(self, frame):
        """Host gray conversion + uint8 quantization + device upload."""
        image = frame.image if hasattr(frame, "image") else frame
        gray = rgb2gray(np.asarray(image))
        return jnp.asarray(
            np.clip(np.round(np.asarray(gray) * 255.0), 0, 255)
            .astype(np.uint8))

    def prefetch(self, frame):
        """Start this frame's gray conversion + upload on the worker
        thread; a later ``estimate(frame)`` picks up the result.  Call
        with frame t+1 right after ``estimate(frame_t)`` to hide the
        ~8 ms of per-frame host image work behind the device step."""
        self._upload_futures[id(frame)] = self._uploader.submit(
            self._prepare_image, frame)

    def estimate(self, frame):
        """Process a frame (Frame or raw image).  Returns the state."""
        fut = self._upload_futures.pop(id(frame), None)
        image_u8 = fut.result() if fut is not None \
            else self._prepare_image(frame)

        if self.state is None:
            return self._initialize(image_u8)

        prev = self.state
        # Early frames force-drain (one sync each): until the first real
        # T10 lands, the constant-velocity prediction is identity and the
        # planner would pick near-zero budgets/flow bounds, silently
        # degrading the first frames' depth updates.
        self._advance_pose_chain(force=self._frame_id <= 2)

        # 1-2. pose tracking + age/hypothesis propagation (one program)
        if len(self.refframes) == 1 and self.initial_pose_fn is not None:
            # user bootstrap callbacks get [0, 1] float images (only the
            # bootstrap frame pays this extra cast dispatch)
            pose10 = self.initial_pose_fn(self._prev_image,
                                          _to_gray_f32(image_u8))
            T10_host = np.asarray(pose10.T, np.float64)
            T10 = jnp.asarray(T10_host, jnp.float32)
            self._T10_host = T10_host
            image, T_wk, R_wk, t_wk, age1, depth1, variance1 = \
                self._age_propagate(
                    image_u8, T10, prev.depth_map, prev.variance_map,
                    prev.age_map, prev.pose_wc.R, prev.pose_wc.t,
                    flow_bounds=self._flow_bounds())
            self._pose_wc_host = (
                self._pose_wc_host @ np.linalg.inv(T10_host))
            push_T_host = self._pose_wc_host           # exact
            # 3. planned depth update (bootstrap frame: separate dispatch)
            plan = (self._plan(push_T_host)
                    if self.depth_update == "fast" else None)
            refs = tuple(self.refframes[-self.history_size:])
            depth1, variance1, flags = self._update(
                image, T_wk, refs, age1, depth1, variance1, plan)
        else:
            # steady state: the ENTIRE frame step is one device program —
            # the plan uses the constant-velocity prediction over the
            # undrained frames (corrected when the batch lands), so no
            # device value is needed before dispatch
            inv_T = np.linalg.inv(self._T10_host)
            push_T_host = self._pose_wc_host.copy()
            for _ in range(len(self._pending) + 1):
                push_T_host = push_T_host @ inv_T
            plan = (self._plan(push_T_host)
                    if self.depth_update == "fast" else None)
            refs = tuple(self.refframes[-self.history_size:])
            (image, T10, T_wk, R_wk, t_wk, age1, depth1, variance1,
             flags) = self._step(
                self._prev_image, prev.depth_map, prev.variance_map,
                prev.age_map, image_u8, prev.pose_wc.R, prev.pose_wc.t,
                refs, plan, self._flow_bounds())
            self._pending.append((self._frame_id, T10))

        if self.metrics is not None:
            fb = self._flow_bounds()
            self.metrics.log_frame(
                self._frame_id,
                plan_path=plan.path if plan is not None else "scatter",
                plan_n_planes=sum(plan.n_planes) if plan is not None else 0,
                plan_max_budget=(max((max(b) if not isinstance(b, int)
                                      else b) for b in plan.warp_budget)
                                 if plan is not None and plan.warp_budget
                                 else 0),
                flow_taps=((fb[1] - fb[0] + 1) * (fb[3] - fb[2] + 1)
                           if fb is not None else 0))
        self._push_refframe(
            SemiDenseFrame(jnp.asarray(self.camera_params.focal_length),
                           jnp.asarray(self.camera_params.offset),
                           image, T_wk),
            push_T_host)
        self.state = SemiDenseVOState(Pose(R_wk, t_wk), depth1, variance1,
                                      age1, flags)
        self._prev_image = image
        return self.state

    def _initialize(self, image_u8):
        image = _to_gray_f32(image_u8)
        H, W = image.shape
        self._image_shape = (H, W)
        rng = np.random.default_rng(self.seed)
        if self.initial_depth_map is not None:
            depth = jnp.asarray(self.initial_depth_map, jnp.float32)
        else:
            depth = jnp.asarray(
                rng.uniform(*self.depth_range, (H, W)).astype(np.float32))
        if self.initial_variance_map is not None:
            variance = jnp.asarray(self.initial_variance_map, jnp.float32)
        else:
            variance = self.default_variance * jnp.ones((H, W))
        age = jnp.zeros((H, W), dtype=jnp.int32)
        pose_wc = Pose.identity()
        keyframe = make_frame(self.camera_params, image, pose_wc.T)
        self._push_refframe(keyframe, np.eye(4))
        self.state = SemiDenseVOState(pose_wc, depth, variance, age, None)
        self._prev_image = image
        return self.state

    def _push_refframe(self, keyframe, T_host):
        self.refframes.append(keyframe)
        self._ref_Ts_host.append(np.asarray(T_host, np.float64))
        self._ref_ids.append(self._frame_id)
        self._frame_id += 1
        if len(self.refframes) > self.history_size:
            self.refframes.pop(0)
            self._ref_Ts_host.pop(0)
            self._ref_ids.pop(0)

    @property
    def pose_wc_host(self):
        """Latest EXACT host pose (lags the device by one frame until
        :meth:`finish` is called)."""
        return self._pose_wc_host

    def finish(self):
        """Drain all pending pose fetches (one device sync); returns the
        final exact host pose."""
        self._advance_pose_chain(force=True)
        return self._pose_wc_host
