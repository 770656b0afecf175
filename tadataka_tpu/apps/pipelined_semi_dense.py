"""Pipeline-parallel semi-dense VO: tracker and mapper on separate chips.

SURVEY §2.3's last row: the reference runs tracking and depth mapping
inline in one thread (/root/reference/examples/semi_dense_vo.py:174-207);
LSD-SLAM's actual architecture decouples them into concurrent threads
where the TRACKER always consumes the most recent COMPLETED depth map.
On accelerators that decoupling is device-level pipelining:

  device T (tracker): DVO pyramid + pose composition
  device M (mapper):  age increment + propagation + planned plane-sweep
                      depth update + regularization

The mapper runs ONE FRAME BEHIND the tracker: ``estimate(t)`` dispatches
track(t) and map(t-1).  track(t) reads the newest COMPLETED map
(frame t-2's), and map(t-1) consumes track(t-1)'s pose from the previous
call — so neither program enqueued this frame depends on the other, and
the two devices genuinely execute concurrently: steady-state throughput
approaches max(track, map) instead of track + map (a same-frame
dispatch order would serialize them).  The
one/two-frame-stale tracking map is the standard LSD-SLAM semantics, not
an approximation invented here.  ``state.depth_map`` therefore lags the
pose by one frame; call :meth:`flush_map` to complete the final frame's
map after the last ``estimate``.

Cross-device traffic per frame: the (H, W) f32 image + pose (T->M) and
the depth/variance/age maps (M->T), all moved by ``jax.device_put`` —
intra-host device-to-device (NVLink) copies between GPUs of one host;
works identically on the virtual CPU mesh of the tests
(tests/parallel/test_pipelined.py).
"""

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from tadataka_tpu.camera import CameraParameters, CameraModel
from tadataka_tpu.core.pose import Pose
from tadataka_tpu.core.transforms import inv_motion_matrix, motion_matrix
from tadataka_tpu.dataset.image_io import rgb2gray
from tadataka_tpu.vo.dvo import DEFAULT_SAMPLE_BUDGET, estimate_pose_pyramid
from tadataka_tpu.vo.semi_dense import (
    SemiDenseParams, make_frame, propagate, propagate_tent, increment_age,
    regularize)
from tadataka_tpu.vo.semi_dense.estimator import safe_invert
from tadataka_tpu.vo.semi_dense.fast import (
    plan_flow_bounds, plan_update_np, update_depth_fast)
from tadataka_tpu.vo.semi_dense.frame import SemiDenseFrame, stack_frames


@partial(jax.jit, static_argnames=("cfg",))
def _track_stage(cm, I0, D_track, V_track, I1, R_prev, t_prev, *, cfg):
    """Tracker-device program: DVO against the newest COMPLETED map."""
    n_levels, budget = cfg
    weights = safe_invert(V_track)
    R10, t10 = estimate_pose_pyramid(
        cm, cm, I0, D_track, I1, weights,
        jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, dtype=jnp.float32),
        n_levels, 20, 1.5, "map", "ic", budget)
    T10 = motion_matrix(R10, t10)
    T_wk = motion_matrix(R_prev, t_prev) @ inv_motion_matrix(T10)
    return T10, T_wk, T_wk[:3, :3], T_wk[:3, 3]


@partial(jax.jit, static_argnames=("plan", "cfg", "flow_bounds"))
def _map_stage(cam, params, image, T10, T_wk, ref_frames, age0, D0, V0,
               *, plan, cfg, flow_bounds=None):
    """Mapper-device program: age + propagate + planned update + reg."""
    do_reg, dd, dv, bias, fuse_prior = cfg
    if flow_bounds is not None:
        d1, v1, age1 = propagate_tent(T10, cam, cam, D0, V0, age0,
                                      dd, dv, bias, flow_bounds)
    else:
        age1 = increment_age(age0, cam, cam, T10, D0)
        d1, v1 = propagate(T10, cam, cam, D0, V0, dd, dv, bias)
    keyframe = make_frame(cam, image, T_wk)
    refs = stack_frames(ref_frames)
    age_c = jnp.clip(age1, 0, refs.image.shape[0])
    d2, v2, flags = update_depth_fast(keyframe, refs, age_c, d1, v1,
                                      params, plan=plan,
                                      fuse_prior=fuse_prior)
    if do_reg:
        d2 = regularize(d2, v2, flags)
    return age1, d2, v2, flags


class PipelinedSemiDenseVOState(NamedTuple):
    pose_wc: Pose
    depth_map: jnp.ndarray
    variance_map: jnp.ndarray
    age_map: jnp.ndarray
    flag_map: Optional[jnp.ndarray]


class PipelinedSemiDenseVO:
    """Two-device tracker/mapper pipeline (see module docstring).

    ``devices``: (tracker_device, mapper_device); defaults to the first
    two visible devices.  Falls back to single-device placement when
    only one device exists (the pipeline structure is unchanged)."""

    def __init__(self, camera_params: CameraParameters,
                 params: SemiDenseParams = None,
                 default_depth=200.0, default_variance=100.0,
                 uncertainty_bias=1.0, depth_range=(60.0, 1000.0),
                 history_size=4, n_coarse_to_fine=5,
                 regularize_depth=True, dvo_sample_budget=None,
                 devices=None, seed=0, initial_pose_fn=None,
                 fuse_prior=True):
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
        self.n_coarse_to_fine = n_coarse_to_fine
        self.regularize_depth = regularize_depth
        self.fuse_prior = fuse_prior
        self.initial_pose_fn = initial_pose_fn
        self.seed = seed
        if dvo_sample_budget is None:
            dvo_sample_budget = DEFAULT_SAMPLE_BUDGET
        self.dvo_sample_budget = dvo_sample_budget
        if devices is None:
            ds = jax.devices()
            devices = (ds[0], ds[min(1, len(ds) - 1)])
        self.dev_track, self.dev_map = devices
        self._camera_model = CameraModel.create(camera_params)

        self._q0 = float(np.asarray(self.params.min_inv_depth))
        self._q1 = float(np.asarray(self.params.max_inv_depth))
        self._focal_np = np.asarray(camera_params.focal_length, np.float64)
        self._offset_np = np.asarray(camera_params.offset, np.float64)

        self.refframes = []            # on the MAPPER device
        self._ref_Ts_host = []
        self.state: Optional[PipelinedSemiDenseVOState] = None
        self._prev_image_t = None      # tracker-device copy
        self._track_map = None         # (depth, variance) on tracker dev
        self._image_shape = None
        self._pose_wc_host = np.eye(4)
        self._T10_host = np.eye(4)
        self._pending = []
        self.pose_drain_interval = 4
        self._frame_id = 0
        self._track_frame_id = 0
        self._pending_map = None
        self._ref_ids = []

    # ------------------------------------------------------------- driver

    def estimate(self, frame):
        image = frame.image if hasattr(frame, "image") else frame
        gray = np.asarray(rgb2gray(np.asarray(image)), np.float32)

        if self.state is None:
            return self._initialize(gray)

        self._advance_pose_chain(force=self._track_frame_id <= 2)
        self._track_frame_id += 1

        # tracker device: pose of frame t against the newest COMPLETED
        # map (two frames stale — LSD-SLAM tracking semantics)
        I1_t = jax.device_put(jnp.asarray(gray), self.dev_track)
        if len(self.refframes) == 1 and self.initial_pose_fn is not None:
            # scale-fixing bootstrap, as in SemiDenseVO
            pose10 = self.initial_pose_fn(self._prev_image_t, I1_t)
            T10_host = np.asarray(pose10.T, np.float64)
            T10 = jax.device_put(jnp.asarray(T10_host, jnp.float32),
                                 self.dev_track)
            T_wk_h = self._pose_wc_host @ np.linalg.inv(T10_host)
            T_wk = jax.device_put(jnp.asarray(T_wk_h, jnp.float32),
                                  self.dev_track)
            R_wk, t_wk = T_wk[:3, :3], T_wk[:3, 3]
            self._T10_host = T10_host
            self._pose_wc_host = T_wk_h
        else:
            D_tr, V_tr = self._track_map
            R_prev_t, t_prev_t = self._pose_t
            T10, T_wk, R_wk, t_wk = _track_stage(
                self._cm_t, self._prev_image_t, D_tr, V_tr, I1_t,
                R_prev_t, t_prev_t,
                cfg=(self.n_coarse_to_fine, self.dvo_sample_budget))
            self._pending.append((self._track_frame_id, T10))
        self._pose_t = (R_wk, t_wk)          # stays tracker-resident

        # mapper device: dispatch the PREVIOUS frame's map step (its pose
        # is already computed, so map(t-1) never waits on track(t)) ...
        self._dispatch_pending_map()

        # ... and queue this frame's mapper inputs for the next call
        inv_T = np.linalg.inv(self._T10_host)
        push_T_host = self._pose_wc_host.copy()
        for _ in range(len(self._pending)):
            push_T_host = push_T_host @ inv_T
        image_m = jax.device_put(jnp.asarray(gray), self.dev_map)
        self._pending_map = (image_m, T10, T_wk, push_T_host,
                             (R_wk, t_wk))
        self._prev_image_t = I1_t
        return self.state

    def _dispatch_pending_map(self):
        """Run the mapper stage for the queued frame (if any); updates
        ``state``, the refframe history, and the tracker's map copy."""
        if self._pending_map is None:
            return
        image_m, T10, T_wk, push_T_host, pose_tw = self._pending_map
        self._pending_map = None
        prev = self.state
        plan = self._plan(push_T_host)
        T10_m = jax.device_put(T10, self.dev_map)
        T_wk_m = jax.device_put(T_wk, self.dev_map)
        refs = tuple(self.refframes[-self.history_size:])
        bounds = plan_flow_bounds(self._T10_host, self._focal_np,
                                  self._offset_np, self._image_shape,
                                  self._q0, self._q1)
        age1, d2, v2, flags = _map_stage(
            self._cam_m, self._params_m, image_m, T10_m, T_wk_m, refs,
            prev.age_map, prev.depth_map, prev.variance_map,
            plan=plan,
            cfg=(self.regularize_depth, self.default_depth,
                 self.default_variance, self.uncertainty_bias,
                 self.fuse_prior),
            flow_bounds=bounds)

        # ship the completed map back to the tracker (consumed two frames
        # after its own — the pipeline's staleness contract)
        self._track_map = (jax.device_put(d2, self.dev_track),
                           jax.device_put(v2, self.dev_track))
        self._push_refframe(
            SemiDenseFrame(self._focal_m, self._offset_m, image_m, T_wk_m),
            push_T_host)
        self.state = PipelinedSemiDenseVOState(
            Pose(jax.device_put(pose_tw[0], self.dev_map),
                 jax.device_put(pose_tw[1], self.dev_map)),
            d2, v2, age1, flags)

    def flush_map(self):
        """Complete the final frame's mapper stage (call once after the
        last ``estimate``); returns the up-to-date state."""
        self._dispatch_pending_map()
        return self.state

    def _initialize(self, gray):
        H, W = gray.shape
        self._image_shape = (H, W)
        rng = np.random.default_rng(self.seed)
        depth = jnp.asarray(
            rng.uniform(*self.depth_range, (H, W)).astype(np.float32))
        variance = self.default_variance * jnp.ones((H, W), jnp.float32)
        age = jnp.zeros((H, W), dtype=jnp.int32)

        self._cm_t = jax.device_put(self._camera_model, self.dev_track)
        self._cam_m = jax.device_put(self.camera_params, self.dev_map)
        self._params_m = jax.device_put(self.params, self.dev_map)
        self._focal_m = jax.device_put(
            jnp.asarray(self.camera_params.focal_length), self.dev_map)
        self._offset_m = jax.device_put(
            jnp.asarray(self.camera_params.offset), self.dev_map)

        image_m = jax.device_put(jnp.asarray(gray), self.dev_map)
        pose_wc = Pose.identity()
        keyframe = SemiDenseFrame(self._focal_m, self._offset_m, image_m,
                                  jax.device_put(jnp.asarray(pose_wc.T),
                                                 self.dev_map))
        self._push_refframe(keyframe, np.eye(4))
        self.state = PipelinedSemiDenseVOState(
            pose_wc,
            jax.device_put(depth, self.dev_map),
            jax.device_put(variance, self.dev_map),
            jax.device_put(age, self.dev_map), None)
        self._prev_image_t = jax.device_put(jnp.asarray(gray),
                                            self.dev_track)
        self._track_map = (jax.device_put(depth, self.dev_track),
                           jax.device_put(variance, self.dev_track))
        self._pose_t = (
            jax.device_put(jnp.eye(3, dtype=jnp.float32), self.dev_track),
            jax.device_put(jnp.zeros(3, dtype=jnp.float32),
                           self.dev_track))
        return self.state

    # ------------------------------------------- host pose chain (as app)

    def _advance_pose_chain(self, force=False):
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
        n = min(len(self._ref_Ts_host), self.history_size)
        ref_Ts = np.stack(self._ref_Ts_host[-n:])
        f = np.broadcast_to(self._focal_np, (n, 2))
        c = np.broadcast_to(self._offset_np, (n, 2))
        return plan_update_np(key_T_pred, self._focal_np, self._offset_np,
                              self._image_shape, ref_Ts, f, c,
                              self._q0, self._q1)

    def _push_refframe(self, keyframe, T_host):
        self.refframes.append(keyframe)
        self._ref_Ts_host.append(np.asarray(T_host, np.float64))
        self._ref_ids.append(self._frame_id)
        self._frame_id += 1
        if len(self.refframes) > self.history_size:
            self.refframes.pop(0)
            self._ref_Ts_host.pop(0)
            self._ref_ids.pop(0)

    def finish(self):
        self._dispatch_pending_map()
        self._advance_pose_chain(force=True)
        return self._pose_wc_host
