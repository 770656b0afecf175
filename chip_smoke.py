"""Smoke test of the VO pipelines on one GPU.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # the multi-card paths on four cards

Drives the main paths through the entry points a user calls, at the full
width of a TUM RGB-D freiburg1 camera (640x480, fx=517.3, fy=516.5), on an
in-memory sequence rendered from a seed (``dataset/synthetic.py``), and
gates each phase on accuracy against ground truth or a plain reference:

1. ``apps.SemiDenseVO.estimate`` (history 8) over the sequence;
2. the planned depth update (tent and rect paths) against the scattered
   estimator it replaces;
3. ``apps.DvoTrajectory`` over the sequence, and the two DVO resample arms;
4. ``vo.feature_based.FeatureBasedVO`` with its windowed BA.

It refuses to run without a GPU.  Every phase that fails raises, so the
script exits non-zero without its last line, which is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np


class Config(NamedTuple):
    """Camera and run sizes.  ``TUM_FR1`` is what the card runs; smaller
    configs exist only to rehearse the control flow on a CPU."""
    image_shape: tuple = (480, 640)
    focal: tuple = (517.3, 516.5)      # TUM RGB-D freiburg1 pinhole
    history: int = 8
    n_semi_dense: int = 30
    n_dvo: int = 30
    n_feature: int = 12
    n_pipelined: int = 3


TUM_FR1 = Config()

# Key and reference frame of the two-view depth-update checks.
TENT_PAIR = (3, 2)

# Prior depth range, bracketing the rendered scene (planes at depth 5-12).
# Its near end sets the widest parallax the planner must cover: at 4 the
# consecutive-frame sweep fits the tent budget from the bootstrap frame on.
DEPTH_RANGE = (4.0, 50.0)


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------------ data

def make_sequence(cfg, n_frames):
    """The motion of tests/vo/test_long_trajectory.py (sideways sweep,
    forward drift, yaw/pitch wobble) over its three-plane scene.  That
    test renders 100 px at f=80, the field of view of 640 px at f=517.3,
    so the same scene and metric motion give 6.4x its image flow here:
    7-9 px per frame, the flow of a handheld freiburg1 sequence."""
    import jax.numpy as jnp
    from tadataka_tpu.core.pose import Pose
    from tadataka_tpu.dataset.synthetic import multi_plane_scene
    poses = [Pose.from_rotvec(
        jnp.array([0.002 * np.sin(0.4 * i), 0.004 * i, 0.001 * i]),
        jnp.array([0.12 * i + 0.03 * np.sin(0.5 * i),
                   0.02 * np.cos(0.3 * i),
                   0.02 * i]))
        for i in range(n_frames)]
    ds = multi_plane_scene(n_frames=n_frames, image_shape=cfg.image_shape,
                           focal_length=cfg.focal, poses=poses)
    return [ds[i] for i in range(n_frames)]


def semi_dense_params():
    from tadataka_tpu.vo.semi_dense import SemiDenseParams
    return SemiDenseParams.create(*DEPTH_RANGE, ref_step_size=0.002,
                                  min_gradient=0.01)


def camera(cfg):
    from tadataka_tpu.camera import CameraParameters
    H, W = cfg.image_shape
    return CameraParameters.create(cfg.focal, (W / 2, H / 2))


def trajectory_errors(est, gt):
    """(Umeyama-aligned ATE / extent, RPE over 1-frame steps / mean step)."""
    import jax.numpy as jnp
    from tadataka_tpu.metrics import (absolute_trajectory_error,
                                      relative_pose_error)
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    extent = float(np.linalg.norm(gt[-1] - gt[0]))
    step = float(np.mean(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    ate = float(absolute_trajectory_error(jnp.asarray(est),
                                          jnp.asarray(gt), align=True))
    rpe = float(relative_pose_error(jnp.asarray(est), jnp.asarray(gt)))
    return ate / extent, rpe / step


def frame_times(run, n_warm_runs=1):
    """Cold seconds of the first ``run()`` (compilation included), then
    per-frame seconds of a second, warm run.  ``run(times)`` appends one
    wall time per frame, each ending in ``block_until_ready``."""
    t0 = time.perf_counter()
    cold_out = run([])
    cold = time.perf_counter() - t0
    for _ in range(n_warm_runs):
        times = []
        out = run(times)
    return cold, np.asarray(times[1:]), cold_out, out


def timing_line(name, cold, times):
    return (f"{name}: cold {cold:.1f} s (compilation included); steady "
            f"median {1e3 * np.median(times):.2f} ms/frame, "
            f"p90 {1e3 * np.percentile(times, 90):.2f} ms/frame over "
            f"{len(times)} frames")


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


# --------------------------------------------------------------- phases

def _map_stats(state, frame):
    """(SUCCESS fraction, median |depth - GT| on SUCCESS / median depth)."""
    from tadataka_tpu.flags import Flag
    success = np.asarray(state.flag_map) == int(Flag.SUCCESS)
    gt = np.asarray(frame.depth_map)
    err = np.abs(np.asarray(state.depth_map) - gt)[success]
    return (float(success.mean()),
            float(np.median(err)) / float(np.median(gt)) if err.size
            else float("inf"))


def phase_semi_dense(cfg, seq):
    """SemiDenseVO.estimate with a ground-truth bootstrap pose."""
    import jax
    from tadataka_tpu.apps import SemiDenseVO
    from tadataka_tpu.apps.semi_dense_vo import _step_fn
    from tadataka_tpu.utils.observability import MetricsLogger

    seq = seq[:cfg.n_semi_dense]
    gt10 = seq[1].pose.inv() * seq[0].pose

    def run(times, metrics=None, stats=None):
        vo = SemiDenseVO(camera(cfg), params=semi_dense_params(),
                         default_depth=8.0, default_variance=1.0,
                         uncertainty_bias=0.01, depth_range=DEPTH_RANGE,
                         history_size=cfg.history,
                         initial_pose_fn=lambda a, b: gt10,
                         metrics=metrics)
        positions = []
        for f in seq:
            t0 = time.perf_counter()
            st = vo.estimate(f)
            jax.block_until_ready(st.depth_map)
            times.append(time.perf_counter() - t0)
            positions.append(st.pose_wc.t)
            if stats is not None and st.flag_map is not None:
                stats.append(_map_stats(st, f))
        return st, np.stack([np.asarray(p) for p in positions])

    metrics, stats = MetricsLogger(), []
    t0 = time.perf_counter()
    run([], metrics, stats)
    cold = time.perf_counter() - t0
    n_programs = _step_fn._cache_size()
    times = []
    st, est = run(times)
    times = np.asarray(times[1:])
    log(timing_line("phase 1 semi-dense app", cold, times))
    log(f"  step programs compiled: {n_programs}; recompiled in the warm "
        f"run: {_step_fn._cache_size() - n_programs}")
    paths = [r["plan_path"] for r in metrics.records]
    log("  planner path per frame: " + " ".join(paths))
    log("  SUCCESS fraction / median depth error per frame: " + " ".join(
        f"{a:.2f}/{e:.3f}" for a, e in stats))

    gt = np.stack([np.asarray(f.pose.t) for f in seq])
    ate, rpe = trajectory_errors(est, gt)
    boot_success, boot_err = stats[0]
    last_success, last_err = _map_stats(st, seq[-1])
    log(f"  bootstrap frame: success {boot_success:.3f}, depth error "
        f"{boot_err:.4f}; last frame: success {last_success:.3f}, depth "
        f"error {last_err:.4f} of the median depth; ATE {ate:.4f} of the "
        f"extent; RPE {rpe:.4f} of the mean step")
    check(np.isfinite(np.asarray(st.depth_map)).all(), "finite depth map")
    # The bootstrap frame is mapped with the ground-truth pose from a
    # random prior: the map must converge there (phase 2 gates the update
    # itself tighter, against its reference).
    check(boot_success > 0.15 and boot_err < 0.1, "bootstrap map: SUCCESS "
          "> 15%, median depth error < 10% of the scene depth")
    # Afterwards the app tracks against its own map, and that coupled
    # loop drifts on this scene (frame-to-frame tracking trades
    # translation for rotation; ROADMAP 2.1), so the later gates catch
    # breakage and divergence, not drift.
    late_success = float(np.mean([a for a, _ in stats[-10:]]))
    check(late_success > 0.02, "the map keeps SUCCESS pixels to the end "
          "(mean over the last 10 frames > 2%)")
    check(ate < 0.2, "semi-dense ATE < 20% of the trajectory extent")
    check(rpe < 1.5, "semi-dense RPE < 1.5 mean steps")
    check("scatter" not in paths, "no frame falls to the scattered path")


def _depth_agreement(name, key, ref, cfg, expect_path, seed):
    """update_depth_fast (planned) vs the scattered estimator on one
    key/ref pair: the agreement test of tests/vo/test_sweep.py."""
    import jax.numpy as jnp
    from tadataka_tpu.vo.semi_dense import make_frame, update_depth
    from tadataka_tpu.vo.semi_dense.fast import plan_update, update_depth_fast
    from tadataka_tpu.vo.semi_dense.frame import stack_frames

    cam, params = camera(cfg), semi_dense_params()
    kf = make_frame(cam, key.image, key.pose.T)
    refs = stack_frames([make_frame(cam, ref.image, ref.pose.T)])
    gt = np.asarray(key.depth_map)
    rng = np.random.default_rng(seed)
    prior = jnp.asarray(gt + rng.uniform(-1.5, 1.5, gt.shape)
                        .astype(np.float32))
    prior_var = jnp.full(gt.shape, 0.05, jnp.float32)
    age = jnp.ones(gt.shape, jnp.int32)
    plan = plan_update(kf, refs, params)
    check(plan.path == expect_path, f"{name}: planner picks {expect_path}")
    d_fast, _, f_fast = update_depth_fast(kf, refs, age, prior, prior_var,
                                          params, plan=plan)
    d_scat, _, f_scat = update_depth(kf, refs, age, prior, prior_var,
                                     params, n_ref_samples=64)
    d_fast, d_scat = np.asarray(d_fast), np.asarray(d_scat)
    both = (np.asarray(f_fast) == 0) & (np.asarray(f_scat) == 0)
    scale = float(np.median(gt))
    dd = float(np.median(np.abs(d_fast - d_scat)[both])) / scale
    e_fast = float(np.median(np.abs(d_fast - gt)[both])) / scale
    e_scat = float(np.median(np.abs(d_scat - gt)[both])) / scale
    log(f"  {name}: both SUCCESS {both.mean():.3f}; median |fast - "
        f"scatter| {dd:.4f}, |fast - GT| {e_fast:.4f}, |scatter - GT| "
        f"{e_scat:.4f} of the median depth")
    check(both.mean() > 0.25, f"{name}: SUCCESS on both > 0.25")
    # tests/vo/test_sweep.py's bounds (0.5 at depth 10 -> 5%): the same
    # algorithm under two sampling parametrizations
    check(dd < 0.05, f"{name}: fast and scatter agree within 5% depth")
    check(e_fast < 1.5 * e_scat + 1e-3,
          f"{name}: fast at least as accurate as scatter (x1.5)")


def phase_depth_update(cfg, seq):
    """Planned depth update vs the plain scattered estimator."""
    from tadataka_tpu.core.pose import Pose
    import jax.numpy as jnp
    from tadataka_tpu.dataset.synthetic import multi_plane_scene

    t0 = time.perf_counter()
    key, ref = TENT_PAIR
    _depth_agreement("tent (consecutive frames)", seq[key], seq[ref], cfg,
                     "tent", seed=9)
    # lateral stereo pair: ~40 px disparity at depth 8 exceeds the tent
    # budget cap, so the planner takes the rectified sweep
    stereo = multi_plane_scene(
        n_frames=2, image_shape=cfg.image_shape, focal_length=cfg.focal,
        poses=[Pose.identity(),
               Pose.from_rotvec(jnp.zeros(3), jnp.array([0.6, 0.0, 0.0]))])
    _depth_agreement("rect (lateral stereo pair)", stereo[0], stereo[1],
                     cfg, "rect", seed=10)
    log(f"phase 2 depth update vs reference: {time.perf_counter() - t0:.1f}"
        " s (compilation included)")


def phase_dvo(cfg, seq):
    """DvoTrajectory over the sequence; both resample arms on one pair."""
    import jax
    import jax.numpy as jnp
    from tadataka_tpu.apps import DvoTrajectory
    from tadataka_tpu.vo.dvo import estimate_pose_pyramid

    seq = seq[:cfg.n_dvo]

    def run(times):
        vo = DvoTrajectory(seq[0].camera_model, weights="huber")
        for f in seq:
            t0 = time.perf_counter()
            jax.block_until_ready(vo.estimate(f).t)
            times.append(time.perf_counter() - t0)
        return vo.positions()

    cold, times, _, est = frame_times(run)
    log(timing_line("phase 3 DVO app", cold, times))
    gt = np.stack([np.asarray(f.pose.t) for f in seq])
    ate, rpe = trajectory_errors(est, gt)
    log(f"  ATE {ate:.5f} of the extent; RPE {rpe:.5f} of the mean step")
    # metric DVO on exact depth: tests/vo/test_long_trajectory.py's 5%
    # bound on ATE; per-step error well under a tenth of a step
    check(ate < 0.05, "DVO ATE < 5% of the trajectory extent")
    check(rpe < 0.1, "DVO RPE < 10% of the mean step")

    f0, f1 = seq[0], seq[1]
    cm = f0.camera_model
    args = (cm, cm, f0.image, f0.depth_map, f1.image,
            jnp.ones_like(f0.image), jnp.eye(3), jnp.zeros(3), 5, 20, 1.5,
            "huber", "ic")
    (R_g, t_g), (R_t, t_t) = (estimate_pose_pyramid(*args, budget)
                              for budget in (0, 16))
    dR = float(np.linalg.norm(np.asarray(R_g) - np.asarray(R_t)))
    dt = float(np.linalg.norm(np.asarray(t_g) - np.asarray(t_t)))
    step = float(np.linalg.norm(np.asarray((f1.pose.inv() * f0.pose).t)))
    log(f"  resample arms (gather vs tent): |dR| {dR:.2e}, |dt| {dt:.2e} "
        f"({dt / step:.2e} of the step)")
    # both arms sample the same bilinear image inside the tent budget, so
    # they converge to the same optimum up to float32 reduction order
    check(dR < 1e-3 and dt < 1e-2 * step,
          "gather and tent resample poses agree (1e-3 rot, 1% of step)")


def phase_feature_vo(cfg, seq):
    """FeatureBasedVO (with windowed BA) and the TF32 matching check."""
    import jax
    import jax.numpy as jnp
    from tadataka_tpu.features.brief import extract_features
    from tadataka_tpu.features.matching import hamming_distances
    from tadataka_tpu.vo.feature_based import FeatureBasedVO

    seq = seq[:cfg.n_feature]

    def run(times):
        vo = FeatureBasedVO(fast_threshold=6.0 / 255.0, min_matches=16,
                            max_keypoints=1024)
        est, gt = [], []
        for f in seq:
            t0 = time.perf_counter()
            pose = vo.estimate(f)
            times.append(time.perf_counter() - t0)
            if pose is not None:
                est.append(np.asarray(pose.t))
                gt.append(np.asarray(f.pose.t))
        return est, gt

    cold, times, _, (est, gt) = frame_times(run)
    log(timing_line("phase 4 feature VO", cold, times))
    check(len(est) >= len(seq) - 2, f"feature VO localizes {len(est)} of "
          f"{len(seq)} frames")
    ate, _ = trajectory_errors(np.stack(est), np.stack(gt))
    log(f"  ATE {ate:.4f} of the extent")
    # monocular VO drifts in scale with no loop closure: this catches a
    # lost track, not drift (0.27 measured at this size on an H100, 0.22
    # in tests/vo/test_long_trajectory.py, which pins 0.3 on the CPU)
    check(ate < 0.4, "feature VO ATE < 40% of the trajectory extent")

    feats = [extract_features(f.image, max_keypoints=1024,
                              threshold=6.0 / 255.0) for f in seq[:2]]
    d1, d2 = feats[0].descriptors, feats[1].descriptors
    fast = np.asarray(hamming_distances(d1, d2))
    exact = np.asarray((d1.shape[1] - jnp.dot(
        d1, d2.T, precision=jax.lax.Precision.HIGHEST)) * 0.5)
    # +-1 codes and integer sums below 2^11 are exact in TF32 with f32
    # accumulation, so the DEFAULT-precision product must match bit-exactly
    check(np.array_equal(fast, exact),
          "Hamming distances at DEFAULT precision equal HIGHEST")
    check(np.array_equal(fast.argmin(1), exact.argmin(1)),
          "match indices equal a precision='highest' run")


# ------------------------------------------------------- four cards

def phase_four_cards(cfg):
    """Multi-card paths against their single-card runs."""
    import jax
    import jax.numpy as jnp
    from tadataka_tpu.apps import PipelinedSemiDenseVO, SemiDenseVO
    from tadataka_tpu.ba.residuals import transform_project
    from tadataka_tpu.ba.schur import lm_solve
    from tadataka_tpu.parallel import (
        distributed_lm_solve, make_mesh, make_sharded_update_sweep)
    from tadataka_tpu.vo.semi_dense import make_frame, regularize
    from tadataka_tpu.vo.semi_dense.fast import plan_update, update_depth_fast
    from tadataka_tpu.vo.semi_dense.frame import stack_frames

    devices = jax.devices()
    check(len(devices) == 4, "four devices")
    mesh = make_mesh(devices)
    seq = make_sequence(cfg, max(cfg.n_pipelined, TENT_PAIR[0] + 1))

    # column-sharded planned sweep (160 columns per card at 640 wide)
    cam, params = camera(cfg), semi_dense_params()
    key, ref = seq[TENT_PAIR[0]], seq[TENT_PAIR[1]]
    kf = make_frame(cam, key.image, key.pose.T)
    refs = stack_frames([make_frame(cam, ref.image, ref.pose.T)])
    gt = np.asarray(key.depth_map)
    rng = np.random.default_rng(4)
    prior = jnp.asarray(gt + rng.uniform(-0.5, 0.5, gt.shape)
                        .astype(np.float32))
    var = jnp.full(gt.shape, 0.05, jnp.float32)
    age = jnp.ones(gt.shape, jnp.int32)
    plan = plan_update(kf, refs, params)
    t0 = time.perf_counter()
    d1, v1, f1 = update_depth_fast(kf, refs, age, prior, var, params,
                                   plan=plan)
    d1 = regularize(d1, v1, f1)
    sharded = make_sharded_update_sweep(mesh, gt.shape, plan)
    d4, v4, f4 = sharded(kf, refs, age, prior, var, params)
    log(f"four cards: sharded sweep {time.perf_counter() - t0:.1f} s "
        "(compilation included)")
    f4, f1 = np.asarray(f4), np.asarray(f1)
    d4, d1 = np.asarray(d4), np.asarray(d1)
    f_eq = float(np.mean(f4 == f1))
    ok = (f4 == 0) & (f1 == 0)
    close = np.isclose(d4, d1, rtol=1e-4, atol=1e-3)[ok].mean()
    scale = float(np.median(gt))
    e4 = float(np.median(np.abs(d4 - gt)[ok])) / scale
    e1 = float(np.median(np.abs(d1 - gt)[ok])) / scale
    log(f"  flags equal on {f_eq:.6f} of pixels; depth equal (rtol 1e-4) "
        f"on {close:.4f} of SUCCESS pixels; median |depth - GT| sharded "
        f"{e4:.4f}, single {e1:.4f} of the median depth")
    # same per-pixel program on a column block, but XLA fuses the two
    # programs' float sums differently, and the SSD argmin over nearly
    # tied windows flips with summation order (jit and eager runs of the
    # same single-device program disagree on many pixels on the CPU too),
    # so the gate is equal flags and equal accuracy, not equal depths
    check(f_eq > 0.999, "sharded flags equal the single card's (99.9%)")
    check(e4 < 1.1 * e1 + 1e-3, "sharded depth as accurate as single "
          "(x1.1)")

    # landmark-sharded distributed BA vs the single-card solve
    n_views, n_points = 8, 10240
    points = rng.uniform(-2, 2, (n_points, 3)).astype(np.float32)
    points[:, 2] += 8.0
    poses = np.hstack([rng.uniform(-0.05, 0.05, (n_views, 3)),
                       rng.uniform(-0.5, 0.5, (n_views, 3))]) \
        .astype(np.float32)
    pi_ = np.repeat(np.arange(n_points), 3)
    vi = rng.integers(0, n_views, pi_.shape[0]).astype(np.int32)
    x_true = np.asarray(jax.vmap(transform_project)(
        jnp.asarray(poses)[vi], jnp.asarray(points)[pi_]), np.float32)
    poses_n = (poses + rng.normal(0, 0.01, poses.shape)).astype(np.float32)
    points_n = (points + rng.normal(0, 0.05, points.shape)) \
        .astype(np.float32)
    t0 = time.perf_counter()
    p4, x4, e4 = distributed_lm_solve(mesh, poses_n, points_n, vi, pi_,
                                      x_true, max_iter=15)
    p1, x1, e1 = lm_solve(jnp.asarray(poses_n), jnp.asarray(points_n),
                          jnp.asarray(vi), jnp.asarray(pi_),
                          jnp.asarray(x_true), max_iter=15)
    dp = float(np.abs(np.asarray(p4) - np.asarray(p1)).max())
    log(f"four cards: distributed BA {time.perf_counter() - t0:.1f} s; "
        f"error {float(e4):.3e} vs single {float(e1):.3e}; max |pose "
        f"diff| {dp:.2e}")
    # BA fixes no gauge, so converged solves may differ by a small
    # similarity; the comparison is the objective they reach
    # (tests/parallel/test_parallel.py does the same on the CPU mesh)
    check(float(e4) < 1e-8 and float(e1) < 1e-8,
          "distributed and single-card BA both converge (error < 1e-8)")

    # tracker/mapper pipeline on cards (0, 1) vs SemiDenseVO on card 0
    gt10 = seq[1].pose.inv() * seq[0].pose
    kw = dict(params=params, default_depth=8.0, default_variance=1.0,
              uncertainty_bias=0.01, depth_range=DEPTH_RANGE,
              history_size=cfg.history, initial_pose_fn=lambda a, b: gt10)
    t0 = time.perf_counter()
    seq = seq[:cfg.n_pipelined]
    pipe = PipelinedSemiDenseVO(cam, devices=(devices[0], devices[1]), **kw)
    for f in seq:
        pipe.estimate(f)
    st_p = pipe.flush_map()
    with jax.default_device(devices[0]):
        single = SemiDenseVO(cam, **kw)
        for f in seq:
            st_s = single.estimate(f)
    log(f"four cards: pipelined app {time.perf_counter() - t0:.1f} s "
        f"({len(seq)} frames, compilation included)")
    (p_success, p_err), (s_success, s_err) = (
        _map_stats(st, seq[-1]) for st in (st_p, st_s))
    log(f"  final map: pipelined success {p_success:.3f}, depth error "
        f"{p_err:.4f}; single success {s_success:.3f}, depth error "
        f"{s_err:.4f} of the median depth")
    # the pipeline tracks against a map one frame staler than the single
    # app (its flush_map contract), so the two maps are not equal; both
    # must stay in the accuracy class of phase 1's bootstrap map
    check(p_success > 0.1 and p_err < 0.1,
          "pipelined map: SUCCESS > 10%, depth error < 10%")
    check(p_err < 2.0 * s_err + 0.01,
          "pipelined map within 2x of the single-card map")


# ------------------------------------------------------------------ main

def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the multi-card paths, on 4 cards")
    args = parser.parse_args(argv)

    import jax
    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {device.platform}); refusing "
              "to run", file=sys.stderr)
        return 2

    import tadataka_tpu  # noqa: F401  (sets the matmul precision)
    from tadataka_tpu.utils.compile_cache import enable_compilation_cache
    cache = enable_compilation_cache()
    precision = jax.config.jax_default_matmul_precision
    if precision != "highest":
        raise AssertionError(f"matmul precision is {precision!r}")

    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; device {device.device_kind}; "
        f"{len(jax.devices())} device(s); compile cache {cache}")
    cfg = TUM_FR1
    if args.four_cards:
        phase_four_cards(cfg)
    else:
        seq = make_sequence(cfg, max(cfg.n_semi_dense, cfg.n_dvo,
                                     cfg.n_feature))
        phase_semi_dense(cfg, seq)
        phase_depth_update(cfg, seq)
        phase_dvo(cfg, seq)
        phase_feature_vo(cfg, seq)
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
