"""Plane-sweep semi-dense estimator tests.

Validates the sweep fast path against exact synthetic ground truth and
against the scattered-gather estimator it replaces on the hot path.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tadataka_tpu.flags import Flag
from tadataka_tpu.core.pose import Pose
from tadataka_tpu.camera import CameraParameters
from tadataka_tpu.dataset import PlaneSceneDataset
from tadataka_tpu.vo.semi_dense import (
    SemiDenseParams, make_frame, update_depth)
from tadataka_tpu.vo.semi_dense.frame import stack_frames
from tadataka_tpu.vo.semi_dense.sweep import (
    update_depth_sweep, warp_plane_stack, plane_homography,
    ssd_search, _INF)

H, W = 64, 128
FOCAL = (60.0, 60.0)

PARAMS = SemiDenseParams.create(
    min_depth=2.0, max_depth=50.0, geo_coeff=0.01, photo_coeff=0.01,
    ref_step_size=0.002, min_gradient=0.01)


@pytest.fixture(scope="module")
def stereo():
    poses = [Pose.identity(),
             Pose.from_rotvec(jnp.zeros(3), jnp.array([0.5, 0.0, 0.0]))]
    dataset = PlaneSceneDataset(n_frames=2, image_shape=(H, W),
                                focal_length=FOCAL, poses=poses,
                                plane_origin=(0.0, 0.0, 10.0),
                                plane_normal=(0.05, -0.02, -1.0))
    key, ref = dataset[0], dataset[1]
    cam = CameraParameters.create(FOCAL, (W / 2, H / 2))
    keyframe = make_frame(cam, key.image, key.pose.T)
    refframe = make_frame(cam, ref.image, ref.pose.T)
    return key, ref, keyframe, refframe


def run_sweep(stereo, prior_depth, prior_variance, age=None):
    key, ref, keyframe, refframe = stereo
    refs = stack_frames([refframe])
    if age is None:
        age = np.ones((H, W), dtype=np.int32)
    return update_depth_sweep(
        keyframe, refs, jnp.asarray(age), jnp.asarray(prior_depth),
        jnp.asarray(prior_variance), PARAMS, n_planes=64)


def test_plane_homography_matches_warp_point(stereo):
    """H_q applied to a pixel == the per-pixel warp at depth 1/q."""
    from tadataka_tpu.vo.semi_dense.estimator import _warp_point
    key, ref, keyframe, refframe = stereo
    from tadataka_tpu.core.transforms import inv_motion_matrix
    T_rk = inv_motion_matrix(refframe.transform_wf) @ keyframe.transform_wf
    q = jnp.float32(0.11)
    H33 = plane_homography(T_rk, q, keyframe.focal_length, keyframe.offset,
                           refframe.focal_length, refframe.offset)
    u = jnp.array([37.0, 21.0])
    x_key = (u - keyframe.offset) / keyframe.focal_length
    x_ref, _ = _warp_point(T_rk, x_key, 1.0 / q)
    u_ref = x_ref * refframe.focal_length + refframe.offset
    p = H33 @ jnp.array([u[0], u[1], 1.0])
    np.testing.assert_allclose(np.asarray(p[:2] / p[2]), np.asarray(u_ref),
                               rtol=1e-4, atol=1e-3)


def test_warp_plane_stack_values(stereo):
    """Warped stack ~ ref image sampled at the per-pixel plane position."""
    from tadataka_tpu.core.transforms import inv_motion_matrix
    from tadataka_tpu.core.interpolation import interpolate
    key, ref, keyframe, refframe = stereo
    T_rk = inv_motion_matrix(refframe.transform_wf) @ keyframe.transform_wf
    qs = jnp.array([0.05, 0.1, 0.2], jnp.float32)
    V = warp_plane_stack(refframe.image, T_rk, qs,
                         keyframe.focal_length, keyframe.offset,
                         refframe.focal_length, refframe.offset)
    assert V.shape == (3, H, W)

    xo = jnp.broadcast_to(jnp.arange(W, dtype=jnp.float32), (H, W))
    yo = jnp.broadcast_to(jnp.arange(H, dtype=jnp.float32)[:, None], (H, W))
    for s, q in enumerate(np.asarray(qs)):
        H33 = plane_homography(T_rk, q, keyframe.focal_length,
                               keyframe.offset, refframe.focal_length,
                               refframe.offset)
        D = H33[2, 0] * xo + H33[2, 1] * yo + H33[2, 2]
        U = (H33[0, 0] * xo + H33[0, 1] * yo + H33[0, 2]) / D
        Vv = (H33[1, 0] * xo + H33[1, 1] * yo + H33[1, 2]) / D
        direct = interpolate(refframe.image, jnp.stack([U, Vv], -1))
        valid = np.asarray(V[s]) >= 0.0
        assert valid.mean() > 0.5
        err = np.abs(np.asarray(V[s]) - np.asarray(direct))[valid]
        assert np.median(err) < 5e-3


def test_ssd_search_xla_finds_planted_match():
    rng = np.random.default_rng(11)
    S, Hh, Ww = 16, 8, 128
    V = jnp.asarray(rng.random((S, Hh, Ww)), jnp.float32)
    # plant the key patch at window index 6 for every pixel
    K = V[6:11]
    mlo = jnp.zeros((Hh, Ww), jnp.float32)
    mhi = jnp.full((Hh, Ww), float(S - 5), jnp.float32)
    bm, ec, ep, en = ssd_search(V, K, mlo, mhi)
    assert np.all(np.asarray(bm) == 6)
    assert np.allclose(np.asarray(ec), 0.0, atol=1e-5)
    # neighbors exist and are worse
    assert np.all(np.asarray(ep) > np.asarray(ec))
    assert np.all(np.asarray(en) > np.asarray(ec))


def test_ssd_search_respects_window_mask():
    rng = np.random.default_rng(12)
    S, Hh, Ww = 16, 8, 128
    V = jnp.asarray(rng.random((S, Hh, Ww)), jnp.float32)
    K = V[6:11]
    # exclude the true window: only windows 0..3 allowed
    mlo = jnp.zeros((Hh, Ww), jnp.float32)
    mhi = jnp.full((Hh, Ww), 3.0, jnp.float32)
    bm, ec, ep, en = ssd_search(V, K, mlo, mhi)
    assert np.all(np.asarray(bm) <= 3)
    # empty mask -> no match
    bm2, ec2, _, _ = ssd_search(V, K, jnp.full((Hh, Ww), 10.0),
                                 jnp.full((Hh, Ww), 3.0))
    assert np.all(np.asarray(bm2) == -1)
    assert np.all(np.asarray(ec2) >= float(_INF))


def test_ssd_search_invalid_samples_masked():
    rng = np.random.default_rng(13)
    S, Hh, Ww = 16, 8, 128
    V = np.asarray(rng.random((S, Hh, Ww)), np.float32)
    K = jnp.asarray(V[6:11].copy())
    # poison the true window's samples for half the pixels
    V[6:11, :, :64] = -1.0
    bm, ec, ep, en = ssd_search(jnp.asarray(V), K,
                                jnp.zeros((Hh, Ww), jnp.float32),
                                jnp.full((Hh, Ww), float(S - 5),
                                         jnp.float32))
    bm = np.asarray(bm)
    assert np.all(bm[:, 64:] == 6)
    assert np.all(bm[:, :64] != 6)


def test_sweep_improves_depth(stereo):
    key = stereo[0]
    gt = np.asarray(key.depth_map)
    rng = np.random.default_rng(7)
    prior = gt + rng.uniform(-2.0, 2.0, gt.shape).astype(np.float32)
    prior_var = 0.05 * np.ones_like(prior)

    depth, variance, flags = run_sweep(stereo, prior, prior_var)
    flags = np.asarray(flags)
    depth = np.asarray(depth)

    success = flags == int(Flag.SUCCESS)
    assert success.mean() > 0.3, f"too few SUCCESS: {success.mean()}"

    err_prior = np.abs(prior - gt)[success]
    err_new = np.abs(depth - gt)[success]
    assert np.median(err_new) < np.median(err_prior)
    assert np.median(err_new) < 0.5
    v = np.asarray(variance)[success]
    assert np.all(v > 0) and np.all(np.isfinite(v))


def test_sweep_matches_scatter_estimator(stereo):
    """Sweep and scattered estimators agree on SUCCESS pixels."""
    key, ref, keyframe, refframe = stereo
    gt = np.asarray(key.depth_map)
    rng = np.random.default_rng(9)
    prior = gt + rng.uniform(-1.5, 1.5, gt.shape).astype(np.float32)
    prior_var = 0.05 * np.ones_like(prior)
    refs = stack_frames([refframe])
    age = jnp.ones((H, W), dtype=jnp.int32)

    d_sweep, v_sweep, f_sweep = update_depth_sweep(
        keyframe, refs, age, jnp.asarray(prior), jnp.asarray(prior_var),
        PARAMS, n_planes=64)
    d_scat, v_scat, f_scat = update_depth(
        keyframe, refs, age, jnp.asarray(prior), jnp.asarray(prior_var),
        PARAMS, n_ref_samples=64)

    both = (np.asarray(f_sweep) == 0) & (np.asarray(f_scat) == 0)
    assert both.mean() > 0.25
    # same algorithm, different sampling parametrization: estimates agree
    dd = np.abs(np.asarray(d_sweep) - np.asarray(d_scat))[both]
    assert np.median(dd) < 0.5

    # and the sweep should be at least as accurate vs ground truth
    e_sweep = np.median(np.abs(np.asarray(d_sweep) - gt)[both])
    e_scat = np.median(np.abs(np.asarray(d_scat) - gt)[both])
    assert e_sweep < e_scat * 1.5


def test_sweep_not_processed_and_prior_flags(stereo):
    gt = np.asarray(stereo[0].depth_map)
    prior = gt.copy()
    prior[20, 20] = -5.0
    prior_var = 0.05 * np.ones_like(prior)
    age = np.ones((H, W), dtype=np.int32)
    age[10, 10] = 0
    depth, variance, flags = run_sweep(stereo, prior, prior_var, age)
    flags = np.asarray(flags)
    assert flags[10, 10] == int(Flag.NOT_PROCESSED)
    assert flags[20, 20] == int(Flag.NEGATIVE_PRIOR_DEPTH)
    np.testing.assert_allclose(np.asarray(depth)[10, 10], prior[10, 10],
                               rtol=1e-4)


def test_sweep_subpixel_beats_plane_quantization(stereo):
    """With few planes, parabolic refinement must beat the plane spacing."""
    key = stereo[0]
    gt = np.asarray(key.depth_map)
    prior = gt + 1.0
    prior_var = 0.05 * np.ones_like(gt)

    depth, _, flags = run_sweep(stereo, prior.astype(np.float32), prior_var)
    success = np.asarray(flags) == 0
    err = np.abs(np.asarray(depth) - gt)[success]
    # plane spacing in depth units at gt~10: d^2 * dq = 100 * (0.5-0.02)/63
    # ~ 0.76; nearest-plane-only matching would floor the median near half
    # that; subpixel refinement must do clearly better
    assert np.median(err) < 0.2
