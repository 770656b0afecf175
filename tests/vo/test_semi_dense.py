"""Semi-dense estimator tests.

Mirrors the reference strategy (tests/vo/semi_dense/test_semi_dense.py):
drive the kernel through failure flags and a SUCCESS case with a depth
accuracy bound — against exact synthetic ground truth.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tadataka_tpu.flags import Flag
from tadataka_tpu.core.pose import Pose
from tadataka_tpu.camera import CameraParameters
from tadataka_tpu.dataset import PlaneSceneDataset
from tadataka_tpu.vo.semi_dense import (
    SemiDenseParams, make_frame, update_depth, propagate, increment_age,
    fusion, regularize)
from tadataka_tpu.vo.semi_dense.frame import stack_frames


H, W = 60, 80
FOCAL = (60.0, 60.0)


@pytest.fixture(scope="module")
def stereo():
    poses = [Pose.identity(),
             Pose.from_rotvec(jnp.zeros(3), jnp.array([0.5, 0.0, 0.0]))]
    dataset = PlaneSceneDataset(n_frames=2, image_shape=(H, W),
                                focal_length=FOCAL, poses=poses,
                                plane_origin=(0.0, 0.0, 10.0),
                                plane_normal=(0.05, -0.02, -1.0))
    key, ref = dataset[0], dataset[1]
    keyframe = make_frame(
        CameraParameters.create(FOCAL, (W / 2, H / 2)), key.image, key.pose.T)
    refframe = make_frame(
        CameraParameters.create(FOCAL, (W / 2, H / 2)), ref.image, ref.pose.T)
    return key, ref, keyframe, refframe


PARAMS = SemiDenseParams.create(
    min_depth=2.0, max_depth=50.0, geo_coeff=0.01, photo_coeff=0.01,
    ref_step_size=0.002, min_gradient=0.01)


def run_update(stereo, prior_depth, prior_variance, age=None):
    key, ref, keyframe, refframe = stereo
    refs = stack_frames([refframe])
    if age is None:
        age = np.ones((H, W), dtype=np.int32)
    return update_depth(keyframe, refs, jnp.asarray(age),
                        jnp.asarray(prior_depth), jnp.asarray(prior_variance),
                        PARAMS, n_ref_samples=64)


def test_success_improves_depth(stereo):
    key = stereo[0]
    gt = np.asarray(key.depth_map)
    rng = np.random.default_rng(7)
    prior = gt + rng.uniform(-2.0, 2.0, gt.shape).astype(np.float32)
    prior_var = 0.05 * np.ones_like(prior)  # inv-depth sigma ~0.22... clamped

    depth, variance, flags = run_update(stereo, prior, prior_var)
    flags = np.asarray(flags)
    depth = np.asarray(depth)

    success = flags == int(Flag.SUCCESS)
    assert success.mean() > 0.3, f"too few SUCCESS: {success.mean()}"

    err_prior = np.abs(prior - gt)[success]
    err_new = np.abs(depth - gt)[success]
    assert np.median(err_new) < np.median(err_prior)
    assert np.median(err_new) < 0.5
    # variance must be finite and positive on success
    v = np.asarray(variance)[success]
    assert np.all(v > 0) and np.all(np.isfinite(v))


def test_not_processed(stereo):
    gt = np.asarray(stereo[0].depth_map)
    prior = gt.copy()
    age = np.ones((H, W), dtype=np.int32)
    age[10, 10] = 0
    depth, variance, flags = run_update(stereo, prior,
                                        0.05 * np.ones_like(prior), age)
    assert np.asarray(flags)[10, 10] == int(Flag.NOT_PROCESSED)
    np.testing.assert_allclose(np.asarray(depth)[10, 10], prior[10, 10],
                               rtol=1e-4)


def test_negative_prior_depth(stereo):
    gt = np.asarray(stereo[0].depth_map)
    prior = gt.copy()
    prior[20, 20] = -5.0
    depth, variance, flags = run_update(stereo, prior,
                                        0.05 * np.ones_like(prior))
    assert np.asarray(flags)[20, 20] == int(Flag.NEGATIVE_PRIOR_DEPTH)


def test_hypothesis_out_of_search_range(stereo):
    gt = np.asarray(stereo[0].depth_map)
    prior = gt.copy()
    prior_var = 0.05 * np.ones_like(prior)
    prior[20, 20] = 10000.0   # inv depth 1e-4 << min valid inv depth 0.02
    prior_var[20, 20] = 1e-5
    depth, variance, flags = run_update(stereo, prior, prior_var)
    assert np.asarray(flags)[20, 20] == int(
        Flag.HYPOTHESIS_OUT_OF_SEARCH_RANGE)


def test_insufficient_gradient(stereo):
    key, ref, keyframe, refframe = stereo
    flat = keyframe._replace(image=jnp.full((H, W), 0.5))
    refs = stack_frames([refframe])
    gt = np.asarray(key.depth_map)
    depth, variance, flags = update_depth(
        flat, refs, jnp.ones((H, W), dtype=jnp.int32),
        jnp.asarray(gt), 0.05 * jnp.ones((H, W)), PARAMS, n_ref_samples=64)
    flags = np.asarray(flags)
    center = flags[10:-10, 10:-10]
    assert (center == int(Flag.INSUFFICIENT_GRADIENT)).mean() > 0.9


def test_flag_map_covers_borders(stereo):
    gt = np.asarray(stereo[0].depth_map)
    depth, variance, flags = run_update(stereo, gt, 0.05 * np.ones_like(gt))
    flags = np.asarray(flags)
    # all flags are from the known enum
    valid_values = {int(f) for f in Flag}
    assert set(np.unique(flags)).issubset(valid_values)


def test_fusion_math():
    mu, var = fusion(jnp.asarray(0.5), jnp.asarray(0.7),
                     jnp.asarray(0.2), jnp.asarray(0.1))
    np.testing.assert_allclose(mu, (0.5 * 0.1 + 0.7 * 0.2) / 0.3, rtol=1e-6)
    np.testing.assert_allclose(var, 0.2 * 0.1 / 0.3, rtol=1e-6)


def test_increment_age(stereo):
    key, ref, keyframe, refframe = stereo
    cam = CameraParameters.create(FOCAL, (W / 2, H / 2))
    T10 = (ref.pose.inv() * key.pose).T
    age0 = jnp.zeros((H, W), dtype=jnp.int32)
    age1 = increment_age(age0, cam, cam, T10, key.depth_map)
    age1 = np.asarray(age1)
    assert age1.max() == 1
    assert age1.sum() > 0.5 * H * W  # most pixels visible in next frame
    # second round increments again
    age2 = np.asarray(increment_age(jnp.asarray(age1), cam, cam, T10,
                                    key.depth_map))
    assert age2.max() == 2


def test_propagate_identity(stereo):
    key = stereo[0]
    cam = CameraParameters.create(FOCAL, (W / 2, H / 2))
    gt = jnp.asarray(np.asarray(key.depth_map))
    var0 = 0.1 * jnp.ones((H, W))
    T_identity = jnp.eye(4)
    depth1, var1 = propagate(T_identity, cam, cam, gt, var0,
                             default_depth=10.0, default_variance=1.0,
                             uncertainty_bias=0.01)
    # identity warp: depth map essentially preserved
    np.testing.assert_allclose(np.asarray(depth1), np.asarray(gt), rtol=2e-2)
    # variance inflated by the bias
    assert np.all(np.asarray(var1) >= 0.1)


def test_propagate_translation(stereo):
    key, ref, keyframe, refframe = stereo
    cam = CameraParameters.create(FOCAL, (W / 2, H / 2))
    T10 = (ref.pose.inv() * key.pose).T
    depth1, var1 = propagate(T10, cam, cam, key.depth_map,
                             0.1 * jnp.ones((H, W)),
                             default_depth=10.0, default_variance=1.0,
                             uncertainty_bias=0.01)
    # propagated depth should approximate the ref frame's GT where covered
    gt1 = np.asarray(ref.depth_map)
    d1 = np.asarray(depth1)
    covered = np.abs(d1 - 10.0) > 1e-6  # not default
    err = np.abs(d1 - gt1)[covered]
    assert np.median(err) < 0.2


def test_regularize_smooths():
    rng = np.random.default_rng(3)
    depth = 10.0 + rng.normal(0, 0.5, (H, W)).astype(np.float32)
    variance = 0.1 * np.ones((H, W), dtype=np.float32)
    flags = np.full((H, W), int(Flag.SUCCESS), dtype=np.int32)
    sm = np.asarray(regularize(jnp.asarray(depth), jnp.asarray(variance),
                               jnp.asarray(flags)))
    assert sm.std() < depth.std()
    # non-success pixels keep their value
    flags[5, 5] = int(Flag.NOT_PROCESSED)
    flags2 = np.full((H, W), int(Flag.NOT_PROCESSED), dtype=np.int32)
    sm2 = np.asarray(regularize(jnp.asarray(depth), jnp.asarray(variance),
                                jnp.asarray(flags2)))
    np.testing.assert_allclose(sm2, depth, rtol=1e-5)


def test_propagate_collisions_fuse_or_keep_nearer():
    """Two hypotheses landing in one cell: statistically-compatible ones
    fuse as a precision-weighted Gaussian product; an incompatible farther
    surface loses to the nearer one (propagation.rs:21-81 semantics,
    order-independent two-pass scatter here).

    Geometry: identity motion with cam1 focal = cam0 focal / 3 maps source
    pixels x=0..3 to cells [0, 0, 1, 1] deterministically.
    """
    cam0 = CameraParameters.create((3.0, 3.0), (0.0, 0.0))
    cam1 = CameraParameters.create((1.0, 1.0), (0.0, 0.0))
    depth0 = jnp.asarray([[10.0, 10.5, 5.0, 50.0]], dtype=jnp.float32)
    var0 = jnp.full((1, 4), 1e-4, dtype=jnp.float32)

    depth1, var1 = propagate(jnp.eye(4), cam0, cam1, depth0, var0,
                             default_depth=7.0, default_variance=0.5,
                             uncertainty_bias=0.0)
    depth1 = np.asarray(depth1)
    var1 = np.asarray(var1)

    # cell 0: 10 and 10.5 are 2-sigma compatible in inverse depth
    # ((1/10 - 1/10.5)^2 = 2.3e-5 <= 4 * 1e-4) -> equal-precision fusion
    fused_inv = 0.5 * (1.0 / 10.0 + 1.0 / 10.5)
    np.testing.assert_allclose(depth1[0, 0], 1.0 / fused_inv, rtol=1e-5)
    np.testing.assert_allclose(var1[0, 0], 5e-5, rtol=1e-5)

    # cell 1: 5 vs 50 are incompatible -> the nearer surface (5) wins and
    # the far hypothesis is discarded entirely
    np.testing.assert_allclose(depth1[0, 1], 5.0, rtol=1e-5)
    np.testing.assert_allclose(var1[0, 1], 1e-4, rtol=1e-5)

    # untouched cells fall back to the defaults
    np.testing.assert_allclose(depth1[0, 2:], 7.0)
    np.testing.assert_allclose(var1[0, 2:], 0.5)


def test_propagate_tent_matches_scatter(stereo):
    """Tap-scatter propagation == scatter propagation + increment_age
    wherever the displacement fits the planned bounds."""
    from tadataka_tpu.vo.semi_dense import propagate_tent
    from tadataka_tpu.vo.semi_dense.fast import plan_flow_bounds

    key, ref, keyframe, refframe = stereo
    cam = CameraParameters.create(FOCAL, (W / 2, H / 2))
    T10 = np.asarray((ref.pose.inv() * key.pose).T, np.float64)
    depth0 = jnp.asarray(np.asarray(key.depth_map))
    var0 = 0.1 * jnp.ones((H, W))
    age0 = jnp.ones((H, W), dtype=jnp.int32)

    q0, q1 = 1.0 / 50.0, 1.0 / 2.0
    bounds = plan_flow_bounds(T10, np.asarray(FOCAL), (W / 2, H / 2),
                              (H, W), q0, q1, taps_max=256)
    assert bounds is not None

    d_ref, v_ref = propagate(jnp.asarray(T10, jnp.float32), cam, cam,
                             depth0, var0, default_depth=10.0,
                             default_variance=1.0, uncertainty_bias=0.01)
    a_ref = increment_age(age0, cam, cam, jnp.asarray(T10, jnp.float32),
                          depth0)

    d_t, v_t, a_t = propagate_tent(
        jnp.asarray(T10, jnp.float32), cam, cam, depth0, var0, age0,
        10.0, 1.0, 0.01, bounds)

    np.testing.assert_allclose(np.asarray(d_t), np.asarray(d_ref),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(v_t), np.asarray(v_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(a_t), np.asarray(a_ref))


def test_propagate_tent_collisions():
    """The tap-scatter path resolves collisions identically to the
    scatter path (fuse-compatible / nearest-wins)."""
    from tadataka_tpu.vo.semi_dense import propagate_tent

    cam0 = CameraParameters.create((3.0, 3.0), (0.0, 0.0))
    cam1 = CameraParameters.create((1.0, 1.0), (0.0, 0.0))
    depth0 = jnp.asarray([[10.0, 10.5, 5.0, 50.0]], dtype=jnp.float32)
    var0 = jnp.full((1, 4), 1e-4, dtype=jnp.float32)
    age0 = jnp.asarray([[3, 1, 2, 5]], dtype=jnp.int32)

    d_ref, v_ref = propagate(jnp.eye(4), cam0, cam1, depth0, var0,
                             default_depth=7.0, default_variance=0.5,
                             uncertainty_bias=0.0)
    d_t, v_t, a_t = propagate_tent(jnp.eye(4), cam0, cam1, depth0, var0,
                                   age0, 7.0, 0.5, 0.0, (-4, 0, 0, 0))
    np.testing.assert_allclose(np.asarray(d_t), np.asarray(d_ref),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(v_t), np.asarray(v_ref),
                               rtol=1e-5)
    # age: max over arrivals per cell ([0,1]->cell0, [2,3]->cell1)
    np.testing.assert_array_equal(np.asarray(a_t)[0, :2],
                                  np.array([4, 6]))
