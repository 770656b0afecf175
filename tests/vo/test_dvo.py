"""DVO acceptance tests on a synthetic scene.

Mirrors the reference test strategy (tests/vo/test_dvo.py): the estimated
pose must beat the identity photometrically and be close to GT — here
against exact synthetic ground truth rather than a real fixture.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tadataka_tpu.core.pose import Pose
from tadataka_tpu.dataset import PlaneSceneDataset
from tadataka_tpu.metrics import PhotometricError
from tadataka_tpu.vo.dvo import PoseChangeEstimator


@pytest.fixture(scope="module")
def scene():
    dataset = PlaneSceneDataset(n_frames=2, image_shape=(60, 80),
                                focal_length=(60.0, 60.0))
    frame0, frame1 = dataset[0], dataset[1]
    # ground-truth pose change: camera-0 coords -> camera-1 coords
    pose10_gt = frame1.pose.inv() * frame0.pose
    return dataset, frame0, frame1, pose10_gt


@pytest.mark.parametrize("weights", [None, "tukey", "student-t", "huber"])
@pytest.mark.parametrize("method", ["ic", "fc"])
def test_dvo_beats_identity_and_approaches_gt(scene, weights, method):
    dataset, frame0, frame1, pose10_gt = scene
    estimator = PoseChangeEstimator(frame0.camera_model, frame1.camera_model,
                                    n_coarse_to_fine=4, max_iter=20,
                                    method=method)
    pose10 = estimator(frame0.image, frame0.depth_map, frame1.image,
                       weights=weights)

    error = PhotometricError(frame0.camera_model, frame1.camera_model,
                             frame0.image, frame0.depth_map, frame1.image)
    e_identity = float(error(Pose.identity()))
    e_estimate = float(error(pose10))
    e_gt = float(error(pose10_gt))

    assert e_estimate < e_identity
    # within 3x of the GT pose's photometric error (reference bound style)
    assert e_estimate < max(3.0 * e_gt, 1e-5)


def test_dvo_weight_map(scene):
    dataset, frame0, frame1, pose10_gt = scene
    estimator = PoseChangeEstimator(frame0.camera_model, frame1.camera_model,
                                    n_coarse_to_fine=4, max_iter=20)
    W = jnp.ones_like(frame0.image)
    pose10 = estimator(frame0.image, frame0.depth_map, frame1.image,
                       weights=W)
    t_err = float(jnp.linalg.norm(pose10.t - pose10_gt.t))
    t_norm = float(jnp.linalg.norm(pose10_gt.t))
    assert t_err < 0.35 * max(t_norm, 0.1)


def test_dvo_translation_accuracy(scene):
    dataset, frame0, frame1, pose10_gt = scene
    estimator = PoseChangeEstimator(frame0.camera_model, frame1.camera_model,
                                    n_coarse_to_fine=4, max_iter=20)
    pose10 = estimator(frame0.image, frame0.depth_map, frame1.image)
    t_err = float(jnp.linalg.norm(pose10.t - pose10_gt.t))
    r_err = float(jnp.linalg.norm(pose10.rotvec - pose10_gt.rotvec))
    assert t_err < 0.1, (np.asarray(pose10.t), np.asarray(pose10_gt.t))
    assert r_err < 0.05


@pytest.mark.parametrize("method", ["ic", "fc"])
def test_dvo_tent_sampler_matches_gather(scene, method):
    """The gather-free tent resample path (sample_budget > 0) meets the
    same acceptance bounds as the exact gather
    path and lands on nearly the same pose."""
    dataset, frame0, frame1, pose10_gt = scene
    kw = dict(n_coarse_to_fine=4, max_iter=20, method=method)
    est_gather = PoseChangeEstimator(frame0.camera_model,
                                     frame1.camera_model,
                                     sample_budget=0, **kw)
    est_tent = PoseChangeEstimator(frame0.camera_model, frame1.camera_model,
                                   sample_budget=12, **kw)
    p_gather = est_gather(frame0.image, frame0.depth_map, frame1.image)
    p_tent = est_tent(frame0.image, frame0.depth_map, frame1.image)

    error = PhotometricError(frame0.camera_model, frame1.camera_model,
                             frame0.image, frame0.depth_map, frame1.image)
    e_identity = float(error(Pose.identity()))
    e_gt = float(error(pose10_gt))
    e_tent = float(error(p_tent))
    assert e_tent < e_identity
    assert e_tent < max(3.0 * e_gt, 1e-5)
    t_diff = float(jnp.linalg.norm(p_tent.t - p_gather.t))
    assert t_diff < 0.05, (np.asarray(p_tent.t), np.asarray(p_gather.t))
