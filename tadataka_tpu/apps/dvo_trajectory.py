"""DVO trajectory estimation over an RGB-D sequence.

Parity surface: /root/reference/examples/dvo_pose_change.py:40-90 — chain
frame-to-frame DVO pose changes into a world trajectory.
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from tadataka_tpu.core.pose import Pose
from tadataka_tpu.dataset.image_io import rgb2gray
from tadataka_tpu.vo.dvo import (PoseChangeEstimator, estimate_pose_pyramid,
                                 normalized_grids)


@partial(jax.jit, static_argnames=("cfg",))
def _dvo_chain_step(cm, I0, D0, I1, R_wc, t_wc, grids, *, cfg):
    """One frame's DVO + world-pose composition as ONE device program —
    eager per-frame Pose algebra (inv, mul) was 3-4 extra dispatches per
    frame."""
    n_levels, max_iter, ratio, weight_kind, sample_budget = cfg
    wmap = jnp.ones_like(I0)
    R10, t10 = estimate_pose_pyramid(
        cm, cm, I0, D0, I1, wmap,
        jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, dtype=jnp.float32),
        n_levels, max_iter, ratio, weight_kind, "ic", sample_budget,
        grids)
    # pose_wc <- pose_wc * pose10^-1
    R_new = R_wc @ R10.T
    t_new = t_wc - R_new @ t10
    return R_new, t_new


class DvoTrajectory:
    def __init__(self, camera_model, weights="huber",
                 n_coarse_to_fine=5, max_iter=20):
        self.camera_model = camera_model
        self.weights = weights
        self.estimator = PoseChangeEstimator(
            camera_model, camera_model,
            n_coarse_to_fine=n_coarse_to_fine, max_iter=max_iter)
        self.pose_wc = Pose.identity()
        self.trajectory = [self.pose_wc]
        self._prev = None
        # gray conversion + the two uploads are blocking host work per
        # frame; prefetch on a worker
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._futures = {}

    def _prepare(self, frame):
        image = jnp.asarray(rgb2gray(np.asarray(frame.image)),
                            dtype=jnp.float32)
        depth = jnp.asarray(np.asarray(frame.depth_map),
                            dtype=jnp.float32)
        return image, depth

    def prefetch(self, frame):
        """Start frame's conversion + upload on the worker thread."""
        self._futures[id(frame)] = self._pool.submit(self._prepare, frame)

    def estimate(self, frame):
        """frame: Frame with .image and .depth_map.  Returns pose_wc."""
        fut = self._futures.pop(id(frame), None)
        image, depth = fut.result() if fut is not None \
            else self._prepare(frame)
        if self._prev is not None:
            prev_image, prev_depth = self._prev
            e = self.estimator
            shape = tuple(image.shape)
            grids = e._grids.get(shape)
            if grids is None:
                grids = normalized_grids(e.camera_model0,
                                         e.n_coarse_to_fine,
                                         e.layer_size_ratio, shape)
                e._grids[shape] = grids
            R_wc = jnp.asarray(self.pose_wc.R, jnp.float32)
            t_wc = jnp.asarray(self.pose_wc.t, jnp.float32)
            R_new, t_new = _dvo_chain_step(
                e.camera_model0, prev_image, prev_depth, image,
                R_wc, t_wc, grids,
                cfg=(e.n_coarse_to_fine, e.max_iter, e.layer_size_ratio,
                     self.weights if isinstance(self.weights, str)
                     else "none", e.sample_budget))
            self.pose_wc = Pose(R_new, t_new)
            self.trajectory.append(self.pose_wc)
        self._prev = (image, depth)
        return self.pose_wc

    def positions(self):
        return np.stack([np.asarray(p.t) for p in self.trajectory])
