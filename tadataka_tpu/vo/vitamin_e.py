"""VITAMIN-E dense feature tracking: curvature extrema + affine flow.

Parity surface: /root/reference/tadataka/vo/vitamin_e.py — keypoint tables
with persistent integer ids, affine flow prediction between frames
(IRLS fit over feature matches), hill-climb correction on the image
curvature, keypoint spawning in newly-visible areas, id-intersection
matching across frames, and multi-view triangulation of surviving tracks.

Design: keypoint tables are (ids, coords) numpy pairs (the reference
used pandas DataFrames); the curvature, extrema-tracking, flow and
triangulation math all run as the jitted kernels from ``features/`` and
``core/``.
"""

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from tadataka_tpu.core.image_range import is_in_image_range
from tadataka_tpu.core.triangulation import linear_triangulation
from tadataka_tpu.features import Matcher
from tadataka_tpu.features.brief import extract_features
from tadataka_tpu.features.curvature import (
    compute_image_curvature, extract_curvature_extrema)
from tadataka_tpu.features.extrema_tracker import ExtremaTracker
from tadataka_tpu.features.flow import estimate_affine_transform


class KeypointFrame(NamedTuple):
    """Tracked keypoints of one frame: persistent ids + [x, y] coords."""
    ids: np.ndarray     # (N,) int64
    coords: np.ndarray  # (N, 2) float32


def create_keypoint_frame(start_id, keypoints):
    n = len(keypoints)
    return KeypointFrame(np.arange(start_id, start_id + n, dtype=np.int64),
                         np.asarray(keypoints, np.float32))


def init_keypoint_frame(image, percentile=98.0, max_keypoints=2048):
    kps, mask = extract_curvature_extrema(jnp.asarray(image),
                                          percentile=percentile,
                                          max_keypoints=max_keypoints)
    kps = np.asarray(kps)[np.asarray(mask)]
    return create_keypoint_frame(0, kps)


def estimate_flow(features0, features1, matcher=None):
    """Affine flow from frame0 to frame1 via robust IRLS over matches.

    Parity: estimate_flow (vo/vitamin_e.py:52-57).
    """
    matcher = matcher or Matcher()
    matches = matcher(features0, features1)
    mask = np.asarray(matches.mask)
    idx = np.asarray(matches.indices)[mask]
    kp0 = jnp.asarray(np.asarray(features0.keypoints)[idx[:, 0]])
    kp1 = jnp.asarray(np.asarray(features1.keypoints)[idx[:, 1]])
    return estimate_affine_transform(kp0, kp1)


def keypoints_from_new_area(image1, flow01, percentile=98.0,
                            max_keypoints=2048):
    """Extrema of frame 1 whose back-projection leaves frame 0."""
    kps, mask = extract_curvature_extrema(jnp.asarray(image1),
                                          percentile=percentile,
                                          max_keypoints=max_keypoints)
    kps = np.asarray(kps)[np.asarray(mask)]
    back = flow01.inverse(jnp.asarray(kps))
    outside = ~np.asarray(is_in_image_range(back, image1.shape))
    return kps[outside]


class Tracker:
    """Track a KeypointFrame into the next image.

    Parity: Tracker (vo/vitamin_e.py:59-79): predict with the affine flow,
    correct by curvature hill climb, drop out-of-frame tracks, spawn new
    keypoints in the newly visible area.
    """

    def __init__(self, flow01, image1, lambda_):
        self.flow01 = flow01
        self.image1 = np.asarray(image1)
        self.lambda_ = lambda_

    def __call__(self, keypoints0: KeypointFrame) -> KeypointFrame:
        curvature = compute_image_curvature(jnp.asarray(self.image1))
        tracker = ExtremaTracker(curvature, self.lambda_)

        predicted = np.asarray(self.flow01(jnp.asarray(keypoints0.coords)))
        corrected = np.asarray(tracker.optimize(jnp.asarray(predicted)))
        in_range = np.asarray(is_in_image_range(jnp.asarray(corrected),
                                                self.image1.shape))

        ids1 = keypoints0.ids[in_range]
        coords1 = corrected[in_range]

        new_kps = keypoints_from_new_area(self.image1, self.flow01)
        next_id = (keypoints0.ids[-1] + 1) if len(keypoints0.ids) else 0
        new_ids = np.arange(next_id, next_id + len(new_kps), dtype=np.int64)

        return KeypointFrame(np.concatenate([ids1, new_ids]),
                             np.concatenate([coords1,
                                             new_kps.astype(np.float32)]))


def match_keypoints(keypoints0: KeypointFrame, keypoints1: KeypointFrame):
    """(n, 2) row indices of tracks present in both frames."""
    _, i0, i1 = np.intersect1d(keypoints0.ids, keypoints1.ids,
                               return_indices=True)
    return np.column_stack([i0, i1])


def match_multiple_keypoints(keypoint_frames):
    """Row indices of tracks shared by every frame, (n, n_frames)."""
    from functools import reduce
    shared = reduce(np.intersect1d, [kf.ids for kf in keypoint_frames])
    matches = np.empty((len(shared), len(keypoint_frames)), dtype=np.int64)
    for i, kf in enumerate(keypoint_frames):
        _, _, idx = np.intersect1d(shared, kf.ids, return_indices=True)
        matches[:, i] = idx
    return matches


def track_sequence(images, lambda_=0.5, matcher=None, patch_size=64,
                   fast_threshold=50.0 / 255.0, max_keypoints=512):
    """Run the full tracking chain over an image sequence.

    Returns a list of KeypointFrames (one per image) with persistent ids.
    """
    matcher = matcher or Matcher()
    features = [extract_features(jnp.asarray(im),
                                 max_keypoints=max_keypoints,
                                 threshold=fast_threshold,
                                 patch_size=patch_size)
                for im in images]
    keypoints = [init_keypoint_frame(images[0])]
    for i in range(len(images) - 1):
        flow01 = estimate_flow(features[i], features[i + 1], matcher)
        tracker = Tracker(flow01, images[i + 1], lambda_)
        keypoints.append(tracker(keypoints[i]))
    return keypoints


class VitaminEVO:
    """Full VITAMIN-E visual odometry: dense extrema tracking with pose
    estimation from the tracks.

    Parity surface: /root/reference/examples/vitamin_e_vo.py (run_vo:
    essential-matrix pose from tracked keypoints + triangulation), extended
    from the reference's two-frame sketch into a sequence VO:
    - frame 1: essential-matrix bootstrap (scale-free) over the tracks
    - frame k: PnP against the triangulated track map, then triangulation
      of tracks not yet in the map — each against its FIRST observation,
      maximizing parallax (tracks persist by integer id, so the first
      observation is free bookkeeping)
    """

    def __init__(self, camera_model, lambda_=0.5, matcher=None,
                 fast_threshold=50.0 / 255.0, max_keypoints=512,
                 patch_size=64, percentile=98.0, max_track_keypoints=2048,
                 pnp_threshold=0.005, min_track_gap=1):
        self.camera_model = camera_model
        self.lambda_ = lambda_
        self.matcher = matcher or Matcher()
        self.fast_threshold = fast_threshold
        self.max_keypoints = max_keypoints
        self.patch_size = patch_size
        self.percentile = percentile
        self.max_track_keypoints = max_track_keypoints
        self.pnp_threshold = pnp_threshold
        self.min_track_gap = min_track_gap

        self.poses_cw = []        # world->camera per frame
        self.keypoints = []       # KeypointFrame per frame
        self._features = None     # detector features of the latest frame
        self.points = {}          # track id -> (3,) world point
        self._first_obs = {}      # track id -> (frame_idx, (2,) pixel xy)
        self._tri_gap = {}        # track id -> frame gap used to triangulate

    def _normalize(self, coords):
        return np.asarray(self.camera_model.normalize(
            jnp.asarray(coords, jnp.float32)))

    def _record_first_obs(self, frame_idx, kp: KeypointFrame):
        for i, tid in enumerate(kp.ids):
            if tid not in self._first_obs:
                self._first_obs[tid] = (frame_idx, kp.coords[i])

    def _triangulate_new(self, frame_idx, kp: KeypointFrame):
        """(Re-)triangulate tracks against their first observation: new
        tracks once they reach ``min_track_gap`` frames of parallax, and
        existing map points whenever the track has aged (longer baseline =
        better-conditioned depth, so the map sharpens as the camera moves)."""
        from tadataka_tpu.core.triangulation import (
            two_view_triangulation, compute_depth_mask)

        def wants(tid):
            if tid not in self._first_obs:
                return False
            gap = frame_idx - self._first_obs[tid][0]
            if gap < self.min_track_gap:
                return False
            return tid not in self.points or gap > self._tri_gap.get(tid, 0)

        sel = [i for i, tid in enumerate(kp.ids) if wants(tid)]
        if not sel:
            return
        first = [self._first_obs[kp.ids[i]] for i in sel]
        by_frame = {}
        for slot, (j, xy0) in enumerate(first):
            by_frame.setdefault(j, []).append((slot, xy0))
        for j, entries in by_frame.items():
            slots = [s for s, _ in entries]
            xy0 = np.stack([xy for _, xy in entries])
            xy1 = kp.coords[[sel[s] for s in slots]]
            pts, depths = two_view_triangulation(
                self.poses_cw[j], self.poses_cw[frame_idx],
                jnp.asarray(self._normalize(xy0)),
                jnp.asarray(self._normalize(xy1)))
            ok = (np.asarray(compute_depth_mask(depths))
                  & np.isfinite(np.asarray(pts)).all(axis=1))
            pts = np.asarray(pts)
            for s, good, p in zip(slots, ok, pts):
                if good:
                    tid = kp.ids[sel[s]]
                    self.points[tid] = p
                    self._tri_gap[tid] = frame_idx - j

    def estimate(self, image):
        """Process a frame (grayscale or RGB); returns the camera->world
        Pose, or None if tracking failed for this frame."""
        from tadataka_tpu.core.pose import Pose
        image = np.asarray(image)
        if image.ndim == 3:
            from tadataka_tpu.dataset.image_io import rgb2gray
            image = rgb2gray(image)

        feats = extract_features(jnp.asarray(image, jnp.float32),
                                 max_keypoints=self.max_keypoints,
                                 threshold=self.fast_threshold,
                                 patch_size=self.patch_size)

        if not self.poses_cw:
            kp = init_keypoint_frame(image, self.percentile,
                                     self.max_track_keypoints)
            self.keypoints.append(kp)
            self._features = feats
            self.poses_cw.append(Pose.identity())
            self._record_first_obs(0, kp)
            return Pose.identity()

        k = len(self.poses_cw)
        flow01 = estimate_flow(self._features, feats, self.matcher)
        kp1 = Tracker(flow01, image, self.lambda_)(self.keypoints[-1])

        if k == 1:
            pose_cw = self._bootstrap(kp1)
        else:
            pose_cw = self._localize(kp1)
        if pose_cw is None:
            return None

        self.poses_cw.append(pose_cw)
        self.keypoints.append(kp1)
        self._features = feats
        self._record_first_obs(k, kp1)
        self._triangulate_new(k, kp1)
        return pose_cw.inv()

    def _bootstrap(self, kp1):
        from tadataka_tpu.pose_estimation import estimate_pose_change
        matches = match_keypoints(self.keypoints[0], kp1)
        if matches.shape[0] < 8:
            return None
        xy0 = self.keypoints[0].coords[matches[:, 0]]
        xy1 = kp1.coords[matches[:, 1]]
        # world->cam1 directly: frame 0 is the world origin
        return estimate_pose_change(jnp.asarray(self._normalize(xy0)),
                                    jnp.asarray(self._normalize(xy1)))

    def _localize(self, kp1):
        from tadataka_tpu.pose_estimation.pnp import solve_pnp
        from tadataka_tpu.utils.exceptions import (
            NotEnoughInliersException, print_error)
        sel = [i for i, tid in enumerate(kp1.ids) if tid in self.points]
        if len(sel) < 6:
            return None
        pts = np.stack([self.points[kp1.ids[i]] for i in sel])
        norm = self._normalize(kp1.coords[sel])
        try:
            return solve_pnp(jnp.asarray(pts), jnp.asarray(norm),
                             reprojection_threshold=self.pnp_threshold)
        except NotEnoughInliersException as e:
            print_error(str(e))
            return None


def triangulate_tracks(camera_models, poses, keypoint_frames):
    """Multi-view triangulation of tracks shared across every given frame.

    poses: world->camera Poses.  Returns (points (N, 3), depths (V, N)).
    """
    matches = match_multiple_keypoints(keypoint_frames)
    V = len(keypoint_frames)
    N = matches.shape[0]
    normalized = np.empty((V, N, 2), np.float32)
    for i, (cm, kf) in enumerate(zip(camera_models, keypoint_frames)):
        coords = kf.coords[matches[:, i]]
        normalized[i] = np.asarray(cm.normalize(jnp.asarray(coords)))
    rotations = jnp.stack([p.R for p in poses])
    translations = jnp.stack([p.t for p in poses])
    return linear_triangulation(rotations, translations,
                                jnp.asarray(normalized))
