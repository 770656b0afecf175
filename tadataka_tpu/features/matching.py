"""Descriptor matching as one dense matrix product.

Parity surface: /root/reference/tadataka/match.py (cross-check + Lowe ratio
0.8 over a dense distance matrix — the reference's hot spot, computed there
with sklearn pairwise_distances) and the Matcher pipeline of
/root/reference/tadataka/feature/feature.py:97-134 (match -> RANSAC
fundamental inlier filter -> chi^2 symmetric-transfer filter).

Design: for +-1 descriptors the Hamming distance matrix is
(D - A B^T) / 2 — one matmul with f32 accumulation, exact even in TF32.
Masked argmin replaces boolean compaction; match lists keep static
capacity K1.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_BIG = jnp.float32(1e9)


class Matches(NamedTuple):
    indices: jnp.ndarray  # (K1, 2) int32 — (index in set 1, index in set 2)
    mask: jnp.ndarray     # (K1,) bool

    @property
    def n_valid(self):
        return jnp.sum(self.mask)


@jax.jit
def hamming_distances(descriptors1, descriptors2):
    """(K1, K2) Hamming distances between +-1 codes, as one matmul."""
    D = descriptors1.shape[1]
    # fast-precision matmul with f32 accumulation: +-1 codes are exact in
    # TF32 and bf16, and the integer sums stay below 2^24
    S = jax.lax.dot_general(
        descriptors1, descriptors2,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32)
    return (D - S) * 0.5


@partial(jax.jit, static_argnames=("cross_check", "max_ratio"))
def match_descriptors(descriptors1, descriptors2, mask1, mask2,
                      cross_check=True, max_ratio=0.8):
    """Masked mutual-NN + ratio-test matching.  Returns Matches with
    capacity K1."""
    dist = hamming_distances(descriptors1, descriptors2)
    dist = jnp.where(mask1[:, None], dist, _BIG)
    dist = jnp.where(mask2[None, :], dist, _BIG)

    best2 = jnp.argmin(dist, axis=1)                   # (K1,)
    best_d = jnp.take_along_axis(dist, best2[:, None], axis=1)[:, 0]
    valid = mask1 & (best_d < _BIG)

    if cross_check:
        best1 = jnp.argmin(dist, axis=0)               # (K2,)
        valid = valid & (best1[best2] == jnp.arange(dist.shape[0]))

    if max_ratio < 1.0:
        masked = dist.at[jnp.arange(dist.shape[0]), best2].set(_BIG)
        second_d = jnp.min(masked, axis=1)
        second_d = jnp.where(second_d == 0.0, jnp.finfo(jnp.float32).eps,
                             second_d)
        valid = valid & (best_d / second_d < max_ratio)

    indices = jnp.stack(
        [jnp.arange(dist.shape[0], dtype=jnp.int32),
         best2.astype(jnp.int32)], axis=-1)
    return Matches(indices, valid)


@partial(jax.jit, static_argnames=("cross_check", "max_ratio"))
def match_descriptors_guided(descriptors1, descriptors2, mask1, mask2,
                             predicted2, keypoints2, radius,
                             cross_check=True, max_ratio=0.9):
    """Spatially-gated matching: candidate j in set 2 is admissible for
    descriptor i only if ``keypoints2[j]`` lies within ``radius`` of
    ``predicted2[i]`` (the projection of i's 3D point into image 2).

    This is the guided search of ORB-SLAM-style local-map tracking — an
    upgrade over the reference's global brute-force matching: the spatial
    gate removes most repetitive-texture ambiguity, so low-parallax frames
    keep far more correct associations.  The gate is one extra (K1, K2)
    distance matrix fused into the same masked-argmin program.
    """
    dist = hamming_distances(descriptors1, descriptors2)
    dist = jnp.where(mask1[:, None], dist, _BIG)
    dist = jnp.where(mask2[None, :], dist, _BIG)

    diff = predicted2[:, None, :] - keypoints2[None, :, :]
    sq = jnp.sum(diff * diff, axis=-1)
    dist = jnp.where(sq <= radius * radius, dist, _BIG)

    best2 = jnp.argmin(dist, axis=1)
    best_d = jnp.take_along_axis(dist, best2[:, None], axis=1)[:, 0]
    valid = mask1 & (best_d < _BIG)

    if cross_check:
        best1 = jnp.argmin(dist, axis=0)
        valid = valid & (best1[best2] == jnp.arange(dist.shape[0]))

    if max_ratio < 1.0:
        masked = dist.at[jnp.arange(dist.shape[0]), best2].set(_BIG)
        second_d = jnp.min(masked, axis=1)
        # a second-best outside the gate (=_BIG) means "unambiguous"
        ratio_ok = (second_d >= _BIG) | (best_d / jnp.maximum(
            second_d, jnp.finfo(jnp.float32).eps) < max_ratio)
        valid = valid & ratio_ok

    indices = jnp.stack(
        [jnp.arange(dist.shape[0], dtype=jnp.int32),
         best2.astype(jnp.int32)], axis=-1)
    return Matches(indices, valid)


@partial(jax.jit, static_argnames=("enable_ransac",
                                   "enable_homography_filter",
                                   "min_inliers"))
def match_pairs_stacked(descs1, kps1, masks1, desc2, kp2, mask2, keys,
                        enable_ransac=True, enable_homography_filter=True,
                        min_inliers=12):
    """All keyframe-window pairs against one new frame as ONE vmapped
    program: (V, K, D) stacked old-viewpoint features vs the new frame.

    Returns (indices (V, K, 2), masks (V, K)).  One dispatch + one fetch
    replaces V sequential Matcher programs, each with its own dispatch
    and fetch.
    Semantics per pair are identical to Matcher.__call__.
    """
    from tadataka_tpu.features.ransac import ransac_fundamental
    from tadataka_tpu.features.filters import symmetric_transfer_filter

    def one(d1, k1, m1, key):
        matches = match_descriptors(d1, desc2, m1, mask2)
        p1 = k1[matches.indices[:, 0]]
        p2 = kp2[matches.indices[:, 1]]
        enough = matches.n_valid >= min_inliers
        mask = matches.mask
        if enable_ransac:
            _, inlier_mask = ransac_fundamental(p1, p2, mask, key)
            mask = jnp.where(enough, mask & inlier_mask, mask)
        if enable_homography_filter:
            filter_mask = symmetric_transfer_filter(p1, p2, mask, p=0.95)
            mask = jnp.where(enough, mask & filter_mask, mask)
        return matches.indices, mask

    return jax.vmap(one)(descs1, kps1, masks1, keys)


class Matcher:
    """match -> RANSAC(F) -> chi^2 homography filter, capacity-stable.

    Parity: Matcher (/root/reference/tadataka/feature/feature.py:97-134),
    min_inliers=12 skip semantics included.
    """

    def __init__(self, enable_ransac=True, enable_homography_filter=True,
                 seed=3939):
        self.enable_ransac = enable_ransac
        self.enable_homography_filter = enable_homography_filter
        self.key = jax.random.PRNGKey(seed)

    def match_many(self, features_list, features2, min_inliers=12):
        """Match every features in ``features_list`` against
        ``features2`` in one vmapped program; returns device
        (indices (V, K, 2), masks (V, K))."""
        descs1 = jnp.stack([f.descriptors for f in features_list])
        kps1 = jnp.stack([f.keypoints for f in features_list])
        masks1 = jnp.stack([f.mask for f in features_list])
        keys = jax.random.split(self.key, len(features_list))
        return match_pairs_stacked(
            descs1, kps1, masks1,
            features2.descriptors, features2.keypoints, features2.mask,
            keys, enable_ransac=self.enable_ransac,
            enable_homography_filter=self.enable_homography_filter,
            min_inliers=min_inliers)

    def __call__(self, features1, features2, min_inliers=12):
        from tadataka_tpu.features.ransac import ransac_fundamental
        from tadataka_tpu.features.filters import symmetric_transfer_filter

        matches = match_descriptors(
            features1.descriptors, features2.descriptors,
            features1.mask, features2.mask)

        kp1 = features1.keypoints[matches.indices[:, 0]]
        kp2 = features2.keypoints[matches.indices[:, 1]]

        n = matches.n_valid
        enough = n >= min_inliers

        if self.enable_ransac:
            _, inlier_mask = ransac_fundamental(
                kp1, kp2, matches.mask, self.key)
            matches = Matches(matches.indices,
                              jnp.where(enough,
                                        matches.mask & inlier_mask,
                                        matches.mask))

        if self.enable_homography_filter:
            filter_mask = symmetric_transfer_filter(
                kp1, kp2, matches.mask, p=0.95)
            matches = Matches(matches.indices,
                              jnp.where(enough,
                                        matches.mask & filter_mask,
                                        matches.mask))

        return matches
