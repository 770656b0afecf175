"""ORB-style oriented binary descriptors (steered BRIEF).

Parity surface: the reference keeps an unused ORB extractor next to BRIEF
(/root/reference/tadataka/feature/feature.py:31).  Here it is a first-class
descriptor: intensity-centroid orientation (Rosin moments, as in Rublee et
al. ICCV'11) + a BRIEF pattern steered by the keypoint angle.

Design: all K keypoints compute their orientation from the same fixed
circular-disk offset table in one gather + two weighted reductions; the
per-keypoint pattern rotation is a (K, 1, 1) x (D, 2) broadcast matmul.
Descriptors are +-1 float32 so matching is one matrix product like BRIEF
(features/matching.py).
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from tadataka_tpu.features.brief import _smooth
from tadataka_tpu.features.detector import Features

DESCRIPTOR_SIZE = 256
PATCH_SIZE = 32


@lru_cache(maxsize=None)
def _gaussian_pattern(descriptor_size=DESCRIPTOR_SIZE,
                      patch_size=PATCH_SIZE, seed=7):
    """Fixed Gaussian sampling pattern (BRIEF-paper G II: sigma = S/5),
    clipped so rotated samples stay inside the patch radius."""
    rng = np.random.default_rng(seed)
    sigma = patch_size / 5.0
    # keep within radius patch/2 - 2 so any rotation stays in the patch
    r_max = patch_size / 2.0 - 2.0
    pos = rng.normal(0.0, sigma, (2, descriptor_size, 2))
    norm = np.linalg.norm(pos, axis=-1, keepdims=True)
    pos = np.where(norm > r_max, pos * (r_max / norm), pos)
    return (pos[0].astype(np.float32), pos[1].astype(np.float32))


@lru_cache(maxsize=None)
def _disk_offsets(radius=7):
    """Integer offsets of a filled disk, as a fixed (M, 2) [dx, dy] table."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    inside = xs ** 2 + ys ** 2 <= radius ** 2
    return np.stack([xs[inside], ys[inside]], axis=-1).astype(np.int32)


def corner_orientations(image, keypoints, radius=7):
    """Intensity-centroid angle per keypoint: atan2(m01, m10) over a disk.

    keypoints: (K, 2) [x, y].  Returns (K,) angles in radians.
    """
    H, W = image.shape
    offs = jnp.asarray(_disk_offsets(radius))        # (M, 2)
    kx = jnp.round(keypoints[:, 0]).astype(jnp.int32)
    ky = jnp.round(keypoints[:, 1]).astype(jnp.int32)
    xs = jnp.clip(kx[:, None] + offs[None, :, 0], 0, W - 1)
    ys = jnp.clip(ky[:, None] + offs[None, :, 1], 0, H - 1)
    patch = image[ys, xs]                            # (K, M)
    m10 = jnp.sum(patch * offs[None, :, 0], axis=1)
    m01 = jnp.sum(patch * offs[None, :, 1], axis=1)
    return jnp.arctan2(m01, m10)


@partial(jax.jit, static_argnames=("patch_size", "descriptor_size"))
def orb_descriptors(image, keypoints, mask, patch_size=PATCH_SIZE,
                    descriptor_size=DESCRIPTOR_SIZE):
    """Steered-BRIEF +-1 descriptors at integer keypoint locations.

    Returns (bits (K, D), valid (K,), orientations (K,)).
    """
    H, W = image.shape
    smoothed = _smooth(image)
    half = patch_size // 2
    p0, p1 = _gaussian_pattern(descriptor_size, patch_size)
    p0, p1 = jnp.asarray(p0), jnp.asarray(p1)

    theta = corner_orientations(image, keypoints)
    c, s = jnp.cos(theta), jnp.sin(theta)
    # per-keypoint rotation of the pattern: (K, D, 2)
    rot = jnp.stack([jnp.stack([c, -s], -1),
                     jnp.stack([s, c], -1)], -2)      # (K, 2, 2)

    kx = keypoints[:, 0]
    ky = keypoints[:, 1]
    inside = ((kx >= half) & (kx < W - half) & (ky >= half) & (ky < H - half))
    valid = mask & inside

    def sample(pos):
        rp = jnp.einsum("kij,dj->kdi", rot, pos)      # (K, D, 2)
        xs = jnp.clip(jnp.round(kx[:, None] + rp[..., 0]).astype(jnp.int32),
                      0, W - 1)
        ys = jnp.clip(jnp.round(ky[:, None] + rp[..., 1]).astype(jnp.int32),
                      0, H - 1)
        return smoothed[ys, xs]                       # (K, D)

    i0 = sample(p0)
    i1 = sample(p1)
    bits = jnp.where(i0 < i1, 1.0, -1.0).astype(jnp.float32)
    return bits, valid, theta


@partial(jax.jit, static_argnames=("max_keypoints", "patch_size"))
def extract_orb_features(image, max_keypoints=512, threshold=50.0 / 255.0,
                         patch_size=PATCH_SIZE):
    """FAST + oriented BRIEF — drop-in alternative to ``extract_features``."""
    from tadataka_tpu.features.detector import detect_fast
    feats = detect_fast(image, threshold, max_keypoints)
    bits, valid, _ = orb_descriptors(image, feats.keypoints, feats.mask,
                                     patch_size)
    return Features(feats.keypoints, bits, valid)
