"""BRIEF binary descriptors as +-1 float vectors.

Parity surface: /root/reference/tadataka/feature/feature.py:24-29 (skimage
BRIEF, descriptor_size=512, patch_size=64, uniform sampling, sigma=0.1).

Design: bits are stored as +-1 float32 so Hamming distance becomes a
matrix product: for D-bit codes a, b in {-1, +1}^D, hamming = (D - a.b) / 2.
The sampling pattern is a fixed compile-time constant.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tadataka_tpu.features.detector import Features

DESCRIPTOR_SIZE = 512
PATCH_SIZE = 64


from functools import lru_cache


@lru_cache(maxsize=None)
def _uniform_pattern(descriptor_size=DESCRIPTOR_SIZE, patch_size=PATCH_SIZE,
                     seed=1):
    """Fixed uniform sampling pattern, matching skimage's 'uniform' mode
    (pairs drawn uniformly from the patch)."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    pos0 = rng.integers(-(half - 2), half - 1, (descriptor_size, 2))
    pos1 = rng.integers(-(half - 2), half - 1, (descriptor_size, 2))
    # cache host arrays, not device values — jnp arrays created inside a jit
    # trace are tracers and must not escape through the cache
    return pos0.astype(np.int32), pos1.astype(np.int32)


def _smooth(image, sigma=1.0):
    radius = 2
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    g = jnp.exp(-0.5 * (x / sigma) ** 2)
    g = g / jnp.sum(g)
    sm = jax.vmap(lambda row: jnp.convolve(row, g, mode="same"))(image)
    sm = jax.vmap(lambda col: jnp.convolve(col, g, mode="same"))(sm.T).T
    return sm


@partial(jax.jit, static_argnames=("patch_size", "descriptor_size"))
def brief_descriptors(image, keypoints, mask, patch_size=PATCH_SIZE,
                      descriptor_size=DESCRIPTOR_SIZE):
    """Compute +-1 descriptors at integer keypoint locations.

    keypoints: (K, 2) [x, y].  Keypoints whose patch leaves the image are
    masked out (parity with skimage BRIEF's mask).
    """
    H, W = image.shape
    smoothed = _smooth(image)
    half = patch_size // 2
    _POS0, _POS1 = _uniform_pattern(descriptor_size, patch_size)

    kx = jnp.round(keypoints[:, 0]).astype(jnp.int32)
    ky = jnp.round(keypoints[:, 1]).astype(jnp.int32)

    inside = ((kx >= half) & (kx < W - half) & (ky >= half) & (ky < H - half))
    valid = mask & inside

    def sample(pos):
        xs = jnp.clip(kx[:, None] + pos[None, :, 0], 0, W - 1)
        ys = jnp.clip(ky[:, None] + pos[None, :, 1], 0, H - 1)
        return smoothed[ys, xs]                     # (K, D)

    i0 = sample(_POS0)
    i1 = sample(_POS1)
    bits = jnp.where(i0 < i1, 1.0, -1.0).astype(jnp.float32)
    return bits, valid


@partial(jax.jit, static_argnames=("max_keypoints", "patch_size"))
def extract_features(image, max_keypoints=512, threshold=50.0 / 255.0,
                     patch_size=PATCH_SIZE):
    """FAST + BRIEF, the reference's ``extract_features`` (feature.py:68).

    ``patch_size`` defaults to the reference's 64; use a smaller patch for
    small images (the patch must fit inside the frame for a keypoint to
    keep its descriptor).
    """
    from tadataka_tpu.features.detector import detect_fast
    feats = detect_fast(image, threshold, max_keypoints)
    descriptors, valid = brief_descriptors(image, feats.keypoints, feats.mask,
                                           patch_size)
    return Features(feats.keypoints, descriptors, valid)
