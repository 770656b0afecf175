"""Pinhole intrinsics as a pytree.

Parity surface: /root/reference/tadataka/camera/parameters.py and
/root/reference/src/camera.rs (normalize = (u - c) / f, unnormalize = u*f + c).
"""

from typing import NamedTuple

import jax.numpy as jnp


class CameraParameters(NamedTuple):
    focal_length: jnp.ndarray  # (2,) [fx, fy]
    offset: jnp.ndarray        # (2,) [cx, cy]

    @classmethod
    def create(cls, focal_length, offset, dtype=jnp.float32):
        return cls(jnp.asarray(focal_length, dtype=dtype),
                   jnp.asarray(offset, dtype=dtype))

    @property
    def matrix(self):
        fx, fy = self.focal_length[0], self.focal_length[1]
        cx, cy = self.offset[0], self.offset[1]
        zero = jnp.zeros_like(fx)
        one = jnp.ones_like(fx)
        return jnp.stack([
            jnp.stack([fx, zero, cx]),
            jnp.stack([zero, fy, cy]),
            jnp.stack([zero, zero, one]),
        ])

    @property
    def params(self):
        return list(self.focal_length.tolist()) + list(self.offset.tolist())

    @classmethod
    def from_params(cls, params):
        return cls.create(params[0:2], params[2:4])

    def normalize(self, keypoints):
        """Pixel coords (..., 2) -> normalized image plane (..., 2)."""
        return (keypoints - self.offset) / self.focal_length

    def unnormalize(self, keypoints):
        return keypoints * self.focal_length + self.offset

    # Componentwise forms: separate x / y arrays of any (matching) shape.
    # Hot paths (DVO, plane sweep) carry components, not packed (N, 2)
    # tensors with a tiny minor dimension.

    def normalize_xy(self, ux, uy):
        return ((ux - self.offset[0]) / self.focal_length[0],
                (uy - self.offset[1]) / self.focal_length[1])

    def unnormalize_xy(self, xn, yn):
        return (xn * self.focal_length[0] + self.offset[0],
                yn * self.focal_length[1] + self.offset[1])
