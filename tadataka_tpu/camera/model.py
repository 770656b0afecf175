"""CameraModel: intrinsics + distortion, with text (de)serialization.

Parity surface: /root/reference/tadataka/camera/model.py — normalize =
undistort(normalize(u)), unnormalize = unnormalize(distort(x)), ``resize``
scales intrinsics for pyramid levels, and the "FOV ... / RadTan ..." string
format round-trips through ``fromstring``/``__str__``.

A CameraModel is a pytree (NamedTuple of pytrees), so it passes through jit
boundaries; the distortion *type* is static structure, the coefficients are
traced leaves.
"""

import re
from typing import NamedTuple, Any

from tadataka_tpu.camera.parameters import CameraParameters
from tadataka_tpu.camera.distortion import FOV, RadTan, NoDistortion


class CameraModel(NamedTuple):
    camera_parameters: CameraParameters
    distortion_model: Any  # NoDistortion | FOV | RadTan

    @classmethod
    def create(cls, camera_parameters, distortion_model=None):
        if distortion_model is None:
            distortion_model = NoDistortion()
        return cls(camera_parameters, distortion_model)

    def normalize(self, keypoints):
        """Pixel coords -> undistorted normalized image plane."""
        return self.distortion_model.undistort(
            self.camera_parameters.normalize(keypoints))

    def unnormalize(self, normalized_keypoints):
        """Normalized image plane -> (distorted) pixel coords."""
        return self.camera_parameters.unnormalize(
            self.distortion_model.distort(normalized_keypoints))

    # Componentwise forms (separate x / y arrays) — the hot-path layout
    # (see CameraParameters.normalize_xy).

    def normalize_xy(self, ux, uy):
        xn, yn = self.camera_parameters.normalize_xy(ux, uy)
        return self.distortion_model.undistort_xy(xn, yn)

    def unnormalize_xy(self, xn, yn):
        dx, dy = self.distortion_model.distort_xy(xn, yn)
        return self.camera_parameters.unnormalize_xy(dx, dy)

    def __str__(self):
        distortion_type = type(self.distortion_model).__name__
        params = self.camera_parameters.params + self.distortion_model.params
        return ' '.join([distortion_type] + [repr(float(v)) for v in params])

    @staticmethod
    def fromstring(string):
        parts = re.split(r"\s+", string.strip())
        distortion_type = parts[0]
        params = [float(v) for v in parts[1:]]
        camera_parameters = CameraParameters.from_params(params[0:4])
        dist_params = params[4:]
        if distortion_type == "FOV":
            distortion = FOV.from_params(dist_params)
        elif distortion_type == "RadTan":
            distortion = RadTan.from_params(dist_params)
        elif distortion_type == "NoDistortion":
            distortion = NoDistortion()
        else:
            raise ValueError(f"Unknown distortion model: {distortion_type}")
        return CameraModel(camera_parameters, distortion)


def resize(cm, scale):
    """Scale intrinsics for a pyramid level; distortion acts on the
    normalized plane and is scale-invariant."""
    p = cm.camera_parameters
    return CameraModel(
        CameraParameters(p.focal_length * scale, p.offset * scale),
        cm.distortion_model)
