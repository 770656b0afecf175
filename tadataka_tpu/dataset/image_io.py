"""Minimal image file IO (PIL-backed) and gray conversion.

The reference reads images through skimage.io; here file IO goes through
PIL, imported only by ``imread``/``imsave`` so that the in-memory
pipelines (which only need ``rgb2gray``) run without it.  Handles 8-bit
gray/RGB(A) and 16-bit depth PNGs.
"""

import numpy as np


def imread(path):
    from PIL import Image
    with Image.open(str(path)) as img:
        arr = np.asarray(img)
    return arr


def imsave(path, array):
    from PIL import Image
    array = np.asarray(array)
    if array.dtype == np.uint16:
        img = Image.fromarray(array.astype(np.int32), mode="I")
        # Pillow writes mode "I" as 32-bit; convert to 16-bit container
        img = img.convert("I;16")
    else:
        img = Image.fromarray(array)
    img.save(str(path))


def rgb2gray(image):
    """ITU-R 601 luma, matching skimage.color.rgb2gray on uint8/float."""
    image = np.asarray(image)
    if image.ndim == 2:
        return image.astype(np.float32)
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    rgb = image[..., :3].astype(np.float32)
    return rgb @ np.array([0.2125, 0.7154, 0.0721], dtype=np.float32)
