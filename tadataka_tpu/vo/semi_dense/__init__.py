"""LSD-SLAM-style semi-dense inverse-depth estimation as array programs.

Parity surface: /root/reference/src/semi_dense/ (the reference's Rust crate:
per-pixel epipolar search with a 5-sample key patch, normalized-SSD matching,
geometric+photometric variance model, Gaussian hypothesis fusion, depth/
variance propagation, age tracking).

Design: the reference runs a serial H*W double loop with early-exit
``Result<_, Flag>`` per pixel (semi_dense.rs:186-228).  Here every pixel is
one vmap lane: the epipolar line is sampled at a fixed maximum length with a
validity mask, failures become flag values selected with where-chains, and
one ``update_depth`` call is a single fused XLA program over the whole map.
"""

from tadataka_tpu.vo.semi_dense.params import SemiDenseParams
from tadataka_tpu.vo.semi_dense.frame import SemiDenseFrame, make_frame
from tadataka_tpu.vo.semi_dense.estimator import (
    update_depth, estimate_pixel, estimate_debug)
from tadataka_tpu.vo.semi_dense.propagation import propagate, propagate_tent
from tadataka_tpu.vo.semi_dense.age import increment_age
from tadataka_tpu.vo.semi_dense.fusion import fusion, fusion_maps
from tadataka_tpu.vo.semi_dense.regularization import regularize
