"""tadataka_tpu — a visual odometry / SLAM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
IshitaTakeshi/Tadataka (feature-based VO, direct photometric VO, LSD-SLAM-style
semi-dense depth estimation, VITAMIN-E dense tracking, local bundle
adjustment), built accelerator-first:

- everything per-pixel / per-point is a vmapped or Pallas array program
  with static shapes and validity masks,
- per-pixel failure modes are flag arrays (``tadataka_tpu.flags``) instead of
  exceptions or Result types,
- descriptor matching / BA normal equations are dense matrix products,
- multi-chip scaling goes through ``jax.sharding`` meshes + ``shard_map``
  (``tadataka_tpu.parallel``), never host loops.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry math (3x3 rotations, 4x4 transforms, DLT, BA blocks) cannot
# survive a float32 matmul that the GPU runs in TF32 (about three decimal
# digits); make full f32 the framework default.  Hot large matmuls
# (descriptor matching, image-scale einsums) opt back into fast paths
# with an explicit ``precision=`` argument.
_jax.config.update("jax_default_matmul_precision", "highest")

from tadataka_tpu import flags  # noqa: F401
