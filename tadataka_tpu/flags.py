"""Per-pixel / per-point result flags.

The reference reports per-pixel failures through a Rust ``enum Flag``
(/root/reference/src/semi_dense/flag.rs:3-14) mirrored in Python
(/root/reference/tadataka/vo/semi_dense/flag.py:4-14).  A flag *array* is the
natural array representation: every lane computes its flag with ``lax.select``
chains and downstream consumers mask on ``flag == SUCCESS`` — no control flow,
no exceptions, fully vmappable.
"""

from enum import IntEnum

import jax.numpy as jnp


class Flag(IntEnum):
    SUCCESS = 0
    HYPOTHESIS_OUT_OF_SEARCH_RANGE = -1
    KEY_OUT_OF_RANGE = -2
    REF_CLOSE_OUT_OF_RANGE = -3
    REF_FAR_OUT_OF_RANGE = -4
    REF_EPIPOLAR_TOO_SHORT = -5
    INSUFFICIENT_GRADIENT = -6
    NEGATIVE_PRIOR_DEPTH = -7
    NEGATIVE_REF_DEPTH = -8
    NOT_PROCESSED = -9


def success_mask(flag_map):
    """Boolean mask of lanes that completed successfully."""
    return flag_map == int(Flag.SUCCESS)


def flag_histogram(flag_map):
    """Count of each flag value; returns (n_flags,) int32 array indexed by -flag.

    Index 0 counts SUCCESS, index k counts flag value -k.
    """
    n = len(Flag)
    idx = -flag_map.astype(jnp.int32)
    return jnp.bincount(idx.ravel(), length=n)
