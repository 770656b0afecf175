"""Lens distortion models: FOV (Devernay-Faugeras) and radial-tangential.

Parity surface: /root/reference/tadataka/camera/distortion.py (FOV closed
forms with r~0 guards; COLMAP-convention RadTan) and the reference's
sympy-generated Newton undistort (/root/reference/tadataka/camera/_radtan.pyx).

Design: the reference generates the 2x2 distort Jacobian with sympy at
build time; here it falls out of ``jax.jacfwd`` at trace time.  The Newton
undistort is a ``lax.while_loop`` with a batched convergence test — the
data-dependent per-point loop becomes a masked fixed-structure iteration.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

_R_EPS = 1e-8


class NoDistortion(NamedTuple):
    def distort(self, x):
        return x

    def undistort(self, x):
        return x

    def distort_xy(self, u, v):
        return u, v

    def undistort_xy(self, u, v):
        return u, v

    @property
    def params(self):
        return []


class FOV(NamedTuple):
    """One-parameter FOV distortion (Devernay & Faugeras 1995)."""
    omega: jnp.ndarray

    @classmethod
    def create(cls, omega, dtype=jnp.float32):
        return cls(jnp.asarray(omega, dtype=dtype))

    def _should_bypass(self):
        return jnp.isclose(self.omega, 0.0)

    def distort(self, x):
        omega = self.omega
        r = jnp.linalg.norm(x, axis=-1)
        tan_half = jnp.tan(omega / 2.0)
        small_r = jnp.abs(r) < _R_EPS
        safe_r = jnp.where(small_r, 1.0, r)
        factor = jnp.where(
            small_r,
            2.0 * tan_half / omega,                     # lim r->0
            jnp.arctan(2.0 * safe_r * tan_half) / (omega * safe_r))
        factor = jnp.where(self._should_bypass(), 1.0, factor)
        return factor[..., None] * x

    def undistort(self, x):
        omega = self.omega
        r = jnp.linalg.norm(x, axis=-1)
        tan_half = jnp.tan(omega / 2.0)
        small_r = jnp.abs(r) < _R_EPS
        safe_r = jnp.where(small_r, 1.0, r)
        factor = jnp.where(
            small_r,
            omega / (2.0 * tan_half),
            jnp.tan(safe_r * omega) / (2.0 * safe_r * tan_half))
        factor = jnp.where(self._should_bypass(), 1.0, factor)
        return factor[..., None] * x

    def distort_xy(self, u, v):
        """Componentwise distort (no (N, 2) minor-dim tensors — see
        CameraParameters.normalize_xy)."""
        omega = self.omega
        r = jnp.sqrt(u * u + v * v)
        tan_half = jnp.tan(omega / 2.0)
        small_r = jnp.abs(r) < _R_EPS
        safe_r = jnp.where(small_r, 1.0, r)
        factor = jnp.where(
            small_r,
            2.0 * tan_half / omega,
            jnp.arctan(2.0 * safe_r * tan_half) / (omega * safe_r))
        factor = jnp.where(self._should_bypass(), 1.0, factor)
        return factor * u, factor * v

    def undistort_xy(self, u, v):
        omega = self.omega
        r = jnp.sqrt(u * u + v * v)
        tan_half = jnp.tan(omega / 2.0)
        small_r = jnp.abs(r) < _R_EPS
        safe_r = jnp.where(small_r, 1.0, r)
        factor = jnp.where(
            small_r,
            omega / (2.0 * tan_half),
            jnp.tan(safe_r * omega) / (2.0 * safe_r * tan_half))
        factor = jnp.where(self._should_bypass(), 1.0, factor)
        return factor * u, factor * v

    @classmethod
    def from_params(cls, params):
        assert len(params) == 1
        return cls.create(params[0])

    @property
    def params(self):
        return [float(self.omega)]


def _radtan_distort_one(coeffs, x):
    k1, k2, p1, p2, k3 = coeffs[0], coeffs[1], coeffs[2], coeffs[3], coeffs[4]
    u, v = x[0], x[1]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    r4 = r2 * r2
    r6 = r4 * r2
    kr = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    return jnp.stack([
        u * kr + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2),
        v * kr + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2),
    ])


class RadTan(NamedTuple):
    """Radial-tangential distortion, COLMAP coefficient convention
    (k1, k2, p1, p2, k3)."""
    dist_coeffs: jnp.ndarray  # (5,)

    @classmethod
    def create(cls, dist_coeffs, dtype=jnp.float32):
        c = jnp.zeros(5, dtype=dtype)
        c = c.at[:len(dist_coeffs)].set(jnp.asarray(dist_coeffs, dtype=dtype))
        return cls(c)

    def distort(self, x):
        flat = x.reshape(-1, 2)
        out = jax.vmap(_radtan_distort_one, in_axes=(None, 0))(
            self.dist_coeffs, flat)
        return out.reshape(x.shape)

    def undistort(self, x, max_iter=100, threshold=1e-10):
        flat = x.reshape(-1, 2)
        u, v = self.undistort_xy(flat[:, 0], flat[:, 1],
                                 max_iter=max_iter, threshold=threshold)
        return jnp.stack([u, v], axis=-1).reshape(x.shape)

    def distort_xy(self, u, v):
        """Componentwise COLMAP radial-tangential distort."""
        c = self.dist_coeffs
        k1, k2, p1, p2, k3 = c[0], c[1], c[2], c[3], c[4]
        u2, v2, uv = u * u, v * v, u * v
        r2 = u2 + v2
        r4 = r2 * r2
        kr = 1.0 + k1 * r2 + k2 * r4 + k3 * r4 * r2
        return (u * kr + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2),
                v * kr + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2))

    def undistort_xy(self, u, v, max_iter=100, threshold=1e-10):
        """Batched componentwise Newton undistort with the ANALYTIC 2x2
        Jacobian (same math the reference generates with sympy,
        /root/reference/tadataka/camera/_radtan.pyx:65-88).

        One whole-array while_loop instead of a vmapped per-point loop:
        the vmap form builds (N, 2, 2) jacfwd tensors with tiny minor
        dims, and every point pays the worst point's
        iteration count either way.  Converged lanes freeze (matching the
        per-point stop), the loop exits when ALL lanes converge.
        """
        c = self.dist_coeffs
        k1, k2, p1, p2, k3 = c[0], c[1], c[2], c[3], c[4]

        def newton_step(pu, pv):
            u2, v2, uv = pu * pu, pv * pv, pu * pv
            r2 = u2 + v2
            r4 = r2 * r2
            kr = 1.0 + k1 * r2 + k2 * r4 + k3 * r4 * r2
            du = pu * kr + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2)
            dv = pv * kr + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2)
            # d(kr)/d(r2) expanded through r2's u/v derivatives
            dkr = k1 + 2.0 * k2 * r2 + 3.0 * k3 * r4
            j00 = kr + 2.0 * u2 * dkr + 2.0 * p1 * pv + 6.0 * p2 * pu
            j11 = kr + 2.0 * v2 * dkr + 2.0 * p2 * pu + 6.0 * p1 * pv
            j01 = 2.0 * uv * dkr + 2.0 * p1 * pu + 2.0 * p2 * pv
            rx = u - du
            ry = v - dv
            det = j00 * j11 - j01 * j01
            su = (j11 * rx - j01 * ry) / det
            sv = (j00 * ry - j01 * rx) / det
            return su, sv

        def cond(state):
            i, _, _, active = state
            return jnp.logical_and(i < max_iter, jnp.any(active))

        def body(state):
            i, pu, pv, active = state
            su, sv = newton_step(pu, pv)
            pu = jnp.where(active, pu + su, pu)
            pv = jnp.where(active, pv + sv, pv)
            err = su * su + sv * sv
            return i + 1, pu, pv, active & (err >= threshold)

        _, pu, pv, _ = jax.lax.while_loop(
            cond, body, (0, u, v, jnp.ones(jnp.shape(u), bool)))
        return pu, pv

    @classmethod
    def from_params(cls, params):
        return cls.create(params)

    @property
    def params(self):
        return [float(v) for v in self.dist_coeffs]
