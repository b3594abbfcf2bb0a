"""Reissner-Nordstrom metric: charged, non-rotating black hole.

Third metric family, demonstrating the Metric extension surface the
reference's ABC sketches (/root/reference/metrics.py:682-728): RN is
spherically symmetric, so it plugs into EVERY spherically-symmetric
code path — orbit-equation tracer (XLA + Pallas tiles), shadow,
lensing, AA/adaptive, trajectory plots — by overriding the closed
forms and the reduced orbit equation only.

Physics (geometrized units, charge Q in units of M):
    f(r)   = 1 - 2M/r + Q^2/r^2
    r_+/-  = M +- sqrt(M^2 - Q^2)          (outer/inner horizon)
    r_ph   = (3M + sqrt(9M^2 - 8Q^2)) / 2  (photon sphere)
    b_crit = r_ph / sqrt(f(r_ph))          (critical impact parameter)
    orbit equation: u'' = -u + 3 M u^2 - 2 Q^2 u^3
    (du/dphi)^2    = 1/b^2 - u^2 f(1/u)
                   = 1/b^2 - u^2 + 2 M u^3 - Q^2 u^4

Charge SHRINKS the shadow: r_ph drops from 3M (Q=0) to 2M (extremal
Q=M), b_crit from 3*sqrt(3) M ~ 5.196M to 4M. Q > M (naked
singularity) is rejected, matching the reference's |a| > M guard
pattern (metrics.py:849-850).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from light_path_tracer_tpu.models.schwarzschild import Schwarzschild


@dataclasses.dataclass(frozen=True)
class ReissnerNordstrom(Schwarzschild):
    Q: float = 0.0

    def __post_init__(self):
        if abs(self.Q) > self.M:
            raise ValueError(
                f"|Q| must be <= M (naked singularity): Q={self.Q}, "
                f"M={self.M}")

    # ---- closed-form geometry overrides ----

    @property
    def R_S(self) -> float:
        """Outer horizon r_+ = M + sqrt(M^2 - Q^2) (the capture and
        near-horizon guards key off this, as the reference's do off
        2M)."""
        # Plain Python float: np.float64 scalars are not weakly typed
        # in JAX and would promote f32 pipelines to f64.
        return float(self.M + np.sqrt(max(self.M ** 2 - self.Q ** 2,
                                          0.0)))

    @property
    def R_PHOTON(self) -> float:
        return float(0.5 * (3.0 * self.M + np.sqrt(
            9.0 * self.M ** 2 - 8.0 * self.Q ** 2)))

    @property
    def B_CRIT(self) -> float:
        r_ph = self.R_PHOTON
        return float(r_ph / np.sqrt(self.f(r_ph)))

    def f(self, r):
        """Metric function f(r) = 1 - 2M/r + Q^2/r^2."""
        return 1.0 - 2.0 * self.M / r + (self.Q / r) * (self.Q / r)

    # ---- batched orbit-equation fast path ----

    def orbit_rhs(self, u, w):
        """(u', w') = (w, -u + 3 M u^2 - 2 Q^2 u^3)."""
        return w, (-u + 3.0 * self.M * u * u
                   - 2.0 * self.Q * self.Q * u * u * u)

    def orbit_initial_state(self, r_obs, alphas):
        """Initial (u, w): w0^2 = 1/b^2 - u^2 + 2 M u^3 - Q^2 u^4."""
        dtype = alphas.dtype
        f0 = float(self.f(r_obs))
        M = jnp.asarray(self.M, dtype)
        Q2 = jnp.asarray(self.Q * self.Q, dtype)
        b = r_obs * jnp.sin(alphas) / float(np.sqrt(max(f0, 1e-300)))
        u0 = jnp.full_like(alphas, 1.0 / r_obs)
        b_safe = jnp.where(b == 0.0, 1.0, b)
        w0_sq = (1.0 / (b_safe * b_safe) - u0 * u0
                 + 2.0 * M * u0 ** 3 - Q2 * u0 ** 4)
        invalid = (b == 0.0) | (w0_sq < 0.0) | (f0 <= 0.0)
        # Outward branch for backward-looking rays (panorama chart);
        # see Schwarzschild.orbit_initial_state.
        one = jnp.asarray(1.0, alphas.dtype)   # dtype-pinned: weak
        # where-branches broadcast to default dtype (f64 under x64).
        w0 = jnp.where(jnp.cos(alphas) >= 0.0, one, -one) * jnp.sqrt(
            jnp.maximum(w0_sq, 0.0))
        return u0, w0, invalid

    # ---- full 8-D Hamiltonian path ----

    def geodesic_equations(self, lam, state8):
        """Hamilton's equations with f(r) = 1 - 2M/r + Q^2/r^2.

        Same structure as the Schwarzschild body with
        f'/2 = M/r^2 - Q^2/r^3 replacing R_S/(2 r^2)."""
        t, r, th, phi, p_t, p_r, p_th, p_phi = jnp.moveaxis(
            state8, -1, 0)
        horizon = self.R_S
        M = self.M
        Q2 = self.Q * self.Q
        frozen = r <= horizon * 1.001

        r_safe = jnp.where(frozen, 10.0 * horizon, r)
        f = 1.0 - 2.0 * M / r_safe + Q2 / (r_safe * r_safe)
        sin_th = jnp.sin(th)
        cos_th = jnp.cos(th)
        sin2 = jnp.maximum(sin_th * sin_th, 1e-15)
        r2 = r_safe * r_safe
        r3 = r2 * r_safe
        half_fp = M / r2 - Q2 / r3          # f'(r) / 2

        dt = -p_t / f
        dr = f * p_r
        dth = p_th / r2
        dphi = p_phi / (r2 * sin2)
        dp_r = (-half_fp * (p_t * p_t) / (f * f)
                - half_fp * p_r * p_r
                + (p_th * p_th + p_phi * p_phi / sin2) / r3)
        dp_th = cos_th * p_phi * p_phi / (r2 * sin2 * jnp.sqrt(sin2))
        zeros = jnp.zeros_like(r)

        out = jnp.stack(
            [dt, dr, dth, dphi, zeros, dp_r, dp_th, zeros], axis=-1)
        return jnp.where(frozen[..., None], 0.0, out)
