"""Schwarzschild metric: non-rotating black hole of mass M.

Physics parity with /root/reference/metrics.py:735-833:
  * closed forms: R_S = 2M, photon sphere 3M, B_CRIT = 3*sqrt(3)*M
    (metrics.py:740-744), alpha_crit = arcsin(B_CRIT*sqrt(f)/r)
    (metrics.py:753-755), alpha <-> b conversion (metrics.py:757-759).
  * fast path: the reduced 2-D orbit equation u'' = -u + 3 M u^2 in phi
    (metrics.py:44-47), with initial w^2 = 1/b^2 - u^2 + 2 M u^3
    (metrics.py:60), and final-angle extraction via the escape heading
    (metrics.py:120-145).
  * slow path: full 8-D Hamiltonian RHS (metrics.py:763-790) and 8-D
    initial conditions (metrics.py:794-809).

Array re-design: every function below is batched structure-of-arrays
jnp code; the integration loop lives in `ops/` (one XLA program over the
entire pixel grid), not here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from light_path_tracer_tpu.models.base import Metric

_SIN2_FLOOR = 1e-15


@dataclasses.dataclass(frozen=True)
class Schwarzschild(Metric):
    M: float = 1.0

    is_spherically_symmetric: bool = dataclasses.field(
        default=True, init=False, repr=False)

    # ---- host-side scalar geometry (config-time, float64 numpy) ----

    @property
    def R_S(self) -> float:
        return 2.0 * self.M

    @property
    def R_PHOTON(self) -> float:
        return 3.0 * self.M

    @property
    def B_CRIT(self) -> float:
        return 3.0 * np.sqrt(3.0) * self.M

    def f(self, r):
        """Metric function f(r) = 1 - R_S / r."""
        return 1.0 - self.R_S / r

    def capture_radius(self) -> float:
        return self.R_S * 1.01

    def alpha_crit(self, r_obs, theta_obs=None) -> float:
        arg = self.B_CRIT * np.sqrt(self.f(r_obs)) / r_obs
        return float(np.arcsin(np.clip(arg, -1.0, 1.0)))

    def viewing_angle_to_impact_parameter(self, alpha, r_obs,
                                          theta_obs=None):
        return r_obs * np.sin(alpha) / np.sqrt(self.f(r_obs))

    # ---- batched orbit-equation fast path (jnp) ----

    def orbit_rhs(self, u, w):
        """RHS of the photon orbit equation: (u', w') = (w, -u + 3 M u^2)."""
        return w, -u + 3.0 * self.M * u * u

    def orbit_initial_state(self, r_obs, alphas):
        """Initial (u, w) for the orbit equation, batched over alphas.

        Returns (u0, w0, invalid): invalid lanes have no real trajectory
        (b == 0, w0^2 < 0, or observer inside the horizon), matching the
        reference's status-0 guards (metrics.py:52-63).
        """
        dtype = alphas.dtype
        f0 = float(self.f(r_obs))
        M = jnp.asarray(self.M, dtype)
        b = r_obs * jnp.sin(alphas) / float(np.sqrt(max(f0, 1e-300)))
        u0 = jnp.full_like(alphas, 1.0 / r_obs)
        b_safe = jnp.where(b == 0.0, 1.0, b)
        w0_sq = 1.0 / (b_safe * b_safe) - u0 * u0 + 2.0 * M * u0 * u0 * u0
        invalid = (b == 0.0) | (w0_sq < 0.0) | (f0 <= 0.0)
        # Radial branch: the reference only ever traces forward-looking
        # rays (alpha <= pi/2, within a pinhole FOV) and hard-codes the
        # inward root (metrics.py:52-63). Backward rays (the panorama
        # chart's alpha > pi/2 hemisphere) start moving OUTWARD, i.e.
        # du/dphi < 0. sign(cos alpha) selects the branch; bitwise
        # unchanged for every alpha < pi/2 path.
        one = jnp.asarray(1.0, alphas.dtype)   # dtype-pinned: weak
        # where-branches broadcast to default dtype (f64 under x64).
        w0 = jnp.where(jnp.cos(alphas) >= 0.0, one, -one) * jnp.sqrt(
            jnp.maximum(w0_sq, 0.0))
        return u0, w0, invalid

    def orbit_extract_angle(self, phi, u, w):
        """Final viewing angle + winding from the escaped orbit state.

        Parity: escape-heading construction of metrics.py:132-145.
        Returns (final_alpha, n_half_orbits, captured_by_radius).
        """
        r_f = 1.0 / jnp.maximum(u, 1e-300)
        n_half = jnp.floor(jnp.abs(phi) / np.pi).astype(jnp.int32)
        captured_by_radius = r_f <= self.R_S * 1.1

        dr_dphi = -w / jnp.maximum(u * u, 1e-300)
        sin_phi = jnp.sin(phi)
        cos_phi = jnp.cos(phi)
        heading = jnp.arctan2(
            dr_dphi * sin_phi + r_f * cos_phi,
            dr_dphi * cos_phi - r_f * sin_phi,
        )
        final_alpha = jnp.arccos(jnp.clip(-jnp.cos(heading), -1.0, 1.0))
        return final_alpha, n_half, captured_by_radius

    # ---- full 8-D Hamiltonian path (jnp, batched) ----

    def geodesic_equations(self, lam, state8):
        """Hamilton's equations on [t, r, th, phi, p_t, p_r, p_th, p_phi].

        Parity: metrics.py:763-790 (with the same inside-horizon hard-zero
        and sin^2(theta) floor).
        """
        t, r, th, phi, p_t, p_r, p_th, p_phi = jnp.moveaxis(state8, -1, 0)
        R_S = self.R_S
        frozen = r <= R_S * 1.001

        r_safe = jnp.where(frozen, 10.0 * R_S, r)
        f = 1.0 - R_S / r_safe
        sin_th = jnp.sin(th)
        cos_th = jnp.cos(th)
        sin2 = jnp.maximum(sin_th * sin_th, _SIN2_FLOOR)
        r2 = r_safe * r_safe
        r3 = r2 * r_safe

        dt = -p_t / f
        dr = f * p_r
        dth = p_th / r2
        dphi = p_phi / (r2 * sin2)
        dp_r = (-(R_S / (2.0 * r2)) * (p_t * p_t) / (f * f)
                - (R_S / (2.0 * r2)) * p_r * p_r
                + (p_th * p_th + p_phi * p_phi / sin2) / r3)
        dp_th = cos_th * p_phi * p_phi / (r2 * sin2 * jnp.sqrt(sin2))
        zeros = jnp.zeros_like(r)

        out = jnp.stack(
            [dt, dr, dth, dphi, zeros, dp_r, dp_th, zeros], axis=-1)
        return jnp.where(frozen[..., None], 0.0, out)

    def initial_conditions_8d(self, r_obs, alpha, theta=0.0, theta_obs=None):
        """Batched 8-D initial state; equatorial launch (metrics.py:794-809).

        Returns (state8, invalid_mask).
        """
        alpha = jnp.asarray(alpha)
        f0 = float(self.f(r_obs))
        E = 1.0
        b = r_obs * jnp.sin(alpha) / float(np.sqrt(max(f0, 1e-300)))
        L = b * E
        p_r_sq = (E * E / f0 - L * L / (r_obs * r_obs)) / f0
        invalid = p_r_sq < 0.0
        p_r = -jnp.sqrt(jnp.maximum(p_r_sq, 0.0))

        zeros = jnp.zeros_like(alpha)
        state8 = jnp.stack([
            zeros,
            jnp.full_like(alpha, r_obs),
            jnp.full_like(alpha, np.pi / 2),
            zeros,
            jnp.full_like(alpha, -E),
            p_r,
            zeros,
            L,
        ], axis=-1)
        return state8, invalid
