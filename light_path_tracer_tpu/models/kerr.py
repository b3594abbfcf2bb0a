"""Kerr metric in Boyer-Lindquist coordinates: spinning BH, |a| <= M.

Physics parity with /root/reference/metrics.py:840-1133:
  * outer horizon r_+ = M + sqrt(M^2 - a^2) (metrics.py:853).
  * Bardeen unstable photon-orbit radii and critical impact parameters
    (xi, eta) (metrics.py:866-891); shadow-envelope alpha_crit by sampling
    b^2 over spherical photon orbits with the Schwarzschild floor
    (metrics.py:893-930).
  * alpha <-> b conversion with A = (r^2+a^2)^2 - a^2 Delta sin^2(theta)
    (metrics.py:932-942).
  * screen -> conserved-quantity initial conditions (Bardeen celestial
    coordinates; covariant convention p_t = -E, the documented footgun at
    metrics.py:1076-1079), p_theta from the Carter constant, p_r from the
    null condition (metrics.py:148-218).
  * Hamilton's equations on the reduced 5-D state [r, theta, phi, p_r,
    p_theta] with analytic d/dr and d/dtheta of the five inverse-metric
    components, hard-zeroed inside r <= 1.001 r_+ (metrics.py:221-303).
  * final-angle extraction through the coordinate-velocity chain rule
    (metrics.py:363-416).

Array re-design: all hot-path functions are batched jnp over N rays
(structure-of-arrays tuples), ready for `vmap`-free direct array evaluation
inside `lax.while_loop` integrators and Pallas kernels. A correctness
oracle cross-checks the analytic RHS against a complex-step derivative of
the super-Hamiltonian
(tests/test_metrics_math.py::test_kerr_rhs_vs_complex_step), and the
rational mu-form against the theta-form by chain rule
(tests/test_metrics_math.py).

Two algebraically equivalent formulations of the polar coordinate exist:
  * theta-form (`rhs5`): state [r, theta, phi, p_r, p_theta] — the
    reference-parity surface (metrics.py:221-303), used by the 8-D public
    path and the fixed-step comparison tracer. Costs sin/cos per
    evaluation.
  * mu-form (`rhs5_mu`): state [r, mu=cos(theta), phi, p_r, p_mu] — every
    inverse-metric component is a *rational* function of (r, mu), so the
    hot loop runs with ZERO transcendentals, but it needs a theta-form
    retrace of pole-approaching lanes (trace_rays_kerr_hybrid) and takes
    more steps in the near-pole band — so theta is the default and mu is
    the opt-in formulation (its cost on the GPU is not measured).
    Conversion
    at entry/exit: p_mu = -p_theta / sin(theta).

The batched hot-path surface lives in `_KerrHotPath`, shared by two
front-ends: the frozen `Kerr` dataclass (hashable — parameters fold into
compiled constants) and `TracedKerr` (parameters as traced jnp scalars for
recompilation-free spin/mass sweeps).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu.models.base import Metric

_SIN2_FLOOR = 1e-15


def _inverse_metric_terms(M, a, r, th):
    """The five nonzero contravariant Kerr metric components (batched).

    Returns (g^tt, g^tphi, g^rr, g^thth, g^phiphi) plus the shared
    intermediates (Sigma, Delta, A, sin_th, cos_th, sin2).
    """
    sin_th = jnp.sin(th)
    cos_th = jnp.cos(th)
    sin2 = jnp.maximum(sin_th * sin_th, _SIN2_FLOOR)
    r2 = r * r
    a2 = a * a
    Sigma = r2 + a2 * cos_th * cos_th
    Delta = r2 - 2.0 * M * r + a2
    ra2 = r2 + a2
    A = ra2 * ra2 - a2 * Delta * sin2
    SD = Sigma * Delta
    g_tt = -A / SD
    g_tphi = -2.0 * M * a * r / SD
    g_rr = Delta / Sigma
    g_thth = 1.0 / Sigma
    g_phiphi = (Delta - a2 * sin2) / (SD * sin2)
    return (g_tt, g_tphi, g_rr, g_thth, g_phiphi,
            Sigma, Delta, A, sin_th, cos_th, sin2)


class _KerrHotPath:
    """Batched Kerr hot-path surface, shared by `Kerr` and `TracedKerr`.

    Every method here touches the metric parameters only through
    `self.M` / `self.a` / `self.r_plus` via jnp ops, so the same bodies
    serve both the static (Python-float, constant-folded) and traced
    (jnp-scalar) front-ends.
    """

    # ---- scalars usable from both front-ends ----

    def capture_radius(self):
        return self.r_plus * 1.01

    def _freeze_radius(self):
        """Radius at/below which the RHS is hard-zeroed (reference
        parity: metrics.py:246 zeroes inside 1.001 r_+). Families whose
        pathological region extends OUTSIDE the Kerr horizon override
        this (JohannsenPsaltis: just inside its numeric barrier-aware
        capture surface)."""
        return self.r_plus * 1.001

    # Metric-function hooks: Kerr-Newman overrides these (charge
    # enters ONLY through Delta and the 2Mr -> 2Mr - Q^2 = r^2 + a^2
    # - Delta combination, which the bodies below express via Delta).
    @property
    def _q2(self) -> float:
        """Squared charge Q^2, a STATIC Python float (0 for Kerr) so the
        charge branches in rhs5/rhs5_mu compile out entirely — the Kerr
        hot path stays bitwise-identical to the pre-Kerr-Newman code."""
        return 0.0

    def _Delta_b(self, r):
        """Batched Delta(r) = r^2 - 2 M r + a^2."""
        return r * r - 2.0 * self.M * r + self.a * self.a

    def _inv_terms(self, r, th):
        return _inverse_metric_terms(self.M, self.a, r, th)

    def _two_M_r(self, r):
        """The g_tphi numerator factor: 2 M r (Kerr-Newman subtracts
        Q^2). Kept as a hook so the Kerr fast path stays bitwise
        identical (the algebraically-equal r^2 + a^2 - Delta form
        differs at roundoff)."""
        return 2.0 * self.M * r

    def rhs5_autodiff(self, state5, p_t, p_phi):
        """Batched reduced-state RHS from jax.grad of the Hamiltonian
        H = (1/2) g^{mu nu}(r, theta) p_mu p_nu — generic over the
        `_inv_terms` hook, so it serves BOTH roles:

        * the independent roundoff-level oracle for the hand-derived
          `rhs5` (Kerr / Kerr-Newman, tests/test_kerr_newman.py), and
        * the PRIMARY integrator RHS for metric families with no
          hand form — any stationary axisymmetric metric is fully
          specified by its five `_inv_terms` components; the reduced
          5-D state needs only the two Killing symmetries (t, phi
          cyclic), NOT Carter separability (Johannsen-Psaltis).

        H is elementwise over the ray axis, so grad of sum(H) gives
        the exact per-ray partials; dphi comes from the momentum
        partials directly. Same frozen-horizon guard as rhs5.
        """
        r, th, phi, p_r, p_th = state5
        dtype = r.dtype
        r_freeze = jnp.asarray(self._freeze_radius(), dtype)
        frozen = r <= r_freeze
        r_s = jnp.where(frozen, 10.0 * r_freeze + 10.0, r)
        p_t_b = jnp.broadcast_to(jnp.asarray(p_t, dtype), r.shape)
        p_phi_b = jnp.broadcast_to(jnp.asarray(p_phi, dtype), r.shape)

        def H_sum(r_, th_, pr_, pth_):
            (g_tt, g_tphi, g_rr, g_thth, g_phiphi,
             *_rest) = self._inv_terms(r_, th_)
            return 0.5 * jnp.sum(
                g_tt * p_t_b * p_t_b
                + 2.0 * g_tphi * p_t_b * p_phi_b
                + g_rr * pr_ * pr_
                + g_thth * pth_ * pth_
                + g_phiphi * p_phi_b * p_phi_b)

        dHr, dHth, dHpr, dHpth = jax.grad(
            H_sum, argnums=(0, 1, 2, 3))(r_s, th, p_r, p_th)
        (g_tt, g_tphi, _g_rr, _g_thth, g_phiphi,
         *_rest) = self._inv_terms(r_s, th)
        dphi = g_tphi * p_t_b + g_phiphi * p_phi_b

        keep = jnp.logical_not(frozen)
        z = jnp.zeros_like(r)
        return (jnp.where(keep, dHpr, z), jnp.where(keep, dHpth, z),
                jnp.where(keep, dphi, z), jnp.where(keep, -dHr, z),
                jnp.where(keep, -dHth, z))

    def tdot(self, state5, p_t, p_phi):
        """Coordinate-time rate dt/dlambda = dH/dp_t along the reduced
        flow: g^tt p_t + g^tphi p_phi — the t-row of the full 8-D
        Hamiltonian system (reference metrics.py:946-1029) that the
        reduced 5-D state drops. Used by the opt-in crossing-time
        recorder (ops/kerr_trace.py record_time): t itself never feeds
        back into the dynamics, so it can be accumulated OUTSIDE the
        error-controlled state. Charged metrics inherit via the
        _inv_terms hook."""
        r, th = state5[0], state5[1]
        g_tt, g_tphi, *_rest = self._inv_terms(r, th)
        return g_tt * p_t + g_tphi * p_phi

    def plunge_radii(self, r_obs, alphas, thetas, theta_obs):
        """Per-ray certain-capture radius for early termination.

        A photon arriving from large r whose radial turning point would
        have to lie inside the photon-orbit band cannot escape: every
        spherical photon orbit satisfies r >= r_prograde, so crossing
        r < r_prograde inbound is a guaranteed plunge — integration can
        stop there instead of grinding through the shrinking steps down
        to 1.01 r_+. Vortical rays (eta < 0, only possible off the
        equatorial observer plane) are excluded (radius 0 disables).
        This is purely an optimization: outcome classification is
        unchanged, only the parked state of captured rays differs.
        """
        dtype = alphas.dtype
        M = jnp.asarray(self.M, dtype)
        a = jnp.asarray(self.a, dtype)
        th = jnp.asarray(theta_obs, dtype)
        sin_th, cos_th = jnp.sin(th), jnp.cos(th)
        r = jnp.asarray(r_obs, dtype)
        Sigma = r * r + a * a * cos_th * cos_th
        Delta = r * r - 2.0 * M * r + a * a
        rho = r * jnp.sin(alphas) * jnp.sqrt(Sigma) / jnp.sqrt(
            jnp.maximum(Delta, 1e-30))
        alpha_s = -rho * jnp.sin(thetas)
        beta_s = -rho * jnp.cos(thetas)
        eta = (beta_s * beta_s
               + cos_th * cos_th * (alpha_s * alpha_s - a * a))
        # Bardeen prograde photon-orbit radius (continuous at a = 0,
        # where both branches give 3M; traced-safe via clip).
        ratio = jnp.clip(-a / jnp.maximum(M, 1e-30), -1.0, 1.0)
        r_pro = 2.0 * M * (1.0 + jnp.cos(2.0 / 3.0 * jnp.arccos(ratio)))
        return jnp.where(eta >= 0.0, 0.999 * r_pro, 0.0).astype(dtype)

    def pole_risk(self, r_obs, alphas, thetas, theta_obs,
                  s_thresh=1e-4):
        """Per-ray mask: will this ray approach the BL polar axis?

        The polar potential Theta(mu) = Q - mu^2 (L^2/sin^2 - a^2 E^2)
        turns at sin^2(theta)_min ~= L^2 / (Q + a^2 E^2): rays with small
        conserved L pass arbitrarily close to the axis, where p_mu
        diverges like 1/sin(theta) — the one place the rational mu-form
        (module docstring) is ill-conditioned. The hybrid tracer
        (ops/batch.trace_rays_kerr_hybrid) re-traces these few lanes
        (typically the one screen column aimed over the pole) in the
        theta form. Vortical rays (Q < 0) are flagged too — they hover
        near the axis by construction.
        """
        dtype = alphas.dtype
        M = jnp.asarray(self.M, dtype)
        a = jnp.asarray(self.a, dtype)
        th = jnp.asarray(theta_obs, dtype)
        sin_th, cos_th = jnp.sin(th), jnp.cos(th)
        r = jnp.asarray(r_obs, dtype)
        Sigma = r * r + a * a * cos_th * cos_th
        Delta = r * r - 2.0 * M * r + a * a
        rho = r * jnp.sin(alphas) * jnp.sqrt(Sigma) / jnp.sqrt(
            jnp.maximum(Delta, 1e-30))
        alpha_s = -rho * jnp.sin(thetas)
        beta_s = -rho * jnp.cos(thetas)
        L = -alpha_s * sin_th
        Q = (beta_s * beta_s
             + cos_th * cos_th * (alpha_s * alpha_s - a * a))
        L2 = L * L
        denom = jnp.maximum(Q + a * a + L2, 1e-30)
        return (Q <= 0.0) | (L2 < s_thresh * denom)

    # ---- batched 5-D hot path (jnp, structure-of-arrays) ----

    def initial_conditions_5d(self, r_obs, alphas, thetas, theta_obs):
        """Screen angles -> reduced 5-D state + conserved momenta, batched.

        Parity: metrics.py:148-218. alphas/thetas are (N,) screen viewing
        angle / azimuth; theta_obs is the scalar observer inclination.
        Returns ((r, th, phi, p_r, p_th), p_t, p_phi, invalid).
        """
        dtype = alphas.dtype
        M = jnp.asarray(self.M, dtype)
        a = jnp.asarray(self.a, dtype)

        r = jnp.asarray(r_obs, dtype)
        th = jnp.asarray(theta_obs, dtype)
        sin_th = jnp.sin(th)
        cos_th = jnp.cos(th)
        sin2 = jnp.maximum(sin_th * sin_th, _SIN2_FLOOR)

        Sigma = r * r + a * a * cos_th * cos_th
        Delta = self._Delta_b(r)
        bad_obs = (Delta <= 0.0) | (Sigma <= 0.0)

        E = jnp.asarray(1.0, dtype)
        rho = r * jnp.sin(alphas) * jnp.sqrt(Sigma) / jnp.sqrt(
            jnp.where(bad_obs, 1.0, Delta))

        sin_screen = jnp.sin(thetas)
        cos_screen = jnp.cos(thetas)
        alpha_screen = -rho * sin_screen
        beta_screen = -rho * cos_screen

        xi = -alpha_screen * sin_th
        eta = (beta_screen * beta_screen
               + cos_th * cos_th * (alpha_screen * alpha_screen - a * a))
        L = xi * E
        Q = eta * E * E

        # Covariant canonical momentum convention: p_t = -E (E > 0 for
        # future-directed null geodesics); must match the Hamiltonian flow.
        # Written as a constant, not -E: the Pallas Triton route cannot
        # negate a folded literal.
        p_t = jnp.asarray(-1.0, dtype)
        p_phi = L

        Theta = jnp.maximum(
            Q - cos_th * cos_th * (L * L / sin2 - a * a * E * E), 0.0)
        # dtype-pinned sign constants: weak-float where-branches
        # broadcast to a DEFAULT-dtype array (float64 under x64) before
        # the astype, which would put float64 ops into the f32 kernel
        # traced in an x64-enabled process.
        one = jnp.asarray(1.0, dtype)
        minus_one = jnp.asarray(-1.0, dtype)
        p_th_sign = jnp.where(cos_screen > 0.0, minus_one, one)
        p_th = p_th_sign * jnp.sqrt(Theta)

        (g_tt, g_tphi, g_rr, g_thth, g_phiphi,
         *_rest) = self._inv_terms(r, th)
        other = (g_tt * p_t * p_t
                 + 2.0 * g_tphi * p_t * p_phi
                 + g_thth * p_th * p_th
                 + g_phiphi * p_phi * p_phi)
        p_r_sq = -other / g_rr
        # Radial branch: the Bardeen screen construction folds alpha and
        # pi - alpha together (rho ~ sin alpha, metrics.py:148-218) — the
        # reference's inward root is correct only for the forward-looking
        # pinhole FOV. Backward rays (panorama chart) start outward:
        # p^r = g^rr p_r > 0. Bitwise unchanged for alpha <= pi/2.
        p_r = jnp.where(jnp.cos(alphas) >= 0.0, minus_one, one) * jnp.sqrt(
            jnp.maximum(p_r_sq, 0.0))

        invalid = jnp.broadcast_to(bad_obs, alphas.shape)
        r0 = jnp.broadcast_to(r, alphas.shape)
        th0 = jnp.broadcast_to(th, alphas.shape)
        phi0 = jnp.zeros_like(alphas)
        p_t_b = jnp.broadcast_to(p_t, alphas.shape)
        return (r0, th0, phi0, p_r, p_th), p_t_b, p_phi, invalid

    # ---- polar-coordinate formulation converters ----

    @staticmethod
    def state_to_mu(y):
        """(r, theta, phi, p_r, p_theta) -> (r, mu, phi, p_r, p_mu).

        mu = cos(theta); p_mu = p_theta * dtheta/dmu = -p_theta/sin(theta)
        (exact canonical point transformation — same geodesics).
        """
        r, th, phi, p_r, p_th = y
        sin_th = jnp.sin(th)
        mu = jnp.cos(th)
        sin_safe = jnp.maximum(sin_th, jnp.asarray(
            np.sqrt(_SIN2_FLOOR), r.dtype))
        return (r, mu, phi, p_r, -p_th / sin_safe)

    @staticmethod
    def state_from_mu(y):
        """(r, mu, phi, p_r, p_mu) -> (r, theta, phi, p_r, p_theta)."""
        r, mu, phi, p_r, p_mu = y
        mu_c = jnp.clip(mu, -1.0, 1.0)
        th = jnp.arccos(mu_c)
        # (1-mu)(1+mu) is better conditioned than 1-mu^2 near the poles.
        sin_th = jnp.sqrt(jnp.maximum(
            (1.0 - mu_c) * (1.0 + mu_c), _SIN2_FLOOR))
        return (r, th, phi, p_r, -sin_th * p_mu)

    def rhs5(self, state5, p_t, p_phi):
        """Hamilton's equations on the reduced 5-D theta-state, batched.

        Parity: metrics.py:221-303 — analytic d/dr and d/dtheta of the
        inverse-metric components; RHS hard-zeroed inside r <= 1.001 r_+.
        state5 = (r, th, phi, p_r, p_th) tuple of (N,) arrays.

        Divide-light form: the naive expression uses ~10 divides per
        evaluation (divides cost many cycles); this form computes three reciprocals (1/Sigma, 1/Delta, 1/sin^2) once
        and expresses every quotient as products of them — algebraically
        identical, ~equal rounding (divides replaced by reciprocal+mul).
        This is the parity/oracle surface; production integration runs
        the transcendental-free `rhs5_mu`.
        """
        r, th, phi, p_r, p_th = state5
        dtype = r.dtype
        M = jnp.asarray(self.M, dtype)
        a = jnp.asarray(self.a, dtype)
        r_plus = jnp.asarray(self.r_plus, dtype)

        frozen = r <= r_plus * 1.001
        r_s = jnp.where(frozen, 10.0 * r_plus + 10.0, r)

        sin_th = jnp.sin(th)
        cos_th = jnp.cos(th)
        sin2 = jnp.maximum(sin_th * sin_th, _SIN2_FLOOR)
        a2 = a * a
        r2 = r_s * r_s
        Sigma = r2 + a2 * cos_th * cos_th
        Delta = r2 - 2.0 * M * r_s + a2
        if self._q2:
            Delta = Delta + self._q2           # Kerr-Newman
        ra2 = r2 + a2
        A = ra2 * ra2 - a2 * Delta * sin2

        inv_Sigma = 1.0 / Sigma
        inv_Delta = 1.0 / Delta
        inv_sin2 = 1.0 / sin2
        inv_SD = inv_Sigma * inv_Delta
        inv_SD2 = inv_SD * inv_SD
        inv_S2 = inv_Sigma * inv_Sigma

        g_rr = Delta * inv_Sigma
        g_thth = inv_Sigma
        if self._q2:
            # g_tphi numerator: W = 2Mr - Q^2 (identically r^2+a^2-Delta,
            # but this form keeps the Kerr-limit rounding behavior).
            W = 2.0 * M * r_s - self._q2
            g_tphi = -(a * W * inv_SD)
        else:
            g_tphi = -2.0 * M * a * r_s * inv_SD
        g_phiphi = (Delta - a2 * sin2) * inv_SD * inv_sin2

        dr = g_rr * p_r
        dth = g_thth * p_th
        dphi = g_tphi * p_t + g_phiphi * p_phi

        # -- radial derivatives of the inverse metric --
        SD = Sigma * Delta
        dSigma_dr = 2.0 * r_s
        dDelta_dr = 2.0 * r_s - 2.0 * M
        dA_dr = 4.0 * r_s * ra2 - a2 * dDelta_dr * sin2
        dSD_dr = dSigma_dr * Delta + Sigma * dDelta_dr

        dg_tt_dr = -(dA_dr * SD - A * dSD_dr) * inv_SD2
        if self._q2:
            # d/dr of -aW/(Sigma Delta) with dW/dr = 2M.
            dg_tphi_dr = -(a * (2.0 * M * SD - W * dSD_dr) * inv_SD2)
        else:
            dg_tphi_dr = -(2.0 * M * a * (SD - r_s * dSD_dr)) * inv_SD2
        dg_rr_dr = (dDelta_dr * Sigma - Delta * dSigma_dr) * inv_S2
        dg_thth_dr = -dSigma_dr * inv_S2
        inv_den_phi = inv_SD * inv_sin2
        inv_den_phi2 = inv_den_phi * inv_den_phi
        den_phi = SD * sin2
        dg_phiphi_dr = (dDelta_dr * den_phi
                        - (Delta - a2 * sin2) * dSD_dr * sin2) * inv_den_phi2

        dp_r = -0.5 * (dg_tt_dr * p_t * p_t
                       + 2.0 * dg_tphi_dr * p_t * p_phi
                       + dg_rr_dr * p_r * p_r
                       + dg_thth_dr * p_th * p_th
                       + dg_phiphi_dr * p_phi * p_phi)

        # -- polar derivatives of the inverse metric --
        sc = sin_th * cos_th
        dSigma_dth = -2.0 * a2 * sc
        dA_dth = -2.0 * a2 * Delta * sc

        dg_tt_dth = -(dA_dth * SD - A * dSigma_dth * Delta) * inv_SD2
        if self._q2:
            dg_tphi_dth = a * W * dSigma_dth * inv_S2 * inv_Delta
        else:
            dg_tphi_dth = (2.0 * M * a * r_s * dSigma_dth) \
                * inv_S2 * inv_Delta
        dg_rr_dth = -Delta * dSigma_dth * inv_S2
        dg_thth_dth = -dSigma_dth * inv_S2

        num = Delta - a2 * sin2
        dnum_dth = -2.0 * a2 * sc
        dden_dth = dSigma_dth * Delta * sin2 + 2.0 * SD * sc
        dg_phiphi_dth = (dnum_dth * den_phi
                         - num * dden_dth) * inv_den_phi2

        dp_th = -0.5 * (dg_tt_dth * p_t * p_t
                        + 2.0 * dg_tphi_dth * p_t * p_phi
                        + dg_rr_dth * p_r * p_r
                        + dg_thth_dth * p_th * p_th
                        + dg_phiphi_dth * p_phi * p_phi)

        keep = jnp.logical_not(frozen)
        z = jnp.zeros_like(r)
        return (jnp.where(keep, dr, z), jnp.where(keep, dth, z),
                jnp.where(keep, dphi, z), jnp.where(keep, dp_r, z),
                jnp.where(keep, dp_th, z))

    def rhs5_mu(self, state5, p_t, p_phi):
        """Hamilton's equations on the reduced 5-D mu-state, batched.

        state5 = (r, mu, phi, p_r, p_mu) with mu = cos(theta). Exactly the
        same Hamiltonian as `rhs5` after the canonical transformation
        theta -> mu (g^mumu = sin^2/Sigma, sin^2 = (1-mu)(1+mu)), so every
        component is a rational function of (r, mu): ZERO transcendentals
        in the hot loop (module docstring). RHS hard-zeroed inside r <= 1.001 r_+ like rhs5.
        """
        r, mu, phi, p_r, p_mu = state5
        dtype = r.dtype
        M = jnp.asarray(self.M, dtype)
        a = jnp.asarray(self.a, dtype)
        r_plus = jnp.asarray(self.r_plus, dtype)

        frozen = r <= r_plus * 1.001
        r_s = jnp.where(frozen, 10.0 * r_plus + 10.0, r)

        a2 = a * a
        r2 = r_s * r_s
        # (1-mu)(1+mu) stays accurate near the poles where 1-mu^2 cancels.
        s = jnp.maximum((1.0 - mu) * (1.0 + mu), _SIN2_FLOOR)
        Sigma = r2 + a2 * mu * mu
        Delta = r2 - 2.0 * M * r_s + a2
        if self._q2:
            Delta = Delta + self._q2           # Kerr-Newman
        ra2 = r2 + a2
        A = ra2 * ra2 - a2 * Delta * s

        inv_Sigma = 1.0 / Sigma
        inv_Delta = 1.0 / Delta
        inv_s = 1.0 / s
        inv_SD = inv_Sigma * inv_Delta
        inv_SD2 = inv_SD * inv_SD
        inv_S2 = inv_Sigma * inv_Sigma

        g_rr = Delta * inv_Sigma
        g_mumu = s * inv_Sigma
        if self._q2:
            # g_tphi numerator: W = 2Mr - Q^2 (identically r^2+a^2-Delta,
            # but this form keeps the Kerr-limit rounding behavior).
            W = 2.0 * M * r_s - self._q2
            g_tphi = -(a * W * inv_SD)
        else:
            g_tphi = -2.0 * M * a * r_s * inv_SD
        g_phiphi = (Delta - a2 * s) * inv_SD * inv_s

        dr = g_rr * p_r
        dmu = g_mumu * p_mu
        dphi = g_tphi * p_t + g_phiphi * p_phi

        # -- radial derivatives (s is independent of r) --
        SD = Sigma * Delta
        dSigma_dr = 2.0 * r_s
        dDelta_dr = 2.0 * r_s - 2.0 * M
        dA_dr = 4.0 * r_s * ra2 - a2 * dDelta_dr * s
        dSD_dr = dSigma_dr * Delta + Sigma * dDelta_dr

        dg_tt_dr = -(dA_dr * SD - A * dSD_dr) * inv_SD2
        if self._q2:
            # d/dr of -aW/(Sigma Delta) with dW/dr = 2M.
            dg_tphi_dr = -(a * (2.0 * M * SD - W * dSD_dr) * inv_SD2)
        else:
            dg_tphi_dr = -(2.0 * M * a * (SD - r_s * dSD_dr)) * inv_SD2
        dg_rr_dr = (dDelta_dr * Sigma - Delta * dSigma_dr) * inv_S2
        dg_mumu_dr = -s * dSigma_dr * inv_S2
        inv_den_phi = inv_SD * inv_s
        inv_den_phi2 = inv_den_phi * inv_den_phi
        den_phi = SD * s
        num = Delta - a2 * s
        dg_phiphi_dr = (dDelta_dr * den_phi
                        - num * dSD_dr * s) * inv_den_phi2

        dp_r = -0.5 * (dg_tt_dr * p_t * p_t
                       + 2.0 * dg_tphi_dr * p_t * p_phi
                       + dg_rr_dr * p_r * p_r
                       + dg_mumu_dr * p_mu * p_mu
                       + dg_phiphi_dr * p_phi * p_phi)

        # -- polar (mu) derivatives: all polynomial in mu --
        ds_dmu = -2.0 * mu
        dSigma_dmu = 2.0 * a2 * mu
        dA_dmu = 2.0 * a2 * Delta * mu          # = -a2 * Delta * ds_dmu
        dSD_dmu = dSigma_dmu * Delta

        dg_tt_dmu = -(dA_dmu * SD - A * dSD_dmu) * inv_SD2
        if self._q2:
            dg_tphi_dmu = a * W * dSD_dmu * inv_SD2
        else:
            dg_tphi_dmu = 2.0 * M * a * r_s * dSD_dmu * inv_SD2
        dg_rr_dmu = -Delta * dSigma_dmu * inv_S2
        dg_mumu_dmu = (ds_dmu * Sigma - s * dSigma_dmu) * inv_S2
        dnum_dmu = 2.0 * a2 * mu                # = -a2 * ds_dmu
        dden_dmu = dSD_dmu * s + SD * ds_dmu
        dg_phiphi_dmu = (dnum_dmu * den_phi
                         - num * dden_dmu) * inv_den_phi2

        dp_mu = -0.5 * (dg_tt_dmu * p_t * p_t
                        + 2.0 * dg_tphi_dmu * p_t * p_phi
                        + dg_rr_dmu * p_r * p_r
                        + dg_mumu_dmu * p_mu * p_mu
                        + dg_phiphi_dmu * p_phi * p_phi)

        keep = jnp.logical_not(frozen)
        z = jnp.zeros_like(r)
        return (jnp.where(keep, dr, z), jnp.where(keep, dmu, z),
                jnp.where(keep, dphi, z), jnp.where(keep, dp_r, z),
                jnp.where(keep, dp_mu, z))

    def extract_angle(self, state5, p_t, p_phi, captured):
        """Final deflection angle from the integrated state, batched.

        Parity: metrics.py:363-416. Returns (status, final_alpha, n_half):
        status 1 escaped, -1 captured, 0 invalid.
        """
        r_f, th_f, phi_f, p_r_f, p_th_f = state5
        dtype = r_f.dtype
        M = jnp.asarray(self.M, dtype)
        a = jnp.asarray(self.a, dtype)
        r_capture = self.capture_radius()

        n_half = jnp.floor(jnp.abs(phi_f) / np.pi).astype(jnp.int32)
        is_captured = captured | (r_f <= r_capture * 1.1)
        bad_state = ~(jnp.isfinite(r_f) & jnp.isfinite(th_f)
                      & jnp.isfinite(phi_f))

        sin_th = jnp.sin(th_f)
        cos_th = jnp.cos(th_f)
        sin2 = jnp.maximum(sin_th * sin_th, _SIN2_FLOOR)
        r_s = jnp.where(bad_state | is_captured, 10.0 * M + 10.0, r_f)
        Sigma_f = r_s * r_s + a * a * cos_th * cos_th
        Delta_f = self._Delta_b(r_s)
        degenerate = (Sigma_f <= 1e-15) | (jnp.abs(Delta_f) <= 1e-15)
        Sigma_safe = jnp.where(degenerate, 1.0, Sigma_f)
        Delta_safe = jnp.where(degenerate, 1.0, Delta_f)

        dr_dl = Delta_safe / Sigma_safe * p_r_f
        dth_dl = p_th_f / Sigma_safe
        dphi_dl = (-a * self._two_M_r(r_s)
                   / (Sigma_safe * Delta_safe) * p_t
                   + (Delta_safe - a * a * sin2)
                   / (Sigma_safe * Delta_safe * sin2) * p_phi)

        sin_phi = jnp.sin(phi_f)
        cos_phi = jnp.cos(phi_f)
        vx = (sin_th * cos_phi * dr_dl
              + r_s * cos_th * cos_phi * dth_dl
              - r_s * sin_th * sin_phi * dphi_dl)
        vy = (sin_th * sin_phi * dr_dl
              + r_s * cos_th * sin_phi * dth_dl
              + r_s * sin_th * cos_phi * dphi_dl)
        vz = cos_th * dr_dl - r_s * sin_th * dth_dl

        bad_v = ~(jnp.isfinite(vx) & jnp.isfinite(vy) & jnp.isfinite(vz))
        v_mag = jnp.sqrt(vx * vx + vy * vy + vz * vz)
        tiny_v = v_mag < 1e-30
        v_safe = jnp.where(tiny_v, 1.0, v_mag)
        final_alpha = jnp.arccos(jnp.clip(-vx / v_safe, -1.0, 1.0))

        nan = jnp.asarray(jnp.nan, dtype)
        invalid = bad_state | degenerate | bad_v
        status = jnp.where(
            is_captured, -1, jnp.where(invalid, 0, 1)).astype(jnp.int32)
        final_alpha = jnp.where(
            is_captured | invalid | tiny_v, nan, final_alpha)
        n_half = jnp.where(bad_state & ~is_captured, 0, n_half)
        return status, final_alpha, n_half


class TracedKerr(_KerrHotPath):
    """Kerr physics with *traced* (M, a): the serving/animation variant.

    The frozen `Kerr` dataclass is hashable and folds its parameters into
    compiled constants — ideal for one scene, but a spin/mass sweep would
    recompile every frame. This adapter carries M and a as jnp scalars
    and shares the batched hot-path surface through `_KerrHotPath` (those
    methods only touch self.M / self.a / self.r_plus via jnp ops), so one
    compiled program serves any (M, a).

    Only the hot-path surface is available; host-side scalar geometry
    (alpha_crit etc.) needs concrete floats — use `Kerr`.
    """

    is_spherically_symmetric = False

    def __init__(self, M, a):
        self.M = M
        self.a = a
        self.r_plus = M + jnp.sqrt(jnp.maximum(M * M - a * a, 0.0))


@dataclasses.dataclass(frozen=True)
class Kerr(_KerrHotPath, Metric):
    M: float = 1.0
    a: float = 0.0

    is_spherically_symmetric: bool = dataclasses.field(
        default=False, init=False, repr=False)

    def __post_init__(self):
        if abs(self.a) > self.M:
            raise ValueError(f"|a|={abs(self.a)} exceeds M={self.M}")

    # ---- host-side scalar geometry (config-time, float64 numpy) ----

    @property
    def r_plus(self) -> float:
        return self.M + np.sqrt(self.M**2 - self.a**2)

    def _Sigma(self, r, th):
        return r**2 + self.a**2 * np.cos(th)**2

    def _Delta(self, r):
        # Factored (r - r_+)(r - r_-): exact roots, no cancellation
        # near the horizon. The expanded r^2 - 2Mr + a^2 loses ALL
        # significant digits at extremal spin (double root) for
        # r - r_+ ~ 1e-9, which poisoned eta (hence b_crit) there.
        s = np.sqrt(max(self.M**2 - self.a**2, 0.0))
        return (r - (self.M + s)) * (r - (self.M - s))

    def unstable_photon_radii(self):
        """(r_prograde, r_retrograde) of unstable circular photon orbits.

        Bardeen's closed form (metrics.py:866-874). Continuous at a = 0
        (both branches give 3M), so no special case is needed.
        """
        M, a = self.M, self.a
        r_pro = 2.0 * M * (1.0 + np.cos(2.0 / 3.0 * np.arccos(-a / M)))
        r_ret = 2.0 * M * (1.0 + np.cos(2.0 / 3.0 * np.arccos(a / M)))
        return float(r_pro), float(r_ret)

    def _xi_eta(self, r_ph):
        """Critical conserved quantities (xi, eta) of the spherical photon
        orbit at Boyer-Lindquist radius r_ph (metrics.py:884-890)."""
        M, a = self.M, self.a
        Delta = self._Delta(r_ph)
        xi = (r_ph**2 + a**2) / a - 2.0 * r_ph * Delta / (a * (r_ph - M))
        eta = (r_ph**3 / (a**2 * (r_ph - M)**2)
               * (4.0 * M * Delta - r_ph * (r_ph - M)**2))
        return xi, eta

    def critical_impact_params(self):
        """[(xi_pro, eta_pro), (xi_ret, eta_ret)]; undefined for a = 0."""
        if self.a == 0:
            raise ValueError("critical_impact_params undefined for a=0")
        return [self._xi_eta(r) for r in self.unstable_photon_radii()]

    def alpha_crit(self, r_obs, theta_obs=None, n_samples=50) -> float:
        """Shadow-envelope critical viewing angle (metrics.py:893-930):
        the max impact parameter over sampled spherical photon orbits,
        clamped below by the Schwarzschild value, converted to a viewing
        angle at the observer."""
        if theta_obs is None:
            theta_obs = np.pi / 2
        M, a = self.M, self.a
        if a == 0:
            b_crit = 3.0 * np.sqrt(3.0) * M
        else:
            r_pro, r_ret = self.unstable_photon_radii()
            r_arr = np.linspace(r_pro, r_ret, n_samples)
            xi, eta = self._xi_eta(r_arr)
            b2 = xi**2 + np.maximum(eta, 0.0)
            b_crit = max(float(np.sqrt(np.max(b2))), 3.0 * np.sqrt(3.0) * M)

        Delta_o = self._Delta(r_obs)
        Sigma_o = self._Sigma(r_obs, theta_obs)
        sin_th = np.sin(theta_obs)
        A = (r_obs**2 + a**2)**2 - a**2 * Delta_o * sin_th**2
        arg = b_crit * np.sqrt(Sigma_o * Delta_o / A) / r_obs
        return float(np.arcsin(np.clip(arg, -1.0, 1.0)))

    def viewing_angle_to_impact_parameter(self, alpha, r_obs,
                                          theta_obs=None):
        if theta_obs is None:
            theta_obs = np.pi / 2
        if self.a == 0:
            f = 1.0 - 2.0 * self.M / r_obs
            return r_obs * np.sin(alpha) / np.sqrt(f)
        Delta = self._Delta(r_obs)
        Sigma = self._Sigma(r_obs, theta_obs)
        sin_th = np.sin(theta_obs)
        A = (r_obs**2 + self.a**2)**2 - self.a**2 * Delta * sin_th**2
        return r_obs * np.sin(alpha) * np.sqrt(A / (Sigma * Delta))

    # ---- full 8-D Hamiltonian path (jnp, batched) ----

    def geodesic_equations(self, lam, state8):
        """Hamilton's equations on the public 8-D state (metrics.py:946-1029).

        Built from the reduced-state RHS: dt = g^tt p_t + g^tphi p_phi and
        the cyclic momenta are constant.
        """
        t, r, th, phi, p_t, p_r, p_th, p_phi = jnp.moveaxis(state8, -1, 0)
        dr, dth, dphi, dp_r, dp_th = self.rhs5(
            (r, th, phi, p_r, p_th), p_t, p_phi)[0:5]

        dtype = r.dtype
        # Freeze at the family's own radius: r_plus*1.001 for Kerr/KN
        # (bitwise-unchanged), the barrier-aware surface for families
        # whose pathology extends outside Kerr's horizon (JP, custom).
        r_freeze = jnp.asarray(self._freeze_radius(), dtype)
        frozen = r <= r_freeze
        r_s = jnp.where(frozen, 10.0 * r_freeze + 10.0, r)
        (g_tt, g_tphi, *_rest) = self._inv_terms(r_s, th)
        dt = jnp.where(frozen, 0.0, g_tt * p_t + g_tphi * p_phi)
        zeros = jnp.zeros_like(r)
        return jnp.stack(
            [dt, dr, dth, dphi, zeros, dp_r, dp_th, zeros], axis=-1)

    def initial_conditions_8d(self, r_obs, alpha, theta=0.0, theta_obs=None):
        """Batched 8-D initial state (metrics.py:1033-1109).

        Returns (state8, invalid_mask).
        """
        if theta_obs is None:
            theta_obs = np.pi / 2
        alpha = jnp.asarray(alpha)
        theta = jnp.broadcast_to(jnp.asarray(theta, alpha.dtype), alpha.shape)
        (r0, th0, phi0, p_r, p_th), p_t, p_phi, invalid = (
            self.initial_conditions_5d(r_obs, alpha, theta, theta_obs))
        zeros = jnp.zeros_like(alpha)
        state8 = jnp.stack(
            [zeros, r0, th0, phi0, p_t, p_r, p_th,
             jnp.broadcast_to(p_phi, alpha.shape)], axis=-1)
        return state8, invalid
