"""Johannsen-Psaltis deformed Kerr: the test-GR metric family.

Johannsen & Psaltis 2011 (PRD 83, 124015) construct a stationary,
axisymmetric, asymptotically-flat deformation of Kerr used throughout
the EHT/X-ray literature to test the no-hair theorem: if astrophysical
black holes are Kerr, every shadow/disk observable must be consistent
with deformation parameter eps3 = 0. Keeping the leading deformation
h(r, theta) = eps3 M^3 r / Sigma^2, the line element is Kerr's with

    g_tt     = -(1 + h) (1 - 2 M r / Sigma)
    g_tphi   = -(2 a M r sin^2(theta) / Sigma) (1 + h)
    g_rr     = Sigma (1 + h) / (Delta + a^2 h sin^2(theta))
    g_thth   = Sigma
    g_phiphi = sin^2(theta) [r^2 + a^2 + 2 a^2 M r sin^2(theta)/Sigma]
               + h a^2 sin^2(theta) (Sigma + 2 M r) / Sigma

(Sigma, Delta as in Kerr). The key STRUCTURAL difference from every
other family in this package: the JP metric is not Petrov type D —
there is NO Carter constant, so the Kerr/Kerr-Newman separability
tricks (Bardeen screen band, (xi, eta) photon-orbit formulas, mu
chart, plunge early-exit) do not exist. What survives is exactly what
the reduced 5-D integrator actually needs — the two Killing
symmetries (t, phi cyclic => conserved p_t, p_phi) — which is why
this family runs on the UNMODIFIED hot loop with

  * `_inv_terms` = the five contravariant components from the exact
    2x2 (t, phi)-block inversion of the covariant metric above, and
  * `rhs5` = a HAND-DERIVED closed-form RHS (round 4): closed-form
    r/theta partials of the covariant components
    (_covariant_derivs_jp) pushed through the 2x2 (t, phi)-block
    inverse derivative chain. The generic jax.grad-of-Hamiltonian
    form (_KerrHotPath.rhs5_autodiff) remains in the class as the
    roundoff-level ORACLE — the same hand-vs-autodiff contract as
    Kerr/Kerr-Newman, pinned in tests/test_johannsen_psaltis.py.

The critical angle has no closed form without separability;
`alpha_crit` bisects the traced capture boundary along a fan of
screen azimuths and returns the envelope (the same numeric approach
validates against Kerr's analytic envelope to <1e-3 in tests).

Approximations, stated: the initial conditions reuse Kerr's Bardeen
screen mapping at the OBSERVER, where h(r_obs) = eps3 (M/r_obs)^3
(~1e-6 at 100M) — the ray's momentum is then made exactly null
through the JP `_inv_terms`, so only the screen parametrization (not
the physics) is asymptotic. Angle extraction runs at the escape
radius (2 r_obs) with the same justification. The family runs on
BOTH backends (the hand-derived rhs5 has no jax.grad, so it runs in
the fused Pallas kernel — tests/test_pallas.py); disk/orbital machinery (ISCO, Keplerian Omega) keeps
its Kerr closed forms and is NOT wired for eps3 != 0 — shadow, lens,
magnification, AA, and trajectories are the supported surfaces.
Validity: moderate deformations (|eps3| of a few); large negative
eps3 deforms the horizon region pathologically (JP 2011 Sec. IV).

Reference parity anchor: the reference has a two-metric family tree
(metrics.py:735,840); this is the third+ family the SURVEY's Metric
ABC row anticipated, built on the same extension surface as
Reissner-Nordstrom (round 3) and Kerr-Newman (round 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from light_path_tracer_tpu.models.kerr import Kerr, _SIN2_FLOOR


def _covariant_terms_jp(M, a, eps3, r, th):
    """Covariant JP components (g_tt, g_tphi, g_rr, g_thth, g_phiphi)
    plus shared intermediates (Sigma, Delta, sin_th, cos_th, sin2)."""
    sin_th = jnp.sin(th)
    cos_th = jnp.cos(th)
    sin2 = jnp.maximum(sin_th * sin_th, _SIN2_FLOOR)
    r2 = r * r
    a2 = a * a
    Sigma = r2 + a2 * cos_th * cos_th
    Delta = r2 - 2.0 * M * r + a2
    h = eps3 * (M * M * M) * r / (Sigma * Sigma)
    two_Mr = 2.0 * M * r
    g_tt = -(1.0 + h) * (1.0 - two_Mr / Sigma)
    g_tphi = -(a * two_Mr * sin2 / Sigma) * (1.0 + h)
    g_rr = Sigma * (1.0 + h) / (Delta + a2 * h * sin2)
    g_thth = Sigma
    g_phiphi = (sin2 * (r2 + a2 + a2 * two_Mr * sin2 / Sigma)
                + h * a2 * sin2 * (Sigma + two_Mr) / Sigma)
    return (g_tt, g_tphi, g_rr, g_thth, g_phiphi,
            Sigma, Delta, sin_th, cos_th, sin2)


def _covariant_derivs_jp(M, a, eps3, r, th):
    """Hand-derived covariant components AND their closed-form r/theta
    partials — the derivation that puts JP in the fused Pallas kernel
    without jax.grad; these partials are mechanical calculus over Sigma, Delta,
    h = eps3 M^3 r / Sigma^2, W = 2Mr/Sigma, with g_phiphi rewritten as
    sin2 * [r^2 + a^2 + a^2 W sin2 + a^2 h (1 + W)] via
    (Sigma + 2Mr)/Sigma = 1 + W).

    Returns {name: (value, d/dr, d/dtheta)} for the five covariant
    components. The sin^2 floor's derivative matches autodiff of
    jnp.maximum (zero where the floor binds), so the autodiff
    Hamiltonian RHS (kerr._KerrHotPath.rhs5_autodiff) agrees at
    roundoff — the oracle test in tests/test_johannsen_psaltis.py.
    """
    s = jnp.sin(th)
    c = jnp.cos(th)
    s2_raw = s * s
    s2 = jnp.maximum(s2_raw, _SIN2_FLOOR)
    s2p = jnp.where(s2_raw >= _SIN2_FLOOR, 2.0 * s * c, 0.0)
    r2, a2 = r * r, a * a
    Sig = r2 + a2 * c * c
    Sig_r = 2.0 * r
    Sig_t = -2.0 * a2 * s * c
    Del = r2 - 2.0 * M * r + a2
    Del_r = 2.0 * r - 2.0 * M
    M3 = M * M * M
    h = eps3 * M3 * r / (Sig * Sig)
    h_r = eps3 * M3 * (Sig - 4.0 * r2) / (Sig * Sig * Sig)
    h_t = -2.0 * eps3 * M3 * r * Sig_t / (Sig * Sig * Sig)
    W = 2.0 * M * r / Sig
    W_r = 2.0 * M / Sig - W * Sig_r / Sig
    W_t = -W * Sig_t / Sig
    oh = 1.0 + h
    g_tt = -oh * (1.0 - W)
    g_tt_r = -h_r * (1.0 - W) + oh * W_r
    g_tt_t = -h_t * (1.0 - W) + oh * W_t
    g_tp = -(a * W * s2 * oh)
    g_tp_r = -(a * s2 * (W_r * oh + W * h_r))
    g_tp_t = -(a * (s2p * W * oh + s2 * (W_t * oh + W * h_t)))
    B = Del + a2 * h * s2
    B_r = Del_r + a2 * h_r * s2
    B_t = a2 * (h_t * s2 + h * s2p)
    g_rr = Sig * oh / B
    g_rr_r = (Sig_r * oh + Sig * h_r) / B - g_rr * B_r / B
    g_rr_t = (Sig_t * oh + Sig * h_t) / B - g_rr * B_t / B
    P = r2 + a2 + a2 * W * s2 + a2 * h * (1.0 + W)
    P_r = 2.0 * r + a2 * W_r * s2 + a2 * (h_r * (1.0 + W) + h * W_r)
    P_t = a2 * (W_t * s2 + W * s2p) + a2 * (h_t * (1.0 + W) + h * W_t)
    return dict(g_tt=(g_tt, g_tt_r, g_tt_t),
                g_tp=(g_tp, g_tp_r, g_tp_t),
                g_rr=(g_rr, g_rr_r, g_rr_t),
                g_thth=(Sig, Sig_r, Sig_t),
                g_pp=(s2 * P, s2 * P_r, s2p * P + s2 * P_t))


@dataclasses.dataclass(frozen=True)
class JohannsenPsaltis(Kerr):
    eps3: float = 0.0
    # supports_pallas is inherited True: rhs5 below is a hand-derived
    # closed form (no jax.grad), so JP shadows/lensing run in the fused
    # kernel like Kerr/KN.

    def __post_init__(self):
        super().__post_init__()
        # The deformation moves the inner pathology OUTSIDE Kerr's
        # horizon for eps3 < 0: g^rr flips sign where
        # Delta + a^2 h sin^2(theta) = 0, and (1 + h) = 0 kills the
        # whole (t, phi) block — both lie at r > r_+ for negative h.
        # Integrating into either surface produces NaN lanes, so the
        # capture surface must park rays just OUTSIDE the outermost
        # such root (for eps3 >= 0 both surfaces sit inside r_+ and
        # this reduces to Kerr's 1.01 r_+). Host-side numeric scan at
        # config time; frozen dataclass -> object.__setattr__.
        M, a, eps3 = self.M, self.a, self.eps3
        r = np.linspace(1e-3, 4.0 * self.r_plus + 4.0, 4001)
        th = np.linspace(1e-3, np.pi - 1e-3, 61)[:, None]
        Sigma = r[None, :] ** 2 + a ** 2 * np.cos(th) ** 2
        Delta = r ** 2 - 2.0 * M * r + a ** 2
        h = eps3 * M ** 3 * r[None, :] / Sigma ** 2
        sin2 = np.sin(th) ** 2
        bad = ((Delta[None, :] + a ** 2 * h * sin2) <= 0.0) \
            | ((1.0 + h) <= 0.0)
        bad_any = bad.any(axis=0)
        r_barrier = float(r[bad_any.nonzero()[0].max()]) \
            if bad_any.any() else 0.0
        object.__setattr__(
            self, "_r_capture",
            max(1.01 * self.r_plus, 1.02 * r_barrier))

    def capture_radius(self):
        return self._r_capture

    def _freeze_radius(self):
        # Just inside the capture surface (which itself clears the
        # numeric barrier by 2%): intermediate RK stages probing below
        # the capture radius stay on finite metric components.
        return 0.995 * self._r_capture

    def _inv_terms(self, r, th):
        """Exact contravariant components: the (t, phi) block inverts
        as a 2x2 (g^tt = g_phiphi/D, g^tphi = -g_tphi/D,
        g^phiphi = g_tt/D with D = g_tt g_phiphi - g_tphi^2); r and
        theta are diagonal. Same return contract as Kerr's
        _inverse_metric_terms (the trailing intermediates carry Kerr's
        A slot as the 2x2 determinant's negative — only the leading
        five are consumed by the shared machinery)."""
        dtype = r.dtype if hasattr(r, "dtype") else jnp.float64
        M = jnp.asarray(self.M, dtype)
        a = jnp.asarray(self.a, dtype)
        eps3 = jnp.asarray(self.eps3, dtype)
        (g_tt, g_tphi, g_rr, g_thth, g_phiphi,
         Sigma, Delta, sin_th, cos_th, sin2) = _covariant_terms_jp(
            M, a, eps3, r, th)
        D = g_tt * g_phiphi - g_tphi * g_tphi
        D_safe = jnp.where(jnp.abs(D) < 1e-30, 1e-30, D)
        inv_tt = g_phiphi / D_safe
        inv_tphi = -g_tphi / D_safe
        inv_phiphi = g_tt / D_safe
        inv_rr = 1.0 / g_rr
        inv_thth = 1.0 / g_thth
        return (inv_tt, inv_tphi, inv_rr, inv_thth, inv_phiphi,
                Sigma, Delta, -D, sin_th, cos_th, sin2)

    def rhs5(self, state5, p_t, p_phi):
        """Hand-derived JP Hamiltonian RHS (round 4).

        Built from _covariant_derivs_jp's closed-form covariant
        partials via the 2x2 (t, phi)-block inverse derivative chain:
        with D = g_tt g_pp - g_tp^2,

            d(g^tt)   = (d g_pp   - g^tt   dD) / D
            d(g^tphi) = (-d g_tp  - g^tphi dD) / D
            d(g^pp)   = (d g_tt   - g^pp   dD) / D
            d(g^rr)   = -d g_rr * (g^rr)^2        (diagonal)
            d(g^thth) = -d Sigma / Sigma^2

        and Hamilton's equations on the reduced state
        (dr, dth, dphi, dp_r, dp_th) =
        (g^rr p_r, g^thth p_th, g^tphi p_t + g^pp p_phi,
         -dH/dr, -dH/dtheta). The autodiff form (rhs5_autodiff, grad of
        the same quotient structure) is the roundoff-level oracle —
        agreement <= ~1e-10 rel on random states, and eps3 = 0 matches
        Kerr's independent hand form (tests/test_johannsen_psaltis.py).
        No jax.grad, so it runs in the fused Pallas kernel
        (tests/test_pallas.py)."""
        r, th, phi, p_r, p_th = state5
        dtype = r.dtype
        M = jnp.asarray(self.M, dtype)
        a = jnp.asarray(self.a, dtype)
        eps3 = jnp.asarray(self.eps3, dtype)
        r_freeze = jnp.asarray(self._freeze_radius(), dtype)
        frozen = r <= r_freeze
        r_s = jnp.where(frozen, 10.0 * r_freeze + 10.0, r)

        cv = _covariant_derivs_jp(M, a, eps3, r_s, th)
        g_tt, g_tt_r, g_tt_t = cv["g_tt"]
        g_tp, g_tp_r, g_tp_t = cv["g_tp"]
        g_rr, g_rr_r, g_rr_t = cv["g_rr"]
        Sig, Sig_r, Sig_t = cv["g_thth"]
        g_pp, g_pp_r, g_pp_t = cv["g_pp"]

        D = g_tt * g_pp - g_tp * g_tp
        D_r = g_tt_r * g_pp + g_tt * g_pp_r - 2.0 * g_tp * g_tp_r
        D_t = g_tt_t * g_pp + g_tt * g_pp_t - 2.0 * g_tp * g_tp_t
        Ds = jnp.where(jnp.abs(D) < 1e-30, 1e-30, D)
        i_tt = g_pp / Ds
        i_tp = -g_tp / Ds
        i_pp = g_tt / Ds
        i_tt_r = (g_pp_r - i_tt * D_r) / Ds
        i_tt_t = (g_pp_t - i_tt * D_t) / Ds
        i_tp_r = (-g_tp_r - i_tp * D_r) / Ds
        i_tp_t = (-g_tp_t - i_tp * D_t) / Ds
        i_pp_r = (g_tt_r - i_pp * D_r) / Ds
        i_pp_t = (g_tt_t - i_pp * D_t) / Ds
        i_rr = 1.0 / g_rr
        i_rr_r = -g_rr_r * i_rr * i_rr
        i_rr_t = -g_rr_t * i_rr * i_rr
        i_hh = 1.0 / Sig
        i_hh_r = -Sig_r * i_hh * i_hh
        i_hh_t = -Sig_t * i_hh * i_hh

        p_t_b = jnp.broadcast_to(jnp.asarray(p_t, dtype), r.shape)
        p_phi_b = jnp.broadcast_to(jnp.asarray(p_phi, dtype), r.shape)
        dr = i_rr * p_r
        dth = i_hh * p_th
        dphi = i_tp * p_t_b + i_pp * p_phi_b
        dHr = 0.5 * (i_tt_r * p_t_b * p_t_b
                     + 2.0 * i_tp_r * p_t_b * p_phi_b
                     + i_rr_r * p_r * p_r
                     + i_hh_r * p_th * p_th
                     + i_pp_r * p_phi_b * p_phi_b)
        dHt = 0.5 * (i_tt_t * p_t_b * p_t_b
                     + 2.0 * i_tp_t * p_t_b * p_phi_b
                     + i_rr_t * p_r * p_r
                     + i_hh_t * p_th * p_th
                     + i_pp_t * p_phi_b * p_phi_b)
        keep = jnp.logical_not(frozen)
        z = jnp.zeros_like(r)
        return (jnp.where(keep, dr, z), jnp.where(keep, dth, z),
                jnp.where(keep, dphi, z), jnp.where(keep, -dHr, z),
                jnp.where(keep, -dHt, z))

    def rhs5_mu(self, state5, p_t, p_phi):
        raise NotImplementedError(
            "the mu = cos(theta) chart is wired for the hand-derived "
            "Kerr/Kerr-Newman RHS only; JP integrates in theta form")

    def plunge_radii(self, r_obs, alphas, thetas, theta_obs):
        """Certain-capture early exit DISABLED (radius 0 per ray): the
        (xi, eta) photon-orbit band argument needs Carter separability,
        which JP lacks. Purely conservative — classification is done
        by the integrator alone."""
        return jnp.zeros_like(alphas)

    def alpha_crit(self, r_obs, theta_obs=None, n_azimuth: int = 16,
                   iters: int = 26, max_steps: int = 60000) -> float:
        """Shadow-envelope critical angle by bisection on TRACED
        outcomes (models/numeric.py:alpha_crit_traced — shared with
        CustomMetric): per screen azimuth, bisect the capture/escape
        boundary in viewing angle, return the envelope max. ~iters
        compiled trace calls of n_azimuth rays each — host-side
        analysis, not a render path. Validated against Kerr's analytic
        envelope in tests/test_johannsen_psaltis.py."""
        from light_path_tracer_tpu.models.numeric import (
            alpha_crit_traced)
        return alpha_crit_traced(self, r_obs, theta_obs,
                                 n_azimuth=n_azimuth, iters=iters,
                                 max_steps=max_steps)
