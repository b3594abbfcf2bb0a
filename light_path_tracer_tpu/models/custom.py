"""User-defined metrics: bring your own spacetime.

The Johannsen-Psaltis family (models/johannsen_psaltis.py) proved the
extension contract of the reduced 5-D integrator: any stationary,
axisymmetric, asymptotically-flat metric is fully specified — for every
shadow / lensing / magnification / trajectory surface in this package —
by its five nonzero covariant Boyer-Lindquist-chart components

    g_tt(r, theta), g_tphi(r, theta), g_rr(r, theta),
    g_thth(r, theta), g_phiphi(r, theta),

because the hot loop needs only the two Killing symmetries (t, phi
cyclic -> conserved p_t, p_phi), NOT Carter separability. This module
makes that contract public: `CustomMetric` wraps a user-supplied
callable returning those five components and derives everything else —

  * contravariant components by exact 2x2 (t, phi)-block inversion
    (`_inv_terms`),
  * the geodesic RHS by jax.grad of the Hamiltonian
    H = (1/2) g^{mu nu} p_mu p_nu (`_KerrHotPath.rhs5_autodiff` — the
    same code that is the roundoff-level ORACLE of the hand-derived
    Kerr/Kerr-Newman forms, so its correctness is pinned elsewhere),
  * an exact metric-generic escape-heading extraction (dr/dlambda =
    g^rr p_r etc. — overriding Kerr's hand-substituted form, which the
    tests show is the same thing at roundoff for Kerr input),
  * a numeric capture surface from a config-time signature scan (the
    outermost radius where the metric stops being a Lorentzian
    exterior: det of the (t, phi) block >= 0, g_rr <= 0, g_thth <= 0,
    or non-finite — generalizing the Johannsen-Psaltis barrier logic),
  * and the critical angle by bisection on traced outcomes
    (models/numeric.py:alpha_crit_traced).

Approximations, stated (same as Johannsen-Psaltis): the camera screen
is parametrized with Kerr's Bardeen mapping at the OBSERVER radius
using the declared (M, a), so the metric must approach Kerr(M, a)
[or Schwarzschild(M) for a=0] far from the hole for the screen
calibration to be exact; the ray's momentum is then made exactly null
through the USER metric, so only the screen parametrization (not the
physics) is asymptotic. Angle extraction runs at the escape radius
(2 r_obs) with the same justification — but through the user metric's
own contravariant components, exactly.

XLA backend only (`supports_pallas = False`: the fused Pallas kernel
is not checked against jax.grad of arbitrary user callables); disk
orbital machinery (ISCO, Keplerian Omega) keeps closed forms for the
shipped families and rejects custom metrics. Polarization is
Kerr-only. Supported surfaces: shadow, lens, magnification, AA,
adaptive AA, visibility, trajectories.

Reference parity anchor: the reference's extension surface is the
`Metric` ABC (metrics.py:682-728) with exactly two concrete families;
this module is the batched generalization of that ABC to
arbitrary user spacetimes, with the integrator derived from the
metric instead of hand-coded per family.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Callable

import numpy as np
import jax.numpy as jnp

from light_path_tracer_tpu.models.kerr import Kerr, _SIN2_FLOOR
from light_path_tracer_tpu.models.numeric import alpha_crit_traced


def kerr_covariant(M: float, a: float) -> Callable:
    """Kerr's covariant components in Boyer-Lindquist — the closure
    identity for CustomMetric (CustomMetric(kerr_covariant(M, a)) must
    trace like Kerr(M, a); pinned in tests/test_custom_metric.py)."""
    def fn(r, th):
        sin2 = jnp.maximum(jnp.sin(th) ** 2, _SIN2_FLOOR)
        cos_th = jnp.cos(th)
        Sigma = r * r + a * a * cos_th * cos_th
        Delta = r * r - 2.0 * M * r + a * a
        two_Mr = 2.0 * M * r
        g_tt = -(1.0 - two_Mr / Sigma)
        g_tphi = -a * two_Mr * sin2 / Sigma
        g_rr = Sigma / Delta
        g_thth = Sigma
        g_phiphi = (r * r + a * a
                    + a * a * two_Mr * sin2 / Sigma) * sin2
        return g_tt, g_tphi, g_rr, g_thth, g_phiphi
    return fn


def reissner_nordstrom_covariant(M: float, Q: float) -> Callable:
    """Static charged hole ds^2 = -f dt^2 + dr^2/f + r^2 dOmega^2 with
    f = 1 - 2M/r + Q^2/r^2 — an independent diagonal-form oracle: the
    CustomMetric trace of this function cross-checks the dedicated 2-D
    orbit-equation path of models/reissner_nordstrom.py."""
    def fn(r, th):
        sin2 = jnp.maximum(jnp.sin(th) ** 2, _SIN2_FLOOR)
        f = 1.0 - 2.0 * M / r + (Q * Q) / (r * r)
        zero = jnp.zeros_like(r * th)
        return (-f + zero, zero, 1.0 / f + zero,
                r * r + zero, r * r * sin2)
    return fn


def load_covariant_fn(spec: str) -> Callable:
    """Load a user covariant-components function from "FILE.py:ATTR".

    ATTR must be a callable (r, th) -> (g_tt, g_tphi, g_rr, g_thth,
    g_phiphi) written in jax.numpy (it is traced into the compiled
    integrator). This imports and EXECUTES the named file — a local
    trust boundary equivalent to `python FILE.py`; it is deliberately
    NOT reachable through the HTTP serving layer.
    """
    fn = _load_attr(spec)
    if not callable(fn):
        raise TypeError(f"{spec}: {attr_of(spec)} is not callable")
    return fn


def attr_of(spec: str) -> str:
    return spec.rsplit(":", 1)[1] if ":" in spec else spec


def _load_attr(spec: str):
    if ":" not in spec:
        raise ValueError(
            f"--metric-py expects FILE.py:ATTR, got {spec!r}")
    path, attr = spec.rsplit(":", 1)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    name = "_lpt_user_metric_" + os.path.basename(path).replace(
        ".", "_")
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return getattr(module, attr)


def load_user_metric(spec: str, M: float = 1.0,
                     a: float = 0.0) -> "CustomMetric":
    """Load a user metric from "FILE.py:ATTR" — ATTR may be either a
    covariant-components callable (wrapped in CustomMetric with the
    given M, a) or a ready CustomMetric INSTANCE (returned as-is; its
    own M/a/capture/captured_fn configuration wins — the instance form
    exists exactly for metrics that need more than the five components,
    e.g. the Majumdar-Papapetrou binary's captured_fn + small capture
    sphere, examples/user_metric.py:mp_binary). Same local trust
    boundary as load_covariant_fn."""
    obj = _load_attr(spec)
    if isinstance(obj, CustomMetric):
        return obj
    if not callable(obj):
        raise TypeError(
            f"{spec}: {attr_of(spec)} is neither a covariant-"
            f"components callable nor a CustomMetric instance")
    return CustomMetric(M=M, a=a, covariant_fn=obj, label=spec)


@dataclasses.dataclass(frozen=True)
class CustomMetric(Kerr):
    """A stationary axisymmetric metric from user covariant components.

    Parameters
    ----------
    M, a : the asymptotic mass and spin the far field approaches —
        they calibrate the camera screen (Bardeen mapping at the
        observer) and the conserved-quantity seeds; the traced physics
        comes entirely from `covariant_fn`. Use a=0 for static metrics.
    covariant_fn : (r, th) -> (g_tt, g_tphi, g_rr, g_thth, g_phiphi),
        batched jax.numpy over same-shape arrays (parameters closed
        over). Must be finite and Lorentzian on the exterior.
    label : display name (CLI/benchmark output).
    capture_radius_override : explicit capture radius in M-units for
        horizonless objects (wormholes, boson stars) where the
        signature scan finds no barrier and the Kerr r_+ fallback is
        meaningless.
    """

    covariant_fn: Callable = None
    label: str = "custom"
    capture_radius_override: float | None = None
    #: Optional epilogue capture predicate (r, th) -> bool array, for
    #: metrics whose trapped region is NOT a centered sphere (e.g. the
    #: multi-center Majumdar-Papapetrou binary, whose extremal throats
    #: are points on the axis in isotropic coordinates). Rays flagged
    #: here classify as CAPTURED at trace end. The HOT-LOOP early exit
    #: remains the scalar capture sphere — flagged rays integrate to
    #: the step/lambda budget first (physically honest: an extremal
    #: throat is asymptotically deep; bound the cost with max_steps).
    #: Pair it with a small capture_radius_override so the default
    #: Kerr-r_+ sphere does not swallow legitimate escape corridors.
    captured_fn: Callable | None = None
    #: Optional fixed critical angle (radians). The traced bisection
    #: (models/numeric.py) assumes ONE centered shadow with a monotone
    #: captured->escaped transition per azimuth — meaningless (and,
    #: without a capture sphere to exit on, slow) for multi-center
    #: metrics. The value feeds stats/printouts and the loop-around
    #: palette edge only, never the physics; it does NOT rescale with
    #: r_obs, so match it to the observer radius you render from.
    alpha_crit_override: float | None = None

    #: The fused Pallas kernel is not checked against jax.grad of
    #: arbitrary user callables; ops.batch._kerr_backend resolves this
    #: family to the XLA while_loop path.
    supports_pallas: bool = dataclasses.field(
        default=False, init=False, repr=False)

    def __post_init__(self):
        super().__post_init__()
        if self.covariant_fn is None:
            raise ValueError(
                "CustomMetric requires covariant_fn=(r, th) -> "
                "(g_tt, g_tphi, g_rr, g_thth, g_phiphi)")
        if self.capture_radius_override is not None:
            r_cap = float(self.capture_radius_override)
            if r_cap <= 0.0:
                raise ValueError("capture_radius_override must be > 0")
        else:
            r_cap = max(1.01 * self.r_plus,
                        1.02 * self._signature_barrier())
        object.__setattr__(self, "_r_capture", r_cap)

    def _signature_barrier(self) -> float:
        """Outermost radius where the user metric stops being a
        Lorentzian exterior — config-time host scan, generalizing the
        Johannsen-Psaltis barrier logic to arbitrary components. The
        capture surface parks rays 2% outside it so no RK stage ever
        probes a non-finite or signature-flipped region."""
        r = np.linspace(1e-3, max(4.0 * self.r_plus + 4.0,
                                  12.0 * self.M), 4001)
        th = np.linspace(1e-3, np.pi - 1e-3, 61)[:, None]
        out = self.covariant_fn(jnp.asarray(r[None, :], jnp.float64),
                                jnp.asarray(th, jnp.float64))
        g_tt, g_tphi, g_rr, g_thth, g_phiphi = (
            np.asarray(c, np.float64) for c in out)
        det_tphi = g_tt * g_phiphi - g_tphi * g_tphi
        finite = (np.isfinite(g_tt) & np.isfinite(g_tphi)
                  & np.isfinite(g_rr) & np.isfinite(g_thth)
                  & np.isfinite(g_phiphi))
        bad = (~finite) | (g_rr <= 0.0) | (g_thth <= 0.0) \
            | (det_tphi >= 0.0)
        bad_any = np.broadcast_to(bad, (th.shape[0], r.shape[0])) \
            .any(axis=0)
        return float(r[bad_any.nonzero()[0].max()]) \
            if bad_any.any() else 0.0

    def capture_radius(self):
        return self._r_capture

    def _freeze_radius(self):
        # Just inside the capture surface: intermediate RK stages
        # probing below the capture radius stay on finite components.
        return 0.995 * self._r_capture

    def _inv_terms(self, r, th):
        """Exact contravariant components from the user covariant form:
        the (t, phi) block inverts as a 2x2 (g^tt = g_phiphi/D,
        g^tphi = -g_tphi/D, g^phiphi = g_tt/D with
        D = g_tt g_phiphi - g_tphi^2); r and theta are diagonal. The
        trailing intermediates fill Kerr's tuple contract with
        chart-convention analogues (Sigma := g_thth; Delta := g_thth /
        g_rr, both exact Kerr identities) — only the leading five are
        consumed by the shared machinery."""
        g_tt, g_tphi, g_rr, g_thth, g_phiphi = self.covariant_fn(r, th)
        D = g_tt * g_phiphi - g_tphi * g_tphi
        D_safe = jnp.where(jnp.abs(D) < 1e-30, 1e-30, D)
        inv_tt = g_phiphi / D_safe
        inv_tphi = -g_tphi / D_safe
        inv_phiphi = g_tt / D_safe
        inv_rr = 1.0 / g_rr
        inv_thth = 1.0 / g_thth
        sin_th = jnp.sin(th)
        cos_th = jnp.cos(th)
        sin2 = jnp.maximum(sin_th * sin_th, _SIN2_FLOOR)
        return (inv_tt, inv_tphi, inv_rr, inv_thth, inv_phiphi,
                g_thth, g_thth / g_rr, -D, sin_th, cos_th, sin2)

    def rhs5(self, state5, p_t, p_phi):
        """No hand form exists for a user metric — the autodiff
        Hamiltonian RHS over this class's `_inv_terms` IS the
        integrator (correctness pinned by the Kerr/Kerr-Newman
        roundoff-agreement oracles plus the closure identity
        CustomMetric(kerr_covariant) == Kerr in tests)."""
        return self.rhs5_autodiff(state5, p_t, p_phi)

    def rhs5_mu(self, state5, p_t, p_phi):
        raise NotImplementedError(
            "the mu = cos(theta) chart is wired for the hand-derived "
            "Kerr/Kerr-Newman RHS only; custom metrics integrate in "
            "theta form")

    def plunge_radii(self, r_obs, alphas, thetas, theta_obs):
        """Certain-capture early exit DISABLED (radius 0 per ray): the
        (xi, eta) photon-orbit band argument needs Carter separability,
        which a general metric lacks. Purely conservative."""
        return jnp.zeros_like(alphas)

    def extract_angle(self, state5, p_t, p_phi, captured):
        """Escape heading through the USER metric, exactly: the
        coordinate velocities are dr/dl = g^rr p_r, dth/dl = g^thth
        p_th, dphi/dl = g^tphi p_t + g^phiphi p_phi — Kerr's version
        (models/kerr.py:579) is this with the components substituted
        by hand. Same status/guard semantics as Kerr's."""
        r_f, th_f, phi_f, p_r_f, p_th_f = state5
        dtype = r_f.dtype
        M = jnp.asarray(self.M, dtype)
        r_capture = self.capture_radius()

        n_half = jnp.floor(jnp.abs(phi_f) / np.pi).astype(jnp.int32)
        is_captured = captured | (r_f <= r_capture * 1.1)
        bad_state = ~(jnp.isfinite(r_f) & jnp.isfinite(th_f)
                      & jnp.isfinite(phi_f))
        if self.captured_fn is not None:
            # User trapped-region predicate (finite states only — a
            # NaN coordinate must stay INVALID, not become captured).
            r_q = jnp.where(bad_state, jnp.asarray(1.0, dtype), r_f)
            th_q = jnp.where(bad_state, jnp.asarray(1.0, dtype), th_f)
            is_captured = is_captured | (~bad_state
                                         & self.captured_fn(r_q, th_q))

        sin_th = jnp.sin(th_f)
        cos_th = jnp.cos(th_f)
        r_s = jnp.where(bad_state | is_captured, 10.0 * M + 10.0, r_f)
        (g_tt_i, g_tphi_i, g_rr_i, g_thth_i, g_phiphi_i,
         *_rest) = self._inv_terms(r_s, th_f)
        dr_dl = g_rr_i * p_r_f
        dth_dl = g_thth_i * p_th_f
        dphi_dl = g_tphi_i * p_t + g_phiphi_i * p_phi

        sin_phi = jnp.sin(phi_f)
        cos_phi = jnp.cos(phi_f)
        vx = (sin_th * cos_phi * dr_dl
              + r_s * cos_th * cos_phi * dth_dl
              - r_s * sin_th * sin_phi * dphi_dl)
        vy = (sin_th * sin_phi * dr_dl
              + r_s * cos_th * sin_phi * dth_dl
              + r_s * sin_th * cos_phi * dphi_dl)
        vz = cos_th * dr_dl - r_s * sin_th * dth_dl

        bad_v = ~(jnp.isfinite(vx) & jnp.isfinite(vy)
                  & jnp.isfinite(vz))
        v_mag = jnp.sqrt(vx * vx + vy * vy + vz * vz)
        tiny_v = v_mag < 1e-30
        v_safe = jnp.where(tiny_v, 1.0, v_mag)
        final_alpha = jnp.arccos(jnp.clip(-vx / v_safe, -1.0, 1.0))

        nan = jnp.asarray(jnp.nan, dtype)
        invalid = bad_state | bad_v
        status = jnp.where(
            is_captured, -1,
            jnp.where(invalid, 0, 1)).astype(jnp.int32)
        final_alpha = jnp.where(
            is_captured | invalid | tiny_v, nan, final_alpha)
        n_half = jnp.where(bad_state & ~is_captured, 0, n_half)
        return status, final_alpha, n_half

    def alpha_crit(self, r_obs, theta_obs=None, n_azimuth: int = 16,
                   iters: int = 26, max_steps: int = 60000) -> float:
        """Critical angle by bisection on traced outcomes — no closed
        form exists for a general metric (models/numeric.py).
        alpha_crit_override short-circuits it (multi-center metrics)."""
        if self.alpha_crit_override is not None:
            return float(self.alpha_crit_override)
        return alpha_crit_traced(self, r_obs, theta_obs,
                                 n_azimuth=n_azimuth, iters=iters,
                                 max_steps=max_steps)
