"""Volumetric radiative-transfer rendering (RIAF / hot-flow images).

No reference counterpart (the reference renders lensed backgrounds and
thin disks of zero geometric thickness); this module adds the
observational mode behind horizon-scale images of M87*/Sgr A*: emission
from a geometrically thick plasma integrated along each geodesic —
optically thin by default, with optional self-absorption
(RIAFConfig.alpha0) — producing the classic asymmetric
photon-ring-plus-crescent morphology.

Physics
-------
For an optically thin medium the observed intensity per pixel is the
path integral

    I_obs = integral  g^p  j_rest(r, theta)  dlambda

along the (backward-traced) null geodesic, with g = nu_obs / nu_em the
combined gravitational + Doppler shift of the local emitter.  I_nu/nu^3
Lorentz invariance gives p = 3 + spectral_index for a rest-frame
power-law spectrum j_nu ~ nu^-index observed at fixed frequency; p = 4
for bolometric intensity.  The integral is direction-independent, so
tracing camera->source accumulates the same value.

With absorption (alpha0 > 0) the full transfer equation
dI/ds = j - alpha I applies; its formal solution along the backward
trace is

    I_obs = integral  g^p j_rest  exp(-tau(lambda))  dlambda,
    tau(lambda) = integral_0^lambda  chi  dlambda'     (from the camera)

with chi = nu_local alpha_nu = alpha_rest / g the invariant opacity.
The gray-opacity model alpha_rest = alpha0 j_rest gives a uniform
source function S = j/alpha = 1/alpha0, so saturated (tau >> 1) lines
of sight converge to S — the analytic oracle of the test suite. Both
tau and I ride the adaptive integrator as coupled error-controlled
state components, so the controller resolves the photosphere (the
tau ~ 1 transition) with the same tolerance discipline as the
geodesic. Unlike the thin integral, the absorbed one is
direction-DEPENDENT (the near side screens the far side): the
crescent asymmetry deepens and the lensed far-side image dims first
as alpha0 grows.

Flow field: the plasma orbits with Keplerian angular velocity
Omega_K(r) (spherical-radius convention of the standard analytic RIAF
models; the charged generalization of disk.keplerian_omega applies for
Q != 0) wherever that circular orbit is timelike, falling back to the
ZAMO angular velocity Omega_Z = a W / A inside (always timelike outside
the horizon).  The redshift is then the standard circular-emitter form

    g = sqrt(-(g_tt + 2 Omega g_tph + Omega^2 g_phph)) / (1 - Omega xi)

with xi = L/E the photon's conserved azimuthal impact parameter —
exactly disk.keplerian_redshift evaluated OFF the equatorial plane with
the covariant Boyer-Lindquist components, generalized to charged
metrics through the Kerr hot-path hooks (_two_M_r / _Delta_b).

Emissivity profiles (rest frame):
  * "torus":    exp(-(r - r_peak)^2 / 2 sigma_r^2 - cos^2(theta) / 2 h^2)
                — the Gaussian torus of analytic hot-flow models.
  * "powerlaw": (r / r_peak)^index * exp(-cos^2(theta) / 2 h^2)
                — RIAF-style density falloff with a Gaussian vertical
                profile in cos(theta) (scale height h in cos-angle).
  * "shell":    sigmoid((r - shell_in)/w) * sigmoid((shell_out - r)/w)
                — a uniform-emissivity spherical shell with smoothed
                edges; the flat-space chord-length oracle of the test
                suite (tests/test_volumetric.py).

Integration: the emissivity weight rides the adaptive integrator as an
error-controlled 6th state component (ops/kerr_trace.py extra_rhs), so
the DP45/DOP853 controller resolves the emission profile with the same
tolerance discipline as the geodesic itself — including through the
near-flat far field, where a side accumulator would be silently
under-sampled by the ~5x-per-step growth of dynamics-limited steps.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu import camera
from light_path_tracer_tpu.disk import (_scene_metric, _tone_map,
                                        covariant_tphi_components,
                                        keplerian_omega)
from light_path_tracer_tpu.ops.kerr_trace import (CAPTURED, INVALID,
                                                  trace_rays_volumetric)
from light_path_tracer_tpu.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu.utils.timing import StageTimer


@dataclasses.dataclass(frozen=True)
class RIAFConfig:
    """Hot-flow emission model (rest-frame emissivity + flow field)."""

    profile: str = "torus"         # "torus" | "powerlaw" | "shell" | "jet"
    r_peak: float = 4.5            # torus center / powerlaw pivot [M]
    sigma_r: float = 1.5           # torus radial Gaussian width [M]
    h_cos: float = 0.3             # vertical Gaussian width in cos(theta)
    index: float = -1.5            # powerlaw exponent
    shell_in: float = 0.0          # shell inner radius [M]
    shell_out: float = 0.0         # shell outer radius [M]
    edge_width: float = 0.2        # shell edge smoothing [M]
    g_power: float = 3.0           # redshift weight exponent p = 3 + s
    #   (s = rest-frame spectral index of j_nu ~ nu^-s)
    prograde: bool = True          # flow rotation sense
    tone_map: str = "sqrt"         # display transfer ("linear"/"sqrt"/"asinh")
    alpha0: float = 0.0            # opacity scale [1/M] at the fiducial
    #   frequency: rest-frame absorption alpha_rest = alpha0 * j_rest,
    #   so the source function S = j/alpha = 1/alpha0 is uniform there.
    #   0 = optically thin.
    opacity_index: float = 0.0     # q in alpha_nu ~ nu^-q (0 = gray;
    #   synchrotron-like q = s + 5/2). Only multi-frequency rendering
    #   (render_volumetric_spectrum) distinguishes q from 0: the
    #   single-band path IS the q-independent fiducial frequency.
    # Orbiting hot-spot blob (flare movies, render_volumetric_movie):
    # a 3-D Gaussian of emissivity spot_amp riding the Keplerian flow
    # on a circular equatorial orbit of radius spot_r, evaluated at
    # each pixel's RETARDED time. 0 = no spot.
    spot_amp: float = 0.0          # blob peak emissivity (adds to j)
    spot_r: float = 6.0            # blob orbit radius [M]
    spot_sigma: float = 1.0       # blob Gaussian size [M]
    spot_phase: float = 0.0        # blob azimuth at t = 0 [rad]
    # Relativistic jet / outflow (profile="jet"): a hollow BIPOLAR
    # cone of emissivity around the polar axis (Gaussian in |cos th|
    # about jet_cos, radial powerlaw `index` from r_peak, base tapered
    # at jet_r_base over edge_width) whose emitter moves RADIALLY
    # outward at speed jet_beta as measured by the local ZAMO — the
    # analytic M87-style funnel. jet_beta produces the iconic
    # one-sided beaming: the approaching cone brightens by the
    # relativistic Doppler factor to the g_power.
    jet_cos: float = 0.9           # cone center in |cos theta|
    jet_sigma: float = 0.06       # cone thickness in |cos theta|
    jet_beta: float = 0.0          # ZAMO-frame outflow speed [c]
    jet_r_base: float = 2.0       # emission base radius [M]


@functools.lru_cache(maxsize=64)
def _profile_fns(metric, riaf: RIAFConfig):
    """(j_rest(r, c), g_clipped(y5, p_t, p_phi)) — the shared building
    blocks of every transfer function (single-band and spectral)."""
    M = float(metric.M)
    a = float(metric.a)
    Q = float(getattr(metric, "Q", 0.0))

    def _j_rest(r, c):
        """Rest-frame emissivity profile j(r, cos theta)."""
        if riaf.profile == "torus":
            return jnp.exp(-(r - riaf.r_peak) ** 2
                           / (2.0 * riaf.sigma_r ** 2)
                           - c * c / (2.0 * riaf.h_cos ** 2))
        if riaf.profile == "powerlaw":
            return ((jnp.maximum(r, 1e-3) / riaf.r_peak) ** riaf.index
                    * jnp.exp(-c * c / (2.0 * riaf.h_cos ** 2)))
        if riaf.profile == "jet":
            # Bipolar hollow cone: Gaussian in |cos theta| about
            # jet_cos, radial powerlaw from r_peak, smooth base taper
            # (hard edges would grind the embedded error estimator).
            c_abs = jnp.abs(c)
            return (jnp.exp(-(c_abs - riaf.jet_cos) ** 2
                            / (2.0 * riaf.jet_sigma ** 2))
                    * (jnp.maximum(r, 1e-3) / riaf.r_peak) ** riaf.index
                    * jax.nn.sigmoid((r - riaf.jet_r_base)
                                     / riaf.edge_width))
        # shell — smoothed edges keep the RHS C^inf for the embedded
        # error estimator (a hard step would grind h -> h_min at the
        # boundary and poison the lane).
        return (jax.nn.sigmoid((r - riaf.shell_in) / riaf.edge_width)
                * jax.nn.sigmoid((riaf.shell_out - r)
                                 / riaf.edge_width))

    def _g_clipped(y5, p_t, p_phi):
        """Circular-emitter redshift g = nu_obs/nu_em off the plane,
        clipped to [0, 10] — the clip bounds the measure-zero beaming
        caustic where 1 - Omega xi -> 0 (it would otherwise put a
        single unresolved spike lane in charge of the tone-map peak).
        Absorption's 1/g separately floors g at 0.1 to keep the
        invariant opacity finite at the horizon-grazing extreme."""
        r, th = y5[0], y5[1]
        c = jnp.cos(th)
        s2 = jnp.maximum(1.0 - c * c, 1e-12)
        W = metric._two_M_r(r)          # 2Mr (Kerr) / 2Mr - Q^2 (KN)
        Delta = metric._Delta_b(r)
        ra2 = r * r + a * a
        A = ra2 * ra2 - a * a * Delta * s2
        # Covariant Boyer-Lindquist t-phi block off the plane.
        g_tt, g_tph, g_pp = covariant_tphi_components(metric, r, c)
        om_k = keplerian_omega(M, a, r, riaf.prograde, Q=Q)
        om_z = a * W / jnp.maximum(A, 1e-30)   # ZAMO: -g_tph/g_pp

        def timelike(om):
            return -(g_tt + 2.0 * om * g_tph + om * om * g_pp)

        # Keplerian where that orbit is timelike (it stops being
        # one inside the photon region / near the axis), ZAMO
        # inside — the emissivity profiles taper there anyway.
        om = jnp.where(timelike(om_k) > 1e-3, om_k, om_z)
        den = jnp.maximum(timelike(om), 1e-12)
        xi = p_phi / jnp.maximum(-p_t, 1e-30)
        g = jnp.sqrt(den) / jnp.maximum(1.0 - om * xi, 1e-3)
        return jnp.clip(g, 0.0, 10.0)

    def _g_jet(y5, p_t, p_phi):
        """Radially-boosted-ZAMO emitter redshift for the jet flow:
        u = Gamma (e_that + beta e_rhat) in the ZAMO tetrad
        (e_that = (A/(Sigma Delta))^(1/2) (d_t + omega d_phi),
        e_rhat = (Delta/Sigma)^(1/2) d_r), so with E = -p_t

            1/g = -p.u/E
                = Gamma [ (1 - omega xi) / alpha_lapse
                          + beta sqrt(Delta/Sigma) p_r / E ]

        where p_r is the TRACED radial momentum: the physical photon
        traverses the path the other way ((t, phi) -> (-t, -phi)
        reversal keeps p_t, p_phi and flips p_r), so the physical
        p_r^phys = -p_r^traced and the sign above is + (calibrated
        against the special-relativistic Doppler 1/(Gamma(1 - beta
        cos chi)) on a far weak-field cone in tests/test_volumetric.py;
        beta = 0 reduces EXACTLY to the ZAMO branch of _g_clipped).
        Same [0, 10] clip rationale as the circular flow."""
        r, th = y5[0], y5[1]
        p_r = y5[3]
        c = jnp.cos(th)
        s2 = jnp.maximum(1.0 - c * c, 1e-12)
        W = metric._two_M_r(r)
        Delta = jnp.maximum(metric._Delta_b(r), 1e-12)
        Sigma = jnp.maximum(r * r + a * a * c * c, 1e-12)
        ra2 = r * r + a * a
        A = jnp.maximum(ra2 * ra2 - a * a * Delta * s2, 1e-30)
        om = a * W / A
        alpha_lapse = jnp.sqrt(Sigma * Delta / A)
        beta = float(riaf.jet_beta)
        # Python float (weak-typed): an np.float64 scalar here would
        # silently promote the f32 while_loop carry and break the
        # carry-type invariant.
        gamma = float(1.0 / np.sqrt(max(1.0 - beta * beta, 1e-12)))
        e_inv = jnp.maximum(-p_t, 1e-30)
        xi = p_phi / e_inv
        inv_g = gamma * ((1.0 - om * xi)
                         / jnp.maximum(alpha_lapse, 1e-6)
                         + beta * jnp.sqrt(Delta / Sigma)
                         * p_r / e_inv)
        g = 1.0 / jnp.maximum(inv_g, 0.1)
        return jnp.clip(g, 0.0, 10.0)

    if riaf.profile == "jet":
        return _j_rest, _g_jet
    return _j_rest, _g_clipped


@functools.lru_cache(maxsize=64)
def make_transfer_fns(metric, riaf: RIAFConfig):
    """(emission_fn, absorption_fn) for the radiative-transfer trace,
    cached per (metric, config) so the returned function objects are
    stable across calls (they are jit static arguments of
    trace_rays_volumetric).

    emission_fn(y5, p_t, p_phi) -> g^p * j_rest(r, theta).
    absorption_fn(y5, p_t, p_phi) -> invariant opacity chi =
    alpha_rest / g with the gray opacity alpha_rest = alpha0 * j_rest
    (uniform source function S = 1/alpha0; the 1/g is the nu_local
    frequency factor of the invariant opacity nu alpha_nu at fixed
    observed frequency). None when alpha0 == 0 (optically thin).
    g_power == 0 is the pure-geometry oracle mode: no redshift
    machinery anywhere, chi = alpha0 * j_rest exactly.

    Works for Kerr and the charged families (the covariant components
    below use the _two_M_r / _Delta_b hooks: W = 2Mr for Kerr,
    2Mr - Q^2 for Kerr-Newman/Reissner-Nordstrom, and keplerian_omega
    carries the matching charged orbit form).  Johannsen-Psaltis is
    rejected for the same reason disk mode rejects it: the flow model
    (Keplerian Omega, circular-orbit redshift) is a Kerr/charged
    closed form.
    """
    if getattr(metric, "eps3", 0.0):
        raise ValueError("volumetric mode is not wired for "
                         "Johannsen-Psaltis (eps3 != 0): the flow "
                         "field (Keplerian Omega, circular-emitter "
                         "redshift) is a Kerr/charged closed form")
    if riaf.profile not in ("torus", "powerlaw", "shell", "jet"):
        raise ValueError(f"profile must be 'torus', 'powerlaw', "
                         f"'shell' or 'jet', got {riaf.profile!r}")
    if not 0.0 <= riaf.jet_beta < 1.0:
        raise ValueError(f"jet_beta must be in [0, 1), got "
                         f"{riaf.jet_beta}")
    if riaf.profile == "shell" and not riaf.shell_out > riaf.shell_in:
        raise ValueError("shell profile needs shell_out > shell_in")
    if riaf.alpha0 < 0.0:
        raise ValueError(f"alpha0 must be >= 0, got {riaf.alpha0}")
    _j_rest, _g_clipped = _profile_fns(metric, riaf)

    if riaf.g_power == 0.0:             # pure path length (oracles)
        def emission_fn(y5, p_t, p_phi):
            return _j_rest(y5[0], jnp.cos(y5[1]))

        def absorption_fn(y5, p_t, p_phi):
            return riaf.alpha0 * _j_rest(y5[0], jnp.cos(y5[1]))
    else:
        def emission_fn(y5, p_t, p_phi):
            j = _j_rest(y5[0], jnp.cos(y5[1]))
            return j * _g_clipped(y5, p_t, p_phi) ** riaf.g_power

        def absorption_fn(y5, p_t, p_phi):
            j = _j_rest(y5[0], jnp.cos(y5[1]))
            g = jnp.maximum(_g_clipped(y5, p_t, p_phi), 0.1)
            return riaf.alpha0 * j / g

    return emission_fn, (absorption_fn if riaf.alpha0 > 0.0 else None)


def make_emission_fn(metric, riaf: RIAFConfig):
    """The emission half of make_transfer_fns (same cached object)."""
    return make_transfer_fns(metric, riaf)[0]


@functools.lru_cache(maxsize=64)
def make_spectral_transfer(metric, riaf: RIAFConfig, freqs: tuple):
    """transfer_fn for trace_rays_spectral: multi-frequency
    self-absorbed transfer with power-law spectra, ALL bands in one
    trace.

    Rest frame: j_nu ~ j_rest(r, theta) nu^-s with s = g_power - 3,
    alpha_nu ~ alpha0 j_rest(r, theta) nu^-q with q = opacity_index
    (both normalized at the fiducial frequency nu0 = 1; freqs are
    nu_i/nu0). The invariant transfer at observed frequency f_i then
    separates:

        tau_i(lambda) = f_i^(1-q) * tau_hat(lambda),
        d tau_hat / d lambda = alpha0 j_rest g^(q-1)
        d I_i / d lambda = f_i^-s  j_rest g^(3+s)  exp(-f_i^(1-q)
                                                       tau_hat)

    so ONE reduced optical-depth integral serves every band — the
    state carries (tau_hat, I_1..I_n) and the geodesic is traced once.
    At f = 1, q = 0 this reproduces the single-band absorption path
    exactly (oracle-tested). Frequency-dependent opacity is what makes
    the photosphere nu-dependent: lower frequencies are absorbed
    deeper into the flow, so the image grows and the spectrum turns
    over (thick slope f^(q-s) rising, thin slope f^-s) — the
    synchrotron-self-absorption phenomenology of Sgr A*/M87* spectra.

    g_power == 0 is again the pure-geometry oracle mode (no redshift
    machinery; s = -3 still applies the f_i^-s band scaling).
    """
    if not freqs or any(f <= 0 for f in freqs):
        raise ValueError(f"freqs must be positive, got {freqs!r}")
    make_transfer_fns(metric, riaf)               # validates the config
    _j_rest, _g_clipped = _profile_fns(metric, riaf)
    s = riaf.g_power - 3.0
    q = riaf.opacity_index
    c = tuple(float(f) ** (1.0 - q) for f in freqs)
    band_scale = tuple(float(f) ** (-s) for f in freqs)

    def transfer_fn(y, p_t, p_phi):
        j = _j_rest(y[0], jnp.cos(y[1]))
        if riaf.g_power == 0.0:                   # pure-geometry mode
            em = j
            chi_hat = riaf.alpha0 * j
        else:
            g = _g_clipped(y[:5], p_t, p_phi)
            em = j * g ** riaf.g_power
            chi_hat = (riaf.alpha0 * j
                       * jnp.maximum(g, 0.1) ** (q - 1.0))
        # tau_hat >= 0 physically, but RK stage PROBES (negative A
        # coefficients x large h) can drive it negative; unbounded
        # exp(+c|tau|) then overflows the stage derivative and the
        # controller reject-cycles forever (measured: a 200k-step
        # grind at c = 100). The floor only touches unphysical probe
        # states — accepted states never clip.
        tau_hat = jnp.maximum(y[5], -30.0 / max(max(c), 1.0))
        d_i = tuple(bs * em * jnp.exp(-ci * tau_hat)
                    for bs, ci in zip(band_scale, c))
        return (chi_hat, *d_i)

    return transfer_fn


@functools.lru_cache(maxsize=64)
def make_movie_transfer(metric, riaf: RIAFConfig, times: tuple):
    """transfer_fn for flare movies: ALL observer-time frames in one
    trace (rides trace_rays_spectral's generic coupled-extras state).

    State extras: (t, [tau,] I_1..I_n) — coordinate time from the
    camera integrates as an error-controlled component (dt/dlambda =
    metric.tdot), and frame k's emissivity evaluates the orbiting blob
    at the RETARDED emission time t_k - t(lambda): each pixel sees the
    blob where it WAS when that pixel's light left the flow. The blob
    is a flat-embedding 3-D Gaussian of peak spot_amp co-rotating with
    the Keplerian flow at spot_r (so the base flow's emitter redshift
    g is exactly the blob's Doppler). With alpha0 > 0 the STATIONARY
    base flow also absorbs (shared tau, blob treated as optically
    thin): extras gain the tau component.

    The GRAVITY-instrument Sgr A* flare-orbit phenomenology — and the
    whole movie costs ONE geodesic trace.
    """
    if riaf.spot_amp < 0.0:
        raise ValueError(f"spot_amp must be >= 0, got {riaf.spot_amp}")
    if not times:
        raise ValueError("times must be non-empty")
    make_transfer_fns(metric, riaf)               # validates the config
    _j_rest, _g_clipped = _profile_fns(metric, riaf)
    M = float(metric.M)
    a = float(metric.a)
    Q = float(getattr(metric, "Q", 0.0))
    om_spot = float(keplerian_omega(M, a, riaf.spot_r, riaf.prograde,
                                    Q=Q))
    R = riaf.spot_r
    two_sig2 = 2.0 * riaf.spot_sigma ** 2
    absorbing = riaf.alpha0 > 0.0

    def transfer_fn(y, p_t, p_phi):
        r, th, phi = y[0], y[1], y[2]
        c = jnp.cos(th)
        s = jnp.sin(th)        # signed on the double-cover chart: the
        # Cartesian embedding below maps (theta > pi, phi) to the same
        # point as (2pi - theta, phi + pi), so no folding is needed.
        j = _j_rest(r, c)
        t = y[5]
        # Blob center at the retarded time of frame k.
        def spot(t_k):
            phi_s = riaf.spot_phase + om_spot * (t_k - t)
            d2 = (r * r + R * R
                  - 2.0 * r * R * s * jnp.cos(phi - phi_s))
            return riaf.spot_amp * jnp.exp(-d2 / two_sig2)

        if riaf.g_power == 0.0:
            w = 1.0
            chi = riaf.alpha0 * j
        else:
            g = _g_clipped(y[:5], p_t, p_phi)
            w = g ** riaf.g_power
            chi = riaf.alpha0 * j / jnp.maximum(g, 0.1)
        tdot = metric.tdot(y[:5], p_t, p_phi)
        if absorbing:
            screen = jnp.exp(-jnp.maximum(y[6], -30.0))
            d_i = tuple(screen * w * (j + spot(tk)) for tk in times)
            return (tdot, chi, *d_i)
        d_i = tuple(w * (j + spot(tk)) for tk in times)
        return (tdot, *d_i)

    return transfer_fn


# Width of the equatorial-crossing bump in cos(theta): the smooth
# winding coordinate m integrates a unit-mass Gaussian each time the
# ray sweeps through the plane. Small vs the torus vertical extent
# (h_cos ~ 0.3) so order attribution smears only ~2 deg of latitude,
# large enough that the error controller resolves the bump in a few
# steps rather than grinding.
_ORDER_SIGMA = 0.03


@functools.lru_cache(maxsize=64)
def make_order_transfer(metric, riaf: RIAFConfig, n_orders: int):
    """transfer_fn for photon-ring decomposed volumetric transfer:
    the path emission binned by IMAGE ORDER, all orders in one trace.

    The state gains a smooth winding coordinate m with

        dm/dlambda = N(cos theta; 0, sigma) |d cos theta / dlambda|
                   = N(cos theta; 0, sigma) |sin theta| |p_theta| / Sigma,

    a unit-mass Gaussian bump swept once per equatorial crossing — so
    m counts the ray's plane crossings continuously and LOCALLY (no
    hot-loop recorder needed; Sigma = r^2 + a^2 cos^2 theta is the
    Boyer-Lindquist g_theta_theta of both Kerr and Kerr-Newman, and
    d theta/dlambda = p_theta / Sigma). Emission then lands in bucket
    n = floor(m) (clipped to the last bucket): order 0 is light
    emitted before the flow's midplane crossing — the direct image —
    order 1 the first lensed image, order >= 2 the exponentially
    demagnified photon subrings (Gralla-Holz-Wald). Extras layout
    (m, [tau,] I_0..I_{N-1}); absorption shares the single-band tau
    exactly as the movie transfer does. The buckets partition the
    emission, so the layers sum to the single-band image (pinned).
    """
    if n_orders < 2:
        raise ValueError(f"n_orders must be >= 2, got {n_orders}")
    make_transfer_fns(metric, riaf)               # validates the config
    _j_rest, _g_clipped = _profile_fns(metric, riaf)
    a2 = float(metric.a) ** 2
    absorbing = riaf.alpha0 > 0.0
    # Python floats (weak-typed): np.float64 scalars would promote the
    # f32 carry under enable_x64 and break the while_loop carry types.
    norm = float(1.0 / (_ORDER_SIGMA * np.sqrt(2.0 * np.pi)))
    inv_two_sig2 = float(1.0 / (2.0 * _ORDER_SIGMA ** 2))

    def transfer_fn(y, p_t, p_phi):
        r, th = y[0], y[1]
        c = jnp.cos(th)
        j = _j_rest(r, c)
        if riaf.g_power == 0.0:                   # pure-geometry mode
            em = j
            chi = riaf.alpha0 * j
        else:
            g = _g_clipped(y[:5], p_t, p_phi)
            em = j * g ** riaf.g_power
            chi = riaf.alpha0 * j / jnp.maximum(g, 0.1)
        sigma_bl = r * r + a2 * c * c
        dm = (norm * jnp.exp(-c * c * inv_two_sig2)
              * jnp.abs(jnp.sin(th)) * jnp.abs(y[4]) / sigma_bl)
        # Bucket of the CURRENT winding count; RK probe states can
        # push m slightly negative, clamp into bucket 0.
        bucket = jnp.floor(jnp.maximum(y[5], 0.0))
        if absorbing:
            em = em * jnp.exp(-jnp.maximum(y[6], -30.0))
        d_i = tuple(
            jnp.where(bucket == n, em, 0.0) if n < n_orders - 1
            else jnp.where(bucket >= n, em, 0.0)   # last bucket: n >= N-1
            for n in range(n_orders))
        if absorbing:
            return (dm, chi, *d_i)
        return (dm, *d_i)

    return transfer_fn


def render_volumetric_movie(scene: SceneConfig, resolution, times,
                            cfg: RenderConfig = RenderConfig(),
                            riaf: RIAFConfig = RIAFConfig(),
                            mesh=None):
    """Flare movie: every observer-time frame from ONE geodesic trace.

    times: observer coordinate times [M] of the frames (the blob
    orbits with period 2 pi / Omega_K(spot_r)). Returns (frames
    (n, H, W) float32 display maps — tone-mapped on a COMMON scale so
    brightness is comparable across frames, stats) with
    stats['emission'] the raw (n, H, W) intensities and
    stats['light_curve'] the per-frame integrated flux.
    mesh: row-striped tile DP (trace_spectral_grid_sharded).
    """
    metric = _scene_metric(scene)
    times = tuple(float(t) for t in times)
    transfer_fn = make_movie_transfer(metric, riaf, times)
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    absorbing = riaf.alpha0 > 0.0

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost)
        theta = camera.build_theta_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        # Extras layout (trace_rays_spectral is the generic coupled-
        # extras trace): "tau_hat" slot carries t; with absorption the
        # first "band" carries tau and the frames follow.
        n_extra_bands = len(times) + (1 if absorbing else 0)
        # Saturation monitor: the frame intensities only (index 0 is t,
        # which advances forever on a trapped orbiter; the optional tau
        # likewise — both are bookkeeping, not emission).
        frame0 = 1 + (1 if absorbing else 0)
        res = _trace_spectral(metric, scene, alpha.ravel(),
                              theta.ravel(), transfer_fn,
                              n_extra_bands, cfg, mesh, resolution,
                              sat_monitor=tuple(
                                  range(frame0, 1 + n_extra_bands)))
        out.append(res.status)

    bands = res.emission[1:] if absorbing else res.emission
    tau = (np.asarray(res.emission[0]).reshape(resolution)
           if absorbing else np.zeros(resolution))
    with timer.stage("render") as out:
        peak = jnp.maximum(
            jnp.max(jnp.stack([jnp.max(b) for b in bands])), 1e-30)
        frames = jnp.stack([
            _tone_map(b, riaf.tone_map, peak=peak).reshape(resolution)
            for b in bands]).astype(jnp.float32)
        out.append(frames)

    em = np.stack([np.asarray(b).reshape(resolution) for b in bands])
    status = np.asarray(res.status)
    stats = dict(
        times=np.asarray(times),
        light_curve=em.sum(axis=(1, 2)),
        emission=em,
        optical_depth=tau,
        t_max=float(np.asarray(res.tau_hat).max()),
        spot_period=(2.0 * np.pi / abs(float(keplerian_omega(
            float(metric.M), float(metric.a), riaf.spot_r,
            riaf.prograde, Q=float(getattr(metric, "Q", 0.0)))))),
        captured=int((status == CAPTURED).sum()),
        invalid=int((status == INVALID).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return frames, stats


def _trace_spectral(metric, scene, alpha, theta, transfer_fn, n_bands,
                    cfg, mesh, resolution, sat_monitor=None):
    """Dispatch a spectral/movie trace single-device or row-sharded
    over a mesh; returns a flat-raveled SpectralResult either way.

    sat_monitor: indices (into the FULL extras tuple) of the intensity
    components the emission-saturation exit watches (cfg.sat_window);
    None = the default band layout (tau_hat, I_1..I_n). Movie/order
    callers pass their own frame/bucket indices so bookkeeping
    components (t, winding m, tau) are never monitored."""
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_spectral
    if mesh is not None:
        from light_path_tracer_tpu.parallel.tiles import (
            trace_spectral_grid_sharded)
        res = trace_spectral_grid_sharded(
            metric, scene.r_obs, alpha.reshape(resolution),
            theta.reshape(resolution), scene.theta_obs, transfer_fn,
            n_bands, mesh=mesh, max_steps=cfg.max_steps,
            precision=cfg.precision, method=cfg.integrator,
            sat_window=cfg.sat_window, sat_monitor=sat_monitor)
        return res._replace(
            emission=tuple(e.ravel() for e in res.emission),
            tau_hat=res.tau_hat.ravel(),
            status=res.status.ravel())
    return trace_rays_spectral(
        metric, scene.r_obs, alpha, theta, scene.theta_obs,
        transfer_fn, n_bands, max(5000.0, 6.0 * scene.r_obs),
        cfg.max_steps, precision=cfg.precision, method=cfg.integrator,
        sat_window=cfg.sat_window, sat_monitor=sat_monitor)


def render_volumetric_spectrum(scene: SceneConfig, resolution, freqs,
                               cfg: RenderConfig = RenderConfig(),
                               riaf: RIAFConfig = RIAFConfig(),
                               mesh=None):
    """Multi-frequency self-absorbed images + spectrum from ONE trace.

    freqs: observed frequencies in units of the fiducial frequency
    (where alpha0 is normalized). Returns (images (n, H, W) float32
    display maps — each band tone-mapped independently, stats) with
    stats['emission'] the raw (n, H, W) band intensities,
    stats['flux'] the per-band image-integrated fluxes (the SED:
    rising thick side ~ f^(q-s), falling thin side ~ f^-s when
    opacity_index q > spectral index s = g_power-3), and
    stats['mean_radius_rad'] each band's emission-weighted angular
    radius — the frequency-dependent photosphere (lower frequencies
    image LARGER). stats['spectral_index'] holds per-pixel
    alpha = -d ln I / d ln nu maps between adjacent bands (NaN where
    either band is dark): optically thick pixels show the rising
    -(q - s), thin pixels the falling s. stats['tau_hat'] is the
    shared reduced optical-depth map (band i's tau = f_i^(1-q) *
    tau_hat). mesh: row-striped tile DP
    (parallel.tiles.trace_spectral_grid_sharded).
    """
    metric = _scene_metric(scene)
    freqs = tuple(float(f) for f in freqs)
    transfer_fn = make_spectral_transfer(metric, riaf, freqs)
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost)
        theta = camera.build_theta_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        # Default monitor = the band intensities (extras 1..n; index 0
        # is the shared reduced optical depth tau_hat).
        res = _trace_spectral(metric, scene, alpha.ravel(),
                              theta.ravel(), transfer_fn, len(freqs),
                              cfg, mesh, resolution)
        out.append(res.tau_hat)

    with timer.stage("render") as out:
        images = jnp.stack([
            _tone_map(em, riaf.tone_map).reshape(resolution)
            for em in res.emission]).astype(jnp.float32)
        out.append(images)

    em = np.stack([np.asarray(e).reshape(resolution)
                   for e in res.emission])
    # Emission-weighted angular radius per band (photosphere size).
    yy = (np.arange(height) - height / 2.0) * (fov[0] / height)
    xx = (np.arange(width) - width / 2.0) * (fov[1] / width)
    rad = np.hypot(yy[:, None], xx[None, :])
    flux = em.sum(axis=(1, 2))
    mean_r = (em * rad).sum(axis=(1, 2)) / np.maximum(flux, 1e-30)
    # Per-pixel spectral-index maps between adjacent bands,
    # alpha = -d ln I / d ln nu (positive = falling spectrum): the
    # observational SSA diagnostic — thick pixels show the RISING
    # alpha ~ -(q - s), thin pixels the falling alpha ~ s.
    spectral_index = []
    tiny = 1e-12 * max(float(em.max()), 1e-30)
    for i in range(len(freqs) - 1):
        good = (em[i] > tiny) & (em[i + 1] > tiny)
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha_map = -(np.log(em[i + 1]) - np.log(em[i])) \
                / np.log(freqs[i + 1] / freqs[i])
        spectral_index.append(np.where(good, alpha_map, np.nan))
    status = np.asarray(res.status)
    stats = dict(
        freqs=np.asarray(freqs),
        flux=flux,
        mean_radius_rad=mean_r,
        spectral_index=spectral_index,
        emission=em,
        tau_hat=np.asarray(res.tau_hat).reshape(resolution),
        captured=int((status == CAPTURED).sum()),
        invalid=int((status == INVALID).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return images, stats


def render_volumetric(scene: SceneConfig, resolution,
                      cfg: RenderConfig = RenderConfig(),
                      riaf: RIAFConfig = RIAFConfig(), mesh=None):
    """Volumetric hot-flow image; returns (image (H, W) float32 in
    [0, 1], stats).  stats['emission'] holds the raw (un-tone-mapped)
    per-pixel path integrals as a NumPy array for quantitative use
    (the visibility/observables pipeline takes it directly).

    The trace runs the XLA shared adaptive loop with the emission
    integrals as error-controlled extra state components.
    mesh: a jax.sharding.Mesh routes the trace through row-striped
    tile DP (parallel.tiles.trace_volumetric_grid_sharded).
    """
    metric = _scene_metric(scene)
    make_transfer_fns(metric, riaf)  # validate config before tracing
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost)
        theta = camera.build_theta_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost)
        out.append((alpha, theta))

    emission_fn, absorption_fn = make_transfer_fns(metric, riaf)
    with timer.stage("precompute") as out:
        if mesh is not None:
            from light_path_tracer_tpu.parallel.tiles import (
                trace_volumetric_grid_sharded)
            res = trace_volumetric_grid_sharded(
                metric, scene.r_obs, alpha, theta, scene.theta_obs,
                emission_fn, mesh=mesh, max_steps=cfg.max_steps,
                precision=cfg.precision, method=cfg.integrator,
                absorption_fn=absorption_fn, sat_window=cfg.sat_window)
        else:
            res = trace_rays_volumetric(
                metric, scene.r_obs, alpha.ravel(), theta.ravel(),
                scene.theta_obs, emission_fn,
                max(5000.0, 6.0 * scene.r_obs), cfg.max_steps,
                precision=cfg.precision, method=cfg.integrator,
                absorption_fn=absorption_fn, sat_window=cfg.sat_window)
        out.append(res.emission)

    with timer.stage("render") as out:
        image = _tone_map(res.emission, riaf.tone_map).reshape(
            resolution).astype(jnp.float32)
        out.append(image)

    status = np.asarray(res.status)
    tau = np.asarray(res.optical_depth).reshape(resolution)
    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs),
        captured=int((status == CAPTURED).sum()),
        invalid=int((status == INVALID).sum()),
        emission=np.asarray(res.emission).reshape(resolution),
        emission_total=float(np.asarray(res.emission).sum()),
        optical_depth=tau,
        tau_max=float(tau.max()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return image, stats


def render_volumetric_decomposed(scene: SceneConfig, resolution,
                                 cfg: RenderConfig = RenderConfig(),
                                 riaf: RIAFConfig = RIAFConfig(),
                                 n_orders: int = 3, mesh=None):
    """Photon-ring decomposition of a volumetric image from ONE trace.

    The EHT subring observable for continuous (hot-flow) emission:
    layer n collects the path emission picked up after n equatorial
    crossings (make_order_transfer's smooth winding coordinate), so
    n = 0 is the direct image of the flow, n = 1 the first lensed
    image, n >= 2 the exponentially demagnified photon subrings that
    pile up on the critical curve. The disk-mode analogue is
    disk.render_disk_decomposed (discrete crossings); here the
    decomposition rides the error-controlled transfer state, all
    orders in one integration. Absorption (riaf.alpha0 > 0) screens
    every order through the shared optical depth.

    Returns (layers, stats): layers (n_orders, H, W) RAW linear
    intensity float32 (tone-map for display — disk.decomposed_display
    shares the peak across orders); stats carries flux_per_order,
    flux_ratios, gamma_estimates (-ln ratio, the measured Lyapunov
    demagnification), mean_radius_rad per order, winding (the final
    m map), and the usual render stats. mesh: row-striped tile DP
    (trace_spectral_grid_sharded), same as the spectral path.
    """
    metric = _scene_metric(scene)
    transfer_fn = make_order_transfer(metric, riaf, n_orders)
    absorbing = riaf.alpha0 > 0.0
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost)
        theta = camera.build_theta_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        n_extra_bands = n_orders + (1 if absorbing else 0)
        # Saturation monitor: the order-bucket intensities only (index
        # 0 is the winding coordinate m, which grows every half-orbit
        # of a trapped photon-ring orbiter — exactly the lane the exit
        # is for; the optional tau likewise keeps accumulating).
        bucket0 = 1 + (1 if absorbing else 0)
        res = _trace_spectral(metric, scene, alpha.ravel(),
                              theta.ravel(), transfer_fn,
                              n_extra_bands, cfg, mesh, resolution,
                              sat_monitor=tuple(
                                  range(bucket0, 1 + n_extra_bands)))
        out.append(res.status)

    orders = res.emission[1:] if absorbing else res.emission
    tau = (np.asarray(res.emission[0]).reshape(resolution)
           if absorbing else np.zeros(resolution))
    with timer.stage("render") as out:
        # The bucket windows make the transfer integrand discontinuous
        # in lambda, so a nearly-empty order can accumulate tiny
        # NEGATIVE increments from rejected-probe overshoot; clamp —
        # intensities are physically nonnegative and the noise is far
        # below the partition tolerance.
        layers = jnp.stack([
            jnp.maximum(jnp.asarray(o).reshape(resolution), 0.0)
            for o in orders
        ]).astype(jnp.float32)
        out.append(layers)

    em = np.asarray(layers, np.float64)
    flux = em.sum(axis=(1, 2))
    yy = (np.arange(height) - height / 2.0) * (fov[0] / height)
    xx = (np.arange(width) - width / 2.0) * (fov[1] / width)
    rad = np.hypot(yy[:, None], xx[None, :])
    mean_r = (em * rad).sum(axis=(1, 2)) / np.maximum(flux, 1e-30)
    ratios = flux[1:] / np.maximum(flux[:-1], 1e-300)
    status = np.asarray(res.status)
    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs),
        flux_per_order=flux.tolist(),
        flux_ratios=ratios.tolist(),
        gamma_estimates=(-np.log(np.maximum(ratios, 1e-300))).tolist(),
        mean_radius_rad=mean_r.tolist(),
        winding=np.asarray(res.tau_hat).reshape(resolution),
        optical_depth=tau,
        captured=int((status == CAPTURED).sum()),
        invalid=int((status == INVALID).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return layers, stats
