"""Thin accretion-disk rendering with gravitational redshift + Doppler
beaming (BASELINE.json config 4 — an extension beyond the reference).

Model: a geometrically thin, optically configurable equatorial disk of
prograde Keplerian circular orbits between r_isco and r_out, with
power-law emissivity eps(r) ~ r^-q. Per pixel, the geodesic integrator
records up to two equatorial-plane crossings (primary + secondary image);
each contributes

    I_obs = g^p * eps(r_c),     g = E_obs / E_em = 1 / (u^t (1 - Omega xi))

where Omega = sqrt(M) / (r^{3/2} + a sqrt(M)) is the Keplerian angular
velocity, u^t follows from the circular-orbit normalization
u^t = 1/sqrt(-(g_tt + 2 Omega g_tphi + Omega^2 g_phiphi)), and
xi = L/E = p_phi/E is the ray's conserved azimuthal impact parameter —
so the full redshift (gravitational + special-relativistic Doppler) needs
only the crossing radius and the ray's conserved momenta. p = 3 gives the
standard bolometric beaming; p = 4 adds bandwidth compression.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from typing import NamedTuple

from light_path_tracer_tpu.models.kerr import Kerr
from light_path_tracer_tpu.models.kerr_newman import KerrNewman
from light_path_tracer_tpu.ops.kerr_trace import (
    dp45_integrate, finalize_angles, get_tols, RUNNING, INVALID, CAPTURED)
from light_path_tracer_tpu import camera
from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
from light_path_tracer_tpu.utils.timing import StageTimer


def _scene_metric(scene: "SceneConfig"):
    """Kerr, or Kerr-Newman when the scene is charged. The a = 0
    charged case routes through Kerr-Newman too: disk tracing needs
    the 5-D crossing-recorder machinery, which the orbit-equation
    Reissner-Nordstrom class does not carry (same geodesics — pinned
    against the RN orbit path in tests/test_kerr_newman.py)."""
    if getattr(scene, "eps3", 0.0):
        # The crossing recorder would work, but every emission quantity
        # (ISCO, Keplerian Omega, emitter redshift) is a Kerr/charged
        # closed form — silently Kerr-orbiting gas in a deformed
        # metric would be wrong physics, so disk mode rejects eps3.
        raise ValueError("this path is not wired for Johannsen-Psaltis "
                         "(eps3 != 0): disk orbital dynamics (ISCO, "
                         "Omega, redshift) are Kerr/charged closed "
                         "forms and sequences trace (Traced)Kerr. "
                         "Deformed metrics support shadow/lens/"
                         "magnification/AA/trajectory surfaces.")
    q = getattr(scene, "Q", 0.0)
    if q:
        return KerrNewman(M=scene.M, a=scene.a, Q=q)
    return Kerr(M=scene.M, a=scene.a)


@dataclasses.dataclass(frozen=True)
class DiskConfig:
    r_out: float = 20.0            # outer edge in units of M
    r_in: float | None = None      # None -> r_isco
    emissivity_index: float = 3.0  # eps(r) ~ r^-q (powerlaw spectrum)
    g_power: float = 3.0           # I_obs = g^p * eps (powerlaw spectrum)
    opaque: bool = True            # first crossing blocks deeper images
    prograde: bool = True          # orbit sense vs the BH spin
    # Misaligned (tilted) disk: inclination of the disk plane from the
    # equator [rad] and the azimuth of its line of nodes [rad]. The
    # crossing GEOMETRY is exact; the EMITTER model keeps the
    # equatorial Keplerian Omega/redshift formulas at the crossing
    # radius — exact for tilt=0, exact for a=0 at any tilt (spherical
    # symmetry), approximate for tilted Kerr disks (ignores
    # frame-dragging misalignment, O(a sin(tilt)) in the shift; real
    # tilted Kerr disks also precess — Lense-Thirring — which a static
    # image does not show). XLA backend only (the fused kernel records
    # equatorial crossings only).
    tilt: float = 0.0
    tilt_azimuth: float = 0.0
    # Warped (Bardeen-Petterson) disk: inner regions align with the
    # equator under Lense-Thirring torque while the outer disk keeps
    # the tilt — modeled as the smooth profile
    #   iota(r) = tilt / (1 + (warp_radius / r)^4),
    # i.e. iota -> 0 well inside warp_radius and -> tilt outside.
    # None = flat tilted plane. Same emitter caveats as `tilt`.
    warp_radius: float | None = None
    max_hits: int = 2
    tone_map: str = "asinh"        # "asinh" | "linear" | "sqrt"
    # "powerlaw": grayscale I = g^p * r^-q (the original config-4 model).
    # "blackbody": physically colored — Shakura-Sunyaev temperature
    # profile, T_obs = g * T_em (a shifted Planck spectrum is exactly a
    # Planck spectrum at the shifted temperature), bolometric intensity
    # ~ T_obs^4 (the g^4 beaming), chromaticity from utils/color.py.
    spectrum: str = "powerlaw"
    t_peak: float = 9000.0         # blackbody: peak disk temperature [K]


def disk_basis(tilt: float, tilt_azimuth: float):
    """(normal, e1, e2) of the disk plane: columns of R_z(lam) R_x(tilt)
    acting on (z, x, y). tilt=0 gives n=z, e1=x, e2=y — the recorded
    in-plane azimuth then equals the chart azimuth."""
    si, ci = np.sin(tilt), np.cos(tilt)
    sl, cl = np.sin(tilt_azimuth), np.cos(tilt_azimuth)
    n = (si * sl, -si * cl, ci)
    e1 = (cl, sl, 0.0)
    e2 = (-sl * ci, cl * ci, si)
    return (tuple(map(float, n)), tuple(map(float, e1)),
            tuple(map(float, e2)))


def warped_basis(tilt: float, tilt_azimuth: float, warp_radius: float,
                 power: float = 4.0):
    """Radius-dependent disk basis for a Bardeen-Petterson warp:
    iota(r) = tilt / (1 + (warp_radius/r)^power), same R_z(lam) R_x
    convention as disk_basis. Returns a jax-traceable callable
    r -> ((n), (e1), (e2)) for dp45_integrate(disk_normal=...)."""
    sl, cl = float(np.sin(tilt_azimuth)), float(np.cos(tilt_azimuth))

    def basis(r):
        iota = tilt / (1.0 + (warp_radius / jnp.maximum(r, 1e-6))
                       ** power)
        si, ci = jnp.sin(iota), jnp.cos(iota)
        zero = jnp.zeros_like(si)
        n = (si * sl, -si * cl, ci)
        e1 = (cl + zero, sl + zero, zero)
        e2 = (-sl * ci, cl * ci, si)
        return n, e1, e2

    return basis


def _circular_orbit_energy(M, a, Q, r, prograde):
    """Specific energy E of an equatorial circular geodesic at radius r
    (numpy, host-side). E(r) has its minimum exactly at the ISCO."""
    x2 = M * r - Q * Q
    x = np.sqrt(np.maximum(x2, 0.0))
    s = 1.0 if prograde else -1.0
    omega = s * x / (r * r + s * a * x)
    w = (2.0 * M * r - Q * Q) / (r * r)
    g_tt = -(1.0 - w)
    g_tphi = -a * w
    g_phiphi = r * r + a * a + a * a * w
    norm = -(g_tt + 2.0 * omega * g_tphi + omega * omega * g_phiphi)
    bad = (norm <= 1e-12) | (x2 <= 0.0)
    e = -(g_tt + omega * g_tphi) / np.sqrt(np.where(bad, 1.0, norm))
    return np.where(bad, np.inf, e)


def r_isco(M: float, a: float, prograde: bool = True,
           Q: float = 0.0) -> float:
    """Innermost stable circular orbit radius.

    Q = 0: Bardeen-Press-Teukolsky closed form. Q != 0 (Reissner-
    Nordstrom / Kerr-Newman): no closed form — found as the minimum of
    the circular-orbit energy E(r) (dE/dr = 0 IS the marginal-
    stability condition), grid-bracketed then refined by ternary
    search. Checks: Q=0 reduces to BPT, extremal RN (a=0, Q=M) gives
    the known 4M, charge shrinks the ISCO monotonically
    (tests/test_kerr_newman.py)."""
    if Q:
        r_plus = M + np.sqrt(max(M * M - a * a - Q * Q, 0.0))
        rs = np.linspace(1.005 * r_plus, 12.0 * M, 8001)
        e = _circular_orbit_energy(M, a, Q, rs, prograde)
        i = int(np.argmin(e))
        lo = rs[max(i - 1, 0)]
        hi = rs[min(i + 1, len(rs) - 1)]
        for _ in range(200):
            m1 = lo + (hi - lo) / 3.0
            m2 = hi - (hi - lo) / 3.0
            e1 = _circular_orbit_energy(M, a, Q, np.asarray(m1),
                                        prograde)
            e2 = _circular_orbit_energy(M, a, Q, np.asarray(m2),
                                        prograde)
            if e1 < e2:
                hi = m2
            else:
                lo = m1
        return float(0.5 * (lo + hi))
    chi = a / M
    z1 = 1.0 + (1.0 - chi**2) ** (1.0 / 3.0) * (
        (1.0 + chi) ** (1.0 / 3.0) + (1.0 - chi) ** (1.0 / 3.0))
    z2 = np.sqrt(3.0 * chi**2 + z1**2)
    sign = -1.0 if prograde else 1.0
    return float(M * (3.0 + z2 + sign * np.sqrt(
        (3.0 - z1) * (3.0 + z1 + 2.0 * z2))))


def disk_temperature(r_c, r_in, t_peak):
    """Shakura-Sunyaev thin-disk effective temperature, batched.

    T(r) ~ [ (1 - sqrt(r_in/r)) / r^3 ]^(1/4) (SS73 zero-torque inner
    boundary; the fully relativistic Novikov-Thorne factors are a
    documented simplification), normalized so the profile's maximum —
    at r = (49/36) r_in — equals t_peak.
    """
    x = r_in / jnp.maximum(r_c, r_in)
    f = x ** 3 * (1.0 - jnp.sqrt(x))
    f_max = (36.0 / 49.0) ** 3 * (1.0 - 6.0 / 7.0)
    return t_peak * (jnp.maximum(f, 0.0) / f_max) ** 0.25


def covariant_tphi_components(metric, r, c):
    """Covariant Boyer-Lindquist (g_tt, g_tphi, g_phiphi) OFF the
    equatorial plane at (r, cos theta = c), read through the charged
    metric hooks (W = 2Mr for Kerr, 2Mr - Q^2 for Kerr-Newman) — the
    t-phi block every circular-emitter redshift needs (volumetric
    flows, rotating stellar surfaces)."""
    a = float(metric.a)
    s2 = jnp.maximum(1.0 - c * c, 1e-12)
    Sigma = r * r + a * a * c * c
    W = metric._two_M_r(r)
    ra2 = r * r + a * a
    g_tt = -(1.0 - W / Sigma)
    g_tph = -a * W * s2 / Sigma
    g_pp = (ra2 + a * a * W * s2 / Sigma) * s2
    return g_tt, g_tph, g_pp


def keplerian_redshift(M, a, r_c, xi, prograde: bool = True,
                       Q: float = 0.0):
    """g = 1 / (u^t (1 - Omega xi)) for a Keplerian circular emitter.

    Batched over crossing radii r_c and per-ray xi = L/E.
    Omega = +-sqrt(M) / (r^1.5 +- a sqrt(M)) (upper signs prograde,
    lower retrograde — Bardeen-Press-Teukolsky circular orbits); with
    charge, +-x / (r^2 +- a x) with x = sqrt(M r - Q^2), and the
    equatorial covariant components gain the (2Mr - Q^2)/r^2
    combination (static branch: Q=0 paths are bitwise-unchanged).
    """
    if Q:
        x = jnp.sqrt(jnp.maximum(M * r_c - Q * Q, 0.0))
        s = 1.0 if prograde else -1.0
        omega = s * x / (r_c * r_c + s * a * x)
        w = (2.0 * M * r_c - Q * Q) / (r_c * r_c)
        g_tt = -(1.0 - w)
        g_tphi = -a * w
        g_phiphi = r_c * r_c + a * a + a * a * w
    else:
        sqrtM = jnp.sqrt(M)
        if prograde:
            omega = sqrtM / (r_c ** 1.5 + a * sqrtM)
        else:
            omega = -sqrtM / (r_c ** 1.5 - a * sqrtM)
        # Equatorial covariant metric components.
        g_tt = -(1.0 - 2.0 * M / r_c)
        g_tphi = -2.0 * M * a / r_c
        g_phiphi = r_c * r_c + a * a + 2.0 * M * a * a / r_c
    norm = -(g_tt + 2.0 * omega * g_tphi + omega * omega * g_phiphi)
    u_t = 1.0 / jnp.sqrt(jnp.maximum(norm, 1e-12))
    g = 1.0 / (u_t * (1.0 - omega * xi))
    return jnp.maximum(g, 0.0)


class DiskTraceResult(NamedTuple):
    """Per-ray disk-mode trace output.

    final_alpha / n_half are the escape heading + winding of the ray's
    FINAL state (NaN final_alpha for captured/invalid): for a
    translucent disk that is the true escape heading (rays integrate
    through the plane), for an opaque disk it is only meaningful on
    rays with n_hits == 0 (disk-hit rays park at the crossing). The
    composite renderer (render_scene_with_disk) keys off exactly that.
    """
    status: jnp.ndarray
    n_hits: jnp.ndarray
    r_hits: tuple
    xi: jnp.ndarray
    n_steps: jnp.ndarray
    final_alpha: jnp.ndarray
    n_half: jnp.ndarray
    phi_hits: tuple = ()   # in-plane azimuth at each crossing (physical)
    xi_hits: tuple = ()    # tilted disks: n.L/E at each crossing
    pr_hits: tuple = ()    # p_r of the localized crossing state
    pth_hits: tuple = ()   # p_theta of the localized crossing state
    t_hits: tuple = ()     # coordinate time camera->crossing (opt-in,
    #                        record_time: the light-travel delay)
    t_end: jnp.ndarray = ()  # coordinate time at capture/escape
    #                          (record_time; oracle-tested vs the
    #                          analytic Schwarzschild radial integral)


def trace_disk_rays(metric, r_obs, alphas, thetas, theta_obs,
                    lambda_max: float, max_steps: int, disk: DiskConfig,
                    backend: str = "auto", precision: str = "fast",
                    method: str = "dp45",
                    record_momentum: bool = False,
                    record_time: bool = False) -> DiskTraceResult:
    """Trace rays recording equatorial crossings; returns DiskTraceResult.
    backend / precision as in trace_batch; method = "dp45" | "dop853"
    (the crossing recorder needs the adaptive shared loop, so the
    fixed-step "rk4" comparison integrator is not available here)."""
    if method not in ("dp45", "dop853"):
        raise ValueError(
            f"disk mode supports integrator 'dp45' or 'dop853' (the "
            f"crossing recorder lives in the adaptive loop), got "
            f"{method!r}")
    from light_path_tracer_tpu.ops.batch import _kerr_backend
    resolved = _kerr_backend(backend, alphas.dtype, metric)
    if disk.tilt != 0.0 or disk.warp_radius is not None or record_time:
        # The fused kernel records equatorial crossings only: tilted and
        # warped planes (atan2 in the loop) and crossing times stay on
        # the XLA path.
        resolved = "xla"
    r_in = disk.r_in if disk.r_in is not None else r_isco(
        metric.M, metric.a, disk.prograde,
        Q=getattr(metric, "Q", 0.0))
    plane = (float(r_in), float(disk.r_out), float(np.pi / 2),
             bool(disk.opaque))
    if resolved == "pallas":
        from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
            trace_disk_rays_pallas)
        return trace_disk_rays_pallas(
            metric, float(r_obs), alphas, thetas, float(theta_obs),
            float(lambda_max), max_steps, plane, disk.max_hits,
            precision=precision, method=method,
            record_momentum=record_momentum)
    return _trace_disk_rays_xla(
        metric, float(r_obs), alphas, thetas, float(theta_obs),
        float(lambda_max), max_steps, disk, precision, method,
        record_momentum, record_time)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "lambda_max",
                     "max_steps", "disk", "precision", "method",
                     "record_momentum", "record_time"))
def _trace_disk_rays_xla(metric, r_obs, alphas, thetas, theta_obs,
                         lambda_max: float, max_steps: int,
                         disk: DiskConfig, precision: str = "fast",
                         method: str = "dp45",
                         record_momentum: bool = False,
                         record_time: bool = False):
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)
    r_in = disk.r_in if disk.r_in is not None else r_isco(
        metric.M, metric.a, disk.prograde,
        Q=getattr(metric, "Q", 0.0))

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    status0 = jnp.where(invalid0, INVALID, RUNNING).astype(jnp.int32)
    atol = jnp.full_like(alphas, tols["atol"])
    rtol = jnp.full_like(alphas, tols["rtol"])

    y_f, status_f, _lam, steps, hits = dp45_integrate(
        metric, y0, p_t, p_phi, status0,
        atol=atol, rtol=rtol, h_min=jnp.asarray(tols["h_min"], dtype),
        tiny_err=tols["tiny_err"],
        r_capture=jnp.asarray(metric.capture_radius(), dtype),
        r_escape=jnp.asarray(r_obs * 2.0, dtype),
        lambda_max=lambda_max, h_init=max(1.0, 0.01 * float(r_obs)),
        max_steps=max_steps,
        disk_plane=(float(r_in), float(disk.r_out), float(np.pi / 2),
                    bool(disk.opaque)),
        max_disk_hits=disk.max_hits,
        method=method, record_momentum=record_momentum,
        record_time=record_time,
        disk_normal=(
            warped_basis(disk.tilt, disk.tilt_azimuth, disk.warp_radius)
            if disk.warp_radius is not None
            else (disk_basis(disk.tilt, disk.tilt_azimuth)
                  if disk.tilt != 0.0 else None)))

    xi = p_phi  # E = 1 convention: xi = L/E = p_phi
    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f, p_t, p_phi, status_f)
    return DiskTraceResult(status_out, hits["n"], hits["r"], xi, steps,
                           final_alpha, n_half, hits["phi"], hits["xi"],
                           hits["pr"], hits["pth"], hits.get("t", ()),
                           hits.get("t_now", ()))


def _plane_of(disk: DiskConfig, metric) -> tuple:
    r_in = disk.r_in if disk.r_in is not None else r_isco(
        metric.M, metric.a, disk.prograde,
        Q=getattr(metric, "Q", 0.0))
    return (float(r_in), float(disk.r_out), float(np.pi / 2),
            bool(disk.opaque))


def _normal_of(disk: DiskConfig):
    if disk.warp_radius is not None:
        return warped_basis(disk.tilt, disk.tilt_azimuth,
                            disk.warp_radius)
    if disk.tilt != 0.0:
        return disk_basis(disk.tilt, disk.tilt_azimuth)
    return None


def trace_disk_rays_multi(metric, r_obs, alphas, thetas, theta_obs,
                          lambda_max: float, max_steps: int,
                          disks, precision: str = "fast",
                          method: str = "dp45"):
    """Trace rays recording crossings of SEVERAL independent disk
    planes in ONE integration (multi-plane disks — e.g. an equatorial
    disk plus a tilted outer ring; no reference counterpart).

    Returns a tuple of DiskTraceResult, one per disk, sharing the
    ray's status / final heading / step count. A ray terminates at its
    first in-disk crossing of any OPAQUE plane (so later planes behind
    it are correctly occluded); translucent planes record up to
    max(max_hits) crossings each. XLA path only (the per-plane sign
    tracks use the shared adaptive loop's recorder,
    ops/kerr_trace.py dp45_integrate(extra_disks=...)).
    """
    if method not in ("dp45", "dop853"):
        raise ValueError(
            f"disk mode supports integrator 'dp45' or 'dop853', got "
            f"{method!r}")
    return _trace_disk_rays_multi_xla(
        metric, float(r_obs), alphas, thetas, float(theta_obs),
        float(lambda_max), max_steps, tuple(disks), precision, method)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "lambda_max",
                     "max_steps", "disks", "precision", "method"))
def _trace_disk_rays_multi_xla(metric, r_obs, alphas, thetas, theta_obs,
                               lambda_max: float, max_steps: int,
                               disks: tuple, precision: str = "fast",
                               method: str = "dp45"):
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)
    max_hits = max(d.max_hits for d in disks)
    planes = [(_plane_of(d, metric), _normal_of(d)) for d in disks]

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    status0 = jnp.where(invalid0, INVALID, RUNNING).astype(jnp.int32)
    atol = jnp.full_like(alphas, tols["atol"])
    rtol = jnp.full_like(alphas, tols["rtol"])

    y_f, status_f, _lam, steps, hits = dp45_integrate(
        metric, y0, p_t, p_phi, status0,
        atol=atol, rtol=rtol, h_min=jnp.asarray(tols["h_min"], dtype),
        tiny_err=tols["tiny_err"],
        r_capture=jnp.asarray(metric.capture_radius(), dtype),
        r_escape=jnp.asarray(r_obs * 2.0, dtype),
        lambda_max=lambda_max, h_init=max(1.0, 0.01 * float(r_obs)),
        max_steps=max_steps, method=method,
        disk_plane=planes[0][0], disk_normal=planes[0][1],
        max_disk_hits=max_hits,
        extra_disks=tuple(planes[1:]))

    xi = p_phi  # E = 1 convention
    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f, p_t, p_phi, status_f)
    tracks = [
        {k: hits[k] for k in ("n", "r", "phi", "pr", "pth",
                              "down", "xi")}]
    tracks += list(hits.get("extra", ()))
    return tuple(
        DiskTraceResult(status_out, t["n"], t["r"], xi, steps,
                        final_alpha, n_half, t["phi"], t["xi"],
                        t["pr"], t["pth"])
        for t in tracks)


def render_multi_disk(scene: SceneConfig, resolution,
                      cfg: RenderConfig = RenderConfig(),
                      disks=(DiskConfig(),)):
    """Render several independent disks (e.g. equatorial + tilted) in
    ONE trace; returns (image, stats).

    Emission is additive across planes (each with its own r_in,
    emissivity, spectrum parameters — all planes must share the
    spectrum TYPE and tone map); opaque planes occlude planes crossed
    later along the ray, because the shared trace terminates there.
    Single-plane limit: render_multi_disk([d]) == render_disk(d).
    """
    disks = tuple(disks)
    if len({d.spectrum for d in disks}) != 1:
        raise ValueError("all disks must share a spectrum type")
    if len({d.tone_map for d in disks}) != 1:
        raise ValueError("all disks must share a tone_map")
    metric = _scene_metric(scene)
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost)
        theta = camera.build_theta_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        results = trace_disk_rays_multi(
            metric, scene.r_obs, alpha.ravel(), theta.ravel(),
            scene.theta_obs, max(5000.0, 6.0 * scene.r_obs),
            cfg.max_steps, disks, precision=cfg.precision,
            method=cfg.integrator)
        out.append(results[0].status)

    with timer.stage("render") as out:
        dl = (camera.doppler_lookup(resolution, fov, scene.boost,
                                    dtype=dtype).ravel()
              if scene.boosted else None)
        intensity = None
        rgb = None
        for disk, res in zip(disks, results):
            r_in = disk.r_in if disk.r_in is not None else r_isco(
                scene.M, scene.a, disk.prograde, Q=scene.Q)
            inten_p, rgb_p = disk_emission(
                scene, disk, r_in, res.n_hits, res.r_hits, res.xi,
                doppler=dl, xi_hits=res.xi_hits)
            intensity = inten_p if intensity is None else (
                intensity + inten_p)
            if rgb_p is not None:
                rgb = rgb_p if rgb is None else rgb + rgb_p
        img = _finish_image(intensity, rgb, resolution,
                            disks[0].tone_map)
        out.append(img)

    res0 = results[0]
    any_hit = np.zeros(height * width, bool)
    for res in results:
        any_hit |= np.asarray(res.n_hits) > 0
    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs),
        r_isco=r_isco(scene.M, scene.a, disks[0].prograde, Q=scene.Q),
        captured=int((np.asarray(res0.status) == CAPTURED).sum()),
        disk_pixels=int(any_hit.sum()),
        disk_pixels_per_plane=[int((np.asarray(r.n_hits) > 0).sum())
                               for r in results],
        integrator_steps=int(res0.n_steps),
        n_disks=len(disks),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return img, stats


def render_disk_multihost(scene: SceneConfig, resolution,
                          cfg: RenderConfig, disk: DiskConfig, mesh):
    """Disk render over a global (multi-process) mesh.

    The trace shards pixel rows across every device of every process
    (parallel/multihost.trace_disk_grid_multihost); the cheap emission
    + tone map then run redundantly on every host from the gathered
    crossing records, so each process holds the identical image.
    Returns (image, stats).
    """
    from light_path_tracer_tpu.parallel.multihost import (
        trace_disk_grid_multihost)

    metric = _scene_metric(scene)
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost)
        theta = camera.build_theta_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        res = trace_disk_grid_multihost(
            metric, scene.r_obs, np.asarray(alpha), np.asarray(theta),
            scene.theta_obs, disk, mesh=mesh, max_steps=cfg.max_steps,
            backend="xla")
        out.append(jnp.asarray(res.n_hits))

    with timer.stage("render") as out:
        r_in = disk.r_in if disk.r_in is not None else r_isco(
            scene.M, scene.a, disk.prograde, Q=scene.Q)
        dl = (camera.doppler_lookup(resolution, fov, scene.boost,
                                    dtype=dtype).ravel()
              if scene.boosted else None)
        intensity, rgb = disk_emission(
            scene, disk, r_in,
            jnp.asarray(res.n_hits).ravel(),
            tuple(jnp.asarray(r).ravel() for r in res.r_hits),
            jnp.asarray(res.xi).ravel(), doppler=dl,
            xi_hits=tuple(jnp.asarray(x).ravel() for x in res.xi_hits))
        img = _finish_image(intensity, rgb, resolution, disk.tone_map)
        out.append(img)

    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs),
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        captured=int((np.asarray(res.status) == CAPTURED).sum()),
        disk_pixels=int((np.asarray(res.n_hits) > 0).sum()),
        integrator_steps=int(res.n_steps),
        n_devices=int(mesh.devices.size),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return img, stats


def render_disk(scene: SceneConfig, resolution,
                cfg: RenderConfig = RenderConfig(),
                disk: DiskConfig = DiskConfig()):
    """Render the accretion-disk image; returns (image (H,W), stats).

    The observer inclination comes from scene.theta_obs — edge-on
    (pi/2) shows the classic asymmetric Doppler-boosted disk; use e.g.
    80 deg (slightly off-plane) for the textbook bent-disk image.
    """
    metric = _scene_metric(scene)
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost)
        theta = camera.build_theta_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        res = trace_disk_rays(
            metric, scene.r_obs, alpha.ravel(), theta.ravel(),
            scene.theta_obs, max(5000.0, 6.0 * scene.r_obs),
            cfg.max_steps, disk, backend=cfg.backend,
            precision=cfg.precision, method=cfg.integrator)
        out.append(res.status)

    with timer.stage("render") as out:
        r_in = disk.r_in if disk.r_in is not None else r_isco(
            scene.M, scene.a, disk.prograde, Q=scene.Q)
        dl = (camera.doppler_lookup(resolution, fov, scene.boost,
                                    dtype=dtype).ravel()
              if scene.boosted else None)
        intensity, rgb = disk_emission(scene, disk, r_in,
                                       res.n_hits, res.r_hits, res.xi,
                                       doppler=dl, xi_hits=res.xi_hits)
        img = _finish_image(intensity, rgb, resolution, disk.tone_map)
        out.append(img)

    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs),
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        captured=int((np.asarray(res.status) == CAPTURED).sum()),
        disk_pixels=int((np.asarray(res.n_hits) > 0).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return img, stats


def render_disk_decomposed(scene: SceneConfig, resolution,
                           cfg: RenderConfig = RenderConfig(),
                           disk: DiskConfig = DiskConfig(),
                           n_orders: int = 3):
    """Photon-ring decomposition: the disk image split by image order.

    ONE geodesic trace recording the ray's first n_orders equatorial
    crossings ANYWHERE on the plane (not just inside the disk annulus
    — so slot k is the k-th plane crossing, i.e. image order k in the
    Gralla-Holz-Wald sense); order k's layer is the disk emission
    picked up at that crossing when it lands inside [r_in, r_out]
    (k = 0 the direct image, k = 1 the first lensed image of the far
    side seen under the hole, k >= 2 the exponentially demagnified
    photon subrings that pile up on the critical curve — the EHT
    "photon ring" stack). The layers sum to the translucent
    render_disk intensity (pinned by tests). The reference's closest
    analogue is the winding-count palette of its lensed renderer
    (/root/reference/image_lens.py:287-293), which colors BACKGROUND
    rays by half-orbits; this decomposes the DISK emission itself.

    Returns (layers, stats):
      layers: (n_orders, H, W) LINEAR intensity (power-law spectrum) or
        (n_orders, H, W, 3) linear-sRGB (blackbody) — un-tone-mapped so
        order fluxes are physical; apply _tone_map / decomposed_display
        for presentation.
      stats: flux_per_order (summed linear intensity), flux_ratios
        (flux[k+1]/flux[k]), gamma_estimates (-ln ratio — the measured
        Lyapunov demagnification exponent; for a = 0 the asymptotic
        value is pi per half orbit, i.e. per order), mean_radius_rad
        (intensity-weighted mean angular radius of each layer on the
        image plane; order >= 2 converges on alpha_crit), pixels_per_order,
        plus the usual render stats.
    """
    metric = _scene_metric(scene)
    # Recording config: translucent, n_orders slots, full-plane radial
    # window (r_in=0 disables the ISCO-hole default; r_out at the
    # escape radius) — every equatorial crossing lands in its
    # order-indexed slot. The real annulus is applied at emission.
    rec = dataclasses.replace(disk, opaque=False, max_hits=n_orders,
                              r_in=0.0, r_out=2.0 * scene.r_obs)
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost)
        theta = camera.build_theta_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        res = trace_disk_rays(
            metric, scene.r_obs, alpha.ravel(), theta.ravel(),
            scene.theta_obs, max(5000.0, 6.0 * scene.r_obs),
            cfg.max_steps, rec, backend=cfg.backend,
            precision=cfg.precision, method=cfg.integrator)
        out.append(res.status)

    with timer.stage("render") as out:
        r_in = disk.r_in if disk.r_in is not None else r_isco(
            scene.M, scene.a, disk.prograde, Q=scene.Q)
        dl = (camera.doppler_lookup(resolution, fov, scene.boost,
                                    dtype=dtype).ravel()
              if scene.boosted else None)
        slot_i, slot_rgb = disk_emission(scene, rec, r_in,
                                         res.n_hits, res.r_hits, res.xi,
                                         doppler=dl, xi_hits=res.xi_hits,
                                         per_slot=True,
                                         annulus=(r_in, disk.r_out))
        slot_i = slot_i[:n_orders]
        if slot_rgb is None:
            layers = slot_i.reshape((n_orders,) + tuple(resolution)
                                    ).astype(jnp.float32)
        else:
            layers = slot_rgb[:n_orders].reshape(
                (n_orders,) + tuple(resolution) + (3,)).astype(jnp.float32)
        out.append(layers)

    slot_np = np.asarray(slot_i, np.float64)
    flux = slot_np.sum(axis=1)
    alpha_flat = np.asarray(alpha, np.float64).ravel()
    mean_radius = (slot_np @ alpha_flat) / np.maximum(flux, 1e-300)
    ratios = flux[1:] / np.maximum(flux[:-1], 1e-300)
    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs),
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        captured=int((np.asarray(res.status) == CAPTURED).sum()),
        disk_pixels=int((slot_np.sum(axis=0) > 0.0).sum()),
        pixels_per_order=[int((slot_np[k] > 0.0).sum())
                          for k in range(n_orders)],
        flux_per_order=flux.tolist(),
        flux_ratios=ratios.tolist(),
        gamma_estimates=(-np.log(np.maximum(ratios, 1e-300))).tolist(),
        mean_radius_rad=mean_radius.tolist(),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return layers, stats


def decomposed_display(layers, tone_map: str = "asinh"):
    """Shared-peak tone map of render_disk_decomposed layers for
    display: every order is scaled by the GLOBAL peak (the direct
    image's), so the subrings' exponential demagnification is visible
    rather than normalized away. Returns float32 in [0, 1], same
    shape as layers."""
    flat = layers.reshape(layers.shape[0], -1)
    peak = jnp.max(flat)
    return jnp.stack([
        _tone_map(layer, tone_map, peak=peak) for layer in layers
    ]).astype(jnp.float32)


def _finish_image(intensity, rgb, resolution, tone_map: str):
    """Shared emission -> image finish: tone-map the luminance, keep the
    blackbody chromaticity (rgb is None for the power-law spectrum).
    One implementation for render_disk / render_disk_aa so the paths
    cannot diverge."""
    if rgb is not None:
        lum = _tone_map(intensity, tone_map)
        chroma = rgb / jnp.maximum(intensity, 1e-12)[:, None]
        return (chroma * lum[:, None]).reshape(
            resolution + (3,)).astype(jnp.float32)
    return _tone_map(intensity, tone_map).reshape(
        resolution).astype(jnp.float32)


def _tone_map(x, mode: str, peak=None):
    """peak=None normalizes to this frame's own maximum; sequences pass
    the global maximum so frames don't flicker. peak may be an array
    broadcastable against x (per-pass peaks in the stacked AA path)."""
    peak = jnp.maximum(jnp.max(x) if peak is None else peak, 1e-12)
    if mode == "asinh":
        return jnp.arcsinh(10.0 * x / peak) / jnp.arcsinh(10.0)
    if mode == "sqrt":
        return jnp.sqrt(x / peak)
    return x / peak


def _disk_pixels(lum, intensity, rgb, resolution, grayscale: bool,
                 channels):
    """Tone-mapped disk layer shaped like the background image.

    Shared by the composite renderer and its stacked-AA variant so the
    two paths cannot diverge: blackbody chromaticity (rgb is not None)
    keeps the per-ray chroma and carries the tone-mapped luminance;
    power-law emission broadcasts grayscale luminance over the
    background's channel count (alpha channels padded to 1).
    """
    if rgb is not None:
        chroma = rgb / jnp.maximum(intensity, 1e-12)[:, None]
        disk_px = chroma * lum[:, None]
        if grayscale:
            return jnp.matmul(
                disk_px, jnp.asarray([0.299, 0.587, 0.114], disk_px.dtype),
                precision=jax.lax.Precision.HIGHEST).reshape(resolution)
        if channels >= 3:
            pad = jnp.ones((disk_px.shape[0], channels - 3),
                           disk_px.dtype)
            disk_px = jnp.concatenate([disk_px, pad], axis=1)
        else:
            disk_px = disk_px[:, :channels]
        return disk_px.reshape(resolution + (channels,))
    if grayscale:
        return lum.reshape(resolution)
    return jnp.broadcast_to(lum.reshape(resolution)[..., None],
                            resolution + (channels,))


def keplerian_omega(M, a, r, prograde: bool = True, Q: float = 0.0):
    """Keplerian angular velocity Omega = +-sqrt(M)/(r^1.5 +- a sqrt(M));
    charged: +-x/(r^2 +- a x) with x = sqrt(M r - Q^2) (the same
    expression with M r -> M r - Q^2, from the radial derivatives of
    the Kerr-Newman equatorial metric)."""
    xp = np if np.isscalar(r) else jnp
    if Q:
        x = xp.sqrt(xp.maximum(M * r - Q * Q, 0.0))
        s = 1.0 if prograde else -1.0
        return s * x / (r * r + s * a * x)
    # M is always a static Python number — fold sqrt(M) at trace time,
    # as a PYTHON float (weak type): jnp.sqrt(python_float)
    # materializes a default-dtype scalar OP in the jaxpr, which under
    # jax_enable_x64 is float64 and would put float64 ops into the f32
    # trace — while an np.float64 scalar is a STRONG type that
    # silently promotes the f32 while_loop carry (see _g_jet's gamma).
    sqrtM = float(np.sqrt(M)) if np.isscalar(M) else xp.sqrt(M)
    if prograde:
        return sqrtM / (r ** 1.5 + a * sqrtM)
    return -sqrtM / (r ** 1.5 - a * sqrtM)


def hotspot_pattern(spot: "HotSpot", M, a, prograde: bool = True,
                    Q: float = 0.0):
    """Emission-multiplier pattern for an orbiting Gaussian hot spot.

    Returns pattern(r, phi, t) -> multiplier (jax-traceable, batched):
    a rigid Gaussian blob centered at radius spot.r0, azimuth
    spot.phi0 + Omega_K(spot.r0) * t (coordinate time t in units of M).
    Light-travel-time delay across the image is the documented
    equal-time simplification of the IMAGING paths; light curves can
    opt into the true retarded time via record_time + disk_emission's
    delay_hits (spectra.hotspot_light_curve light_travel_delay).
    Because the crossing azimuth is recorded per pixel at trace time,
    frames at any t are pure re-renders of ONE trace.
    """
    omega = float(keplerian_omega(M, a, spot.r0, prograde, Q=Q))

    def pattern(r, phi, t):
        dphi = phi - (spot.phi0 + omega * t)
        # Wrap to [-pi, pi) without mod-of-large-number precision loss
        # at small t; phi itself stays O(10 rad) for disk crossings.
        dphi = (dphi + np.pi) % (2.0 * np.pi) - np.pi
        dr = r - spot.r0
        blob = jnp.exp(-0.5 * ((dr / spot.sigma_r) ** 2
                               + (dphi / spot.sigma_phi) ** 2))
        return 1.0 + spot.amplitude * blob

    return pattern


def texture_pattern(tex, r_in, r_out, M, a, shear: bool = True,
                    Q: float = 0.0,
                    prograde: bool = True):
    """Emission-multiplier pattern from a (Nr, Nphi) texture image.

    The texture covers r in [r_in, r_out] (rows, linear) x phi in
    [0, 2 pi) (columns, periodic). With shear=True each annulus is
    advected at its OWN Keplerian rate Omega(r) — an initially straight
    radial stripe winds into a trailing spiral, the classic
    differential-rotation signature; shear=False rotates the pattern
    rigidly at Omega(r_in). Bilinear sampling with closed-form indices
    (no searchsorted — see blackbody_rgb for why).

    Returns pattern(r, phi, t) for disk_emission / render_disk_frames.
    """
    tex = jnp.asarray(tex, jnp.float32)
    n_r, n_phi = tex.shape
    omega_ref = float(keplerian_omega(M, a, r_in, prograde, Q=Q))
    two_pi = 2.0 * np.pi

    def pattern(r, phi, t):
        omega = (keplerian_omega(M, a, jnp.maximum(r, r_in), prograde,
                                 Q=Q)
                 if shear else omega_ref)
        phi_m = (phi - omega * t) % two_pi
        pr = jnp.clip((r - r_in) / max(r_out - r_in, 1e-9), 0.0, 1.0) \
            * (n_r - 1)
        pp = phi_m / two_pi * n_phi          # periodic axis
        i0 = jnp.clip(pr.astype(jnp.int32), 0, n_r - 2)
        j0 = pp.astype(jnp.int32) % n_phi
        j1 = (j0 + 1) % n_phi
        fr = (pr - i0.astype(pr.dtype))
        fp = (pp - jnp.floor(pp))
        v00 = tex[i0, j0]
        v01 = tex[i0, j1]
        v10 = tex[i0 + 1, j0]
        v11 = tex[i0 + 1, j1]
        return ((1 - fr) * ((1 - fp) * v00 + fp * v01)
                + fr * ((1 - fp) * v10 + fp * v11))

    return pattern


@dataclasses.dataclass(frozen=True)
class HotSpot:
    """Orbiting Gaussian brightness feature on the disk surface."""
    r0: float = 6.0         # orbit radius [M]
    phi0: float = 0.0       # azimuth at t = 0 [rad]
    sigma_r: float = 0.6    # radial Gaussian width [M]
    sigma_phi: float = 0.5  # azimuthal Gaussian width [rad]
    amplitude: float = 6.0  # peak emission multiplier - 1

    @property
    def period(self):
        """Coordinate-time orbital period at r0 (for M=1, a=0 scenes
        scale by the actual Omega via keplerian_omega)."""
        return 2.0 * np.pi / keplerian_omega(1.0, 0.0, self.r0)


def disk_emission(scene: SceneConfig, disk: DiskConfig, r_in,
                  n_hits, r_hits, xi, doppler=None,
                  pattern=None, phi_hits=None, t=0.0, xi_hits=(),
                  delay_hits=(), per_slot: bool = False, annulus=None):
    """Per-ray disk emission from the recorded crossings.

    Returns (intensity, rgb): intensity (N,) is the summed (un-tone-
    mapped) scalar emission over the visible crossings; rgb (N, 3) is
    the intensity-weighted linear-sRGB color sum for the blackbody
    spectrum, or None for the power-law spectrum.

    doppler: optional per-ray camera Doppler factor delta (moving
    observer, camera.doppler_lookup); the total shift chains
    multiplicatively, g_total = delta * g_static.

    pattern: optional surface-brightness multiplier pattern(r, phi, t)
    (e.g. hotspot_pattern) evaluated at each crossing's recorded
    (r, phi) — requires phi_hits (DiskTraceResult.phi_hits).

    delay_hits: optional per-crossing light-travel delay (coordinate
    time, DiskTraceResult.t_hits via record_time): the pattern is then
    evaluated at the RETARDED time t - delay_hits[slot] — the photon
    that arrives at observer time t left that crossing delay earlier,
    so one side of the disk is seen at an older pattern phase
    (light-echo asymmetry; hotspot_light_curve light_travel_delay).

    per_slot: return the per-crossing contributions unsummed —
    (intensity (n_slots, N), rgb (n_slots, N, 3) or None). The sum
    over slots reproduces the default return exactly (this is the
    decomposition used by render_disk_decomposed).

    annulus: optional (r_lo, r_hi) mask applied to each crossing's
    radius. The default (None) trusts the recorder to have stored
    only in-disk crossings; render_disk_decomposed instead records
    EVERY equatorial crossing (so slot index = image order in the
    Gralla-Holz-Wald sense) and masks to the emitting annulus here.
    """
    color = disk.spectrum == "blackbody"
    slot_i, slot_rgb = [], []
    n_slots = 1 if disk.opaque else disk.max_hits
    for slot in range(n_slots):
        hit = n_hits > slot
        if annulus is not None:
            hit &= ((r_hits[slot] >= annulus[0])
                    & (r_hits[slot] <= annulus[1]))
        r_c = jnp.maximum(r_hits[slot], r_in)
        # Tilted disks: the emitter orbits about the disk normal, so
        # the Doppler term needs the ray's angular momentum about n
        # recorded at THIS crossing, not the conserved L_z.
        xi_slot = xi_hits[slot] if len(xi_hits) > slot else xi
        g = keplerian_redshift(scene.M, scene.a, r_c, xi_slot,
                               disk.prograde, Q=scene.Q)
        if doppler is not None:
            g = g * doppler
        t_slot = (t - delay_hits[slot] if len(delay_hits) > slot else t)
        mult = (pattern(r_c, phi_hits[slot], t_slot)
                if pattern is not None else 1.0)
        if color:
            from light_path_tracer_tpu.utils.color import blackbody_rgb
            t_obs = g * disk_temperature(r_c, r_in, disk.t_peak)
            w = jnp.where(hit, mult * (t_obs / disk.t_peak) ** 4, 0.0)
            slot_rgb.append(w[:, None] * blackbody_rgb(t_obs))
            slot_i.append(w)
        else:
            eps = (r_c / r_in) ** (-disk.emissivity_index)
            slot_i.append(jnp.where(hit, mult * g ** disk.g_power * eps,
                                    0.0))
    if per_slot:
        return (jnp.stack(slot_i),
                jnp.stack(slot_rgb) if color else None)
    intensity = sum(slot_i[1:], slot_i[0])
    rgb = sum(slot_rgb[1:], slot_rgb[0]) if color else None
    return intensity, rgb


def render_disk_frames(scene: SceneConfig, resolution, times,
                       cfg: RenderConfig = RenderConfig(),
                       disk: DiskConfig = DiskConfig(),
                       spot: HotSpot = HotSpot(), pattern=None):
    """Hot-spot / textured-disk animation: ONE geodesic trace, many frames.

    pattern: optional pattern(r, phi, t) multiplier (texture_pattern for
    image textures with differential shear); defaults to
    hotspot_pattern(spot).

    The trace records each crossing's (r, phi); a frame at coordinate
    time t only re-evaluates the surface-brightness pattern at the
    advected azimuth and re-gathers — integration cost is paid once for
    the whole sequence (lensing is static; only the emission pattern
    moves). Frames share one global tone-map peak so brightness does
    not flicker.

    Returns (frames (T, H, W) or (T, H, W, 3), stats). `times` are in
    units of M; one full orbit at spot.r0 is
    2 pi / keplerian_omega(M, a, r0).
    """
    metric = _scene_metric(scene)
    timer = StageTimer()
    height, width = resolution
    # Materialize once: a generator argument would be exhausted by the
    # first list() and silently report n_frames=0 in stats.
    times = list(times)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost)
        theta = camera.build_theta_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        res = trace_disk_rays(
            metric, scene.r_obs, alpha.ravel(), theta.ravel(),
            scene.theta_obs, max(5000.0, 6.0 * scene.r_obs),
            cfg.max_steps, disk, backend=cfg.backend,
            precision=cfg.precision, method=cfg.integrator)
        out.append(res.status)

    with timer.stage("render") as out:
        r_in = disk.r_in if disk.r_in is not None else r_isco(
            scene.M, scene.a, disk.prograde, Q=scene.Q)
        dl = (camera.doppler_lookup(resolution, fov, scene.boost,
                                    dtype=dtype).ravel()
              if scene.boosted else None)
        if pattern is None:
            pattern = hotspot_pattern(spot, scene.M, scene.a,
                                      disk.prograde, Q=scene.Q)

        # All frames in ONE dispatch: the emission is elementwise over
        # rays, so frames vmap over the time axis for free. The trace
        # arrays enter as jit ARGUMENTS — closing over them would embed
        # 65k-element constants in the graph, which XLA constant-folds
        # at compile time for minutes (measured: a >500 s compile for a
        # 9 ms computation).
        ts = jnp.asarray(times, dtype)
        color = disk.spectrum == "blackbody"

        @jax.jit
        def all_frames(ts, n_hits, r_hits, xi, phi_hits, doppler,
                       xi_hits):
            def emit(t):
                return disk_emission(scene, disk, r_in, n_hits, r_hits,
                                     xi, doppler=doppler,
                                     pattern=pattern, phi_hits=phi_hits,
                                     t=t, xi_hits=xi_hits)

            intensity, rgb = jax.vmap(emit)(ts)       # (T, N) / (T, N, 3)
            peak = jnp.max(intensity)                 # global: no flicker
            lum = _tone_map(intensity, disk.tone_map, peak)
            raw = intensity.reshape((ts.shape[0],) + resolution).astype(
                jnp.float32)
            if color:
                chroma = rgb / jnp.maximum(intensity, 1e-12)[..., None]
                return (chroma * lum[..., None]).reshape(
                    (ts.shape[0],) + resolution + (3,)).astype(
                        jnp.float32), raw
            return lum.reshape((ts.shape[0],) + resolution).astype(
                jnp.float32), raw

        frames, emission = all_frames(ts, res.n_hits, res.r_hits, res.xi,
                                      res.phi_hits, dl, res.xi_hits)
        out.append(frames)

    stats = dict(
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        disk_pixels=int((np.asarray(res.n_hits) > 0).sum()),
        integrator_steps=int(res.n_steps),
        # Raw linear per-frame intensity (T, H, W) — the photometric
        # input observables.centroid_track expects (tone maps bias it).
        emission=emission,
        n_frames=len(times),
        orbit_period=abs(2.0 * np.pi / keplerian_omega(
            scene.M, scene.a, spot.r0, disk.prograde, Q=scene.Q)),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return frames, stats


def render_scene_with_disk(scene: SceneConfig, source_image,
                           cfg: RenderConfig = RenderConfig(),
                           disk: DiskConfig = DiskConfig(),
                           disk_gain: float = 1.0,
                           pixel_offset=(0.0, 0.0)):
    """Composite render: lensed background image + accretion disk, ONE
    trace per pixel (the disk-mode integrator records plane crossings
    AND the final state, whose escape heading drives the background
    gather — no second integration pass).

    Semantics:
      * opaque disk (default): the first in-disk crossing terminates the
        ray — those pixels show the disk; every other pixel shows the
        lensed background with full reference-parity renderer semantics
        (shadow, winding palette, magenta sentinel / loop-around;
        image_lens.py:296-397).
      * translucent disk: rays integrate through the plane (up to
        disk.max_hits crossings); the disk emission is added on top of
        the lensed background and clipped.

    disk_gain scales the tone-mapped disk brightness against the [0, 1]
    background texture. Returns (image, stats).
    """
    metric = _scene_metric(scene)
    timer = StageTimer()
    src = np.asarray(source_image)
    height, width = src.shape[:2]
    resolution = (height, width)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs)

    with timer.stage("load_image") as out:
        img = jnp.asarray(src)
        if img.dtype == jnp.uint8:
            img = img.astype(jnp.float32) / 255.0
        out.append(img)

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost,
                                          pixel_offset=tuple(pixel_offset))
        theta = camera.build_theta_lookup(resolution, fov, psi=scene.psi,
                                          dtype=dtype, boost=scene.boost,
                                          pixel_offset=tuple(pixel_offset))
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        res = trace_disk_rays(
            metric, scene.r_obs, alpha.ravel(), theta.ravel(),
            scene.theta_obs, max(5000.0, 6.0 * scene.r_obs),
            cfg.max_steps, disk, backend=cfg.backend,
            precision=cfg.precision, method=cfg.integrator)
        out.append(res.status)

    with timer.stage("render") as out:
        from light_path_tracer_tpu.render import render_lensed_image
        r_in = disk.r_in if disk.r_in is not None else r_isco(
            scene.M, scene.a, disk.prograde, Q=scene.Q)
        fa = res.final_alpha.reshape(resolution).astype(jnp.float32)
        wind = jnp.clip(res.n_half, 0, cfg.winding_max).astype(
            jnp.uint16).reshape(resolution)
        background = render_lensed_image(
            img, alpha, fa, wind, alpha_crit, fov,
            cfg.render_loop_around, psi=scene.psi, theta_lookup=theta,
            sampling=cfg.sampling)

        # Boost: delta applies to the PHYSICAL disk layer only (delta^4
        # intensity, delta temperature). The background texture is
        # display-referred — it gets aberration (baked into the lookups
        # above) but no delta^4 scaling (docs/physics.md "Relativistic
        # observer").
        dl = (camera.doppler_lookup(resolution, fov, scene.boost,
                                    dtype=dtype,
                                    pixel_offset=tuple(pixel_offset))
              .ravel() if scene.boosted else None)
        intensity, rgb = disk_emission(scene, disk, r_in,
                                       res.n_hits, res.r_hits, res.xi,
                                       doppler=dl, xi_hits=res.xi_hits)
        lum = _tone_map(intensity, disk.tone_map) * disk_gain
        grayscale = background.ndim == 2
        disk_px = _disk_pixels(
            lum, intensity, rgb, resolution, grayscale,
            None if grayscale else background.shape[2])

        hit = (res.n_hits > 0).reshape(resolution)
        hit_b = hit if grayscale else hit[..., None]
        if disk.opaque:
            composite = jnp.where(hit_b, disk_px.astype(background.dtype),
                                  background)
        else:
            composite = jnp.clip(
                background + disk_px.astype(background.dtype), 0.0, 1.0)
        composite = composite.astype(jnp.float32)
        out.append(composite)

    stats = dict(
        alpha_crit=alpha_crit,
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        captured=int((np.asarray(res.status) == CAPTURED).sum()),
        disk_pixels=int((np.asarray(res.n_hits) > 0).sum()),
        disk_mask=np.asarray(hit),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return composite, stats


def composite_gamma_encode(image, disk_mask, gamma: float = 2.2):
    """Display-encode the DISK pixels of a composite for saving.

    The background texture is already display-encoded (it came from an
    image file); the disk layer is physical linear-light radiance, so
    only its pixels get the 1/gamma transfer. For translucent disks the
    masked pixels mix both layers and the encoding is approximate
    (documented tradeoff; exact for the default opaque disk).
    """
    img = jnp.asarray(image)
    mask = jnp.asarray(disk_mask)
    enc = jnp.clip(img, 0.0, 1.0) ** (1.0 / gamma)
    m = mask if img.ndim == 2 else mask[..., None]
    return jnp.where(m, enc, img)


def render_disk_aa(scene: SceneConfig, resolution,
                   cfg: RenderConfig = RenderConfig(),
                   disk: DiskConfig = DiskConfig(),
                   aa_samples: int = 4):
    """Anti-aliased disk render: jittered subpixel passes averaged in
    LINEAR emission space (before tone mapping — averaging after would
    bias the compressive asinh curve), then tone-mapped once.

    The disk's inner edge, the lensed secondary image, and the photon
    ring are the sharp features that alias at low resolution; aa.py's
    rotated-grid offsets (aa_offsets) give them smooth coverage. All
    passes trace in ONE stacked dispatch.
    """
    from light_path_tracer_tpu.aa import aa_offsets

    metric = _scene_metric(scene)
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    offsets = aa_offsets(aa_samples)
    n_s = len(offsets)

    with timer.stage("build_lookup") as out:
        from light_path_tracer_tpu.aa import _stacked_grids
        # Shared per-offset grid builder (aa.py); Kerr is never
        # spherically symmetric here so theta always comes back.
        alpha, theta = _stacked_grids(metric, scene, cfg, resolution,
                                      fov, offsets)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        res = trace_disk_rays(
            metric, scene.r_obs, alpha.ravel(), theta.ravel(),
            scene.theta_obs, max(5000.0, 6.0 * scene.r_obs),
            cfg.max_steps, disk, backend=cfg.backend,
            precision=cfg.precision, method=cfg.integrator)
        out.append(res.status)

    with timer.stage("render") as out:
        r_in = disk.r_in if disk.r_in is not None else r_isco(
            scene.M, scene.a, disk.prograde, Q=scene.Q)
        dl = None
        if scene.boosted:
            dl = jnp.stack([camera.doppler_lookup(
                resolution, fov, scene.boost, dtype=dtype,
                pixel_offset=tuple(off)) for off in offsets]).ravel()
        intensity, rgb = disk_emission(scene, disk, r_in, res.n_hits,
                                       res.r_hits, res.xi, doppler=dl,
                                       xi_hits=res.xi_hits)
        # Average the passes in linear space, then tone-map.
        intensity = intensity.reshape(n_s, height * width).mean(axis=0)
        if rgb is not None:
            rgb = rgb.reshape(n_s, height * width, 3).mean(axis=0)
        img = _finish_image(intensity, rgb, resolution, disk.tone_map)
        out.append(img)

    stats = dict(
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        disk_pixels=int((np.asarray(res.n_hits).reshape(n_s, -1) > 0)
                        .any(axis=0).sum()),
        captured=int((np.asarray(res.status) == CAPTURED).sum()),
        integrator_steps=int(res.n_steps),
        aa_samples=n_s,
        total_rays=n_s * height * width,
        traced_rays=n_s * height * width,
        timings=timer.finish())
    return img, stats


def _concat_disk_results(results):
    """Concatenate per-pass DiskTraceResults along the ray axis (the
    hit tuples slot-wise; n_steps summed)."""
    first = results[0]

    def cat(get):
        return jnp.concatenate([get(r) for r in results])

    return DiskTraceResult(
        status=cat(lambda r: r.status),
        n_hits=cat(lambda r: r.n_hits),
        r_hits=tuple(cat(lambda r, i=i: r.r_hits[i])
                     for i in range(len(first.r_hits))),
        xi=cat(lambda r: r.xi),
        n_steps=sum(r.n_steps for r in results),
        final_alpha=cat(lambda r: r.final_alpha),
        n_half=cat(lambda r: r.n_half),
        phi_hits=tuple(cat(lambda r, i=i: r.phi_hits[i])
                       for i in range(len(first.phi_hits))),
        xi_hits=tuple(cat(lambda r, i=i: r.xi_hits[i])
                      for i in range(len(first.xi_hits))),
        pr_hits=tuple(cat(lambda r, i=i: r.pr_hits[i])
                      for i in range(len(first.pr_hits))),
        pth_hits=tuple(cat(lambda r, i=i: r.pth_hits[i])
                       for i in range(len(first.pth_hits))))


def render_scene_with_disk_aa(scene: SceneConfig, source_image,
                              cfg: RenderConfig = RenderConfig(),
                              disk: DiskConfig = DiskConfig(),
                              disk_gain: float = 1.0,
                              aa_samples: int = 4,
                              display_encode: bool = False,
                              stacked: bool = True):
    """Anti-aliased composite (lensed background + disk): average of
    jittered-subpixel composites.

    The average runs in DISPLAY space, not linear emission space (cf.
    render_disk_aa): the composite is display-referred — its background
    half is an already-encoded texture — and each single pass's pixel is
    PURELY disk or purely background, so encoding each pass first
    (display_encode=True, for blackbody spectra) and then averaging is
    exact pixel-coverage AA of what the screen shows. Averaging before
    a whole-image encode would double-encode the background fraction of
    partially-covered edge pixels (bright fringes on the silhouette).

    stacked=True (default): the aa.py stacked-pass pattern — every
    offset's rays traced through ONE compiled kernel in pass-sized
    dispatches, emission/render/average all on device, one readback.
    stacked=False keeps the per-offset full-pipeline loop (the original
    quality path, retained as the equivalence oracle — each pass pays
    its own lookup build, render and readback). Per-pass semantics are
    identical: per-pass tone-map peak, display-space average, disk-hit
    mask union. Returns (image, stats).
    """
    if stacked:
        return _render_scene_with_disk_aa_stacked(
            scene, source_image, cfg, disk, disk_gain, aa_samples,
            display_encode)
    return _render_scene_with_disk_aa_loop(
        scene, source_image, cfg, disk, disk_gain, aa_samples,
        display_encode)


def _render_scene_with_disk_aa_stacked(scene, source_image, cfg, disk,
                                       disk_gain, aa_samples,
                                       display_encode):
    """Stacked-pass composite AA (see render_scene_with_disk_aa)."""
    from light_path_tracer_tpu.aa import aa_offsets
    from light_path_tracer_tpu.render import render_lensed_image

    metric = _scene_metric(scene)
    timer = StageTimer()
    src = np.asarray(source_image)
    height, width = src.shape[:2]
    resolution = (height, width)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs)
    offsets = aa_offsets(aa_samples)
    n_s = len(offsets)
    n_px = height * width

    with timer.stage("load_image") as out:
        img = jnp.asarray(src)
        if img.dtype == jnp.uint8:
            img = img.astype(jnp.float32) / 255.0
        out.append(img)

    with timer.stage("build_lookup") as out:
        alphas = jnp.stack([camera.build_alpha_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost, pixel_offset=tuple(off))
            for off in offsets])
        thetas = jnp.stack([camera.build_theta_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost, pixel_offset=tuple(off))
            for off in offsets])
        out.append((alphas, thetas))

    with timer.stage("precompute") as out:
        # All offsets in as few dispatches as fit under the device's
        # large-dispatch fault threshold (> ~8-10M rays have faulted):
        # one 4.2M-ray dispatch at 1024^2 aa=4 saves the per-chunk
        # dispatch + pass-2 retrace overhead vs four pass-sized chunks.
        # Above the threshold, pass-sized chunks share one compiled
        # kernel (identical shapes, aa.py._trace_all_passes's pattern).
        if n_s * n_px <= 8_000_000:
            groups = [slice(0, n_s)]
        else:
            groups = [slice(s, s + 1) for s in range(n_s)]
        results = [trace_disk_rays(
            metric, scene.r_obs, alphas[g].ravel(), thetas[g].ravel(),
            scene.theta_obs, max(5000.0, 6.0 * scene.r_obs),
            cfg.max_steps, disk, backend=cfg.backend,
            precision=cfg.precision, method=cfg.integrator)
            for g in groups]
        res = (results[0] if len(results) == 1
               else _concat_disk_results(results))
        out.append(res.status)

    with timer.stage("render") as out:
        r_in = disk.r_in if disk.r_in is not None else r_isco(
            scene.M, scene.a, disk.prograde, Q=scene.Q)
        # Boost: delta^4 applies to the physical disk layer only; the
        # display-referred background gets aberration via the lookups
        # (docs/physics.md "Relativistic observer").
        dl = (jnp.stack([camera.doppler_lookup(
            resolution, fov, scene.boost, dtype=dtype,
            pixel_offset=tuple(off)) for off in offsets]).ravel()
            if scene.boosted else None)
        intensity, rgb = disk_emission(scene, disk, r_in,
                                       res.n_hits, res.r_hits, res.xi,
                                       doppler=dl, xi_hits=res.xi_hits)
        # Per-pass tone-map peak — identical to the loop path, where
        # each pass normalizes to its own maximum.
        peaks = intensity.reshape(n_s, n_px).max(axis=1, keepdims=True)
        lum = (_tone_map(intensity.reshape(n_s, n_px), disk.tone_map,
                         peaks) * disk_gain).reshape(-1)
        grayscale = img.ndim == 2
        channels = None if grayscale else img.shape[2]
        hit = (res.n_hits > 0).reshape(n_s, height, width)
        encode = bool(display_encode and disk.spectrum == "blackbody")
        acc = None
        for s in range(n_s):
            sl = slice(s * n_px, (s + 1) * n_px)
            fa = res.final_alpha[sl].reshape(resolution).astype(
                jnp.float32)
            wind = jnp.clip(res.n_half[sl], 0, cfg.winding_max).astype(
                jnp.uint16).reshape(resolution)
            background = render_lensed_image(
                img, alphas[s], fa, wind, alpha_crit, fov,
                cfg.render_loop_around, psi=scene.psi,
                theta_lookup=thetas[s], sampling=cfg.sampling)
            disk_px = _disk_pixels(
                lum[sl], intensity[sl],
                None if rgb is None else rgb[sl],
                resolution, grayscale, channels)
            hit_b = hit[s] if grayscale else hit[s][..., None]
            if disk.opaque:
                comp = jnp.where(hit_b, disk_px.astype(background.dtype),
                                 background)
            else:
                comp = jnp.clip(
                    background + disk_px.astype(background.dtype),
                    0.0, 1.0)
            comp = comp.astype(jnp.float32)
            if encode:
                comp = composite_gamma_encode(comp, hit[s])
            acc = comp if acc is None else acc + comp
        image = (acc / n_s).astype(jnp.float32)
        out.append(image)

    mask = np.asarray(hit.any(axis=0))
    stats = dict(
        alpha_crit=alpha_crit,
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        captured=int((np.asarray(res.status) == CAPTURED).sum()),
        disk_pixels=int(mask.sum()),
        disk_mask=mask,
        integrator_steps=int(res.n_steps),
        aa_samples=n_s,
        total_rays=n_s * n_px,
        traced_rays=n_s * n_px,
        display_encoded=bool(display_encode
                             and disk.spectrum == "blackbody"),
        timings=timer.finish())
    return image, stats


def _render_scene_with_disk_aa_loop(scene, source_image, cfg, disk,
                                    disk_gain, aa_samples,
                                    display_encode):
    """Per-offset full-pipeline composite AA (equivalence oracle for the
    stacked path; see render_scene_with_disk_aa)."""
    from light_path_tracer_tpu.aa import aa_offsets

    offsets = aa_offsets(aa_samples)
    acc = None
    mask = None
    agg = None
    for off in offsets:
        img, stats = render_scene_with_disk(
            scene, source_image, cfg, disk, disk_gain=disk_gain,
            pixel_offset=tuple(off))
        if display_encode and disk.spectrum == "blackbody":
            img = composite_gamma_encode(img, stats["disk_mask"])
        acc = img if acc is None else acc + img
        mask = (stats["disk_mask"] if mask is None
                else mask | stats["disk_mask"])
        if agg is None:
            agg = dict(stats)
            agg["timings"] = dict(stats["timings"])
        else:
            agg["captured"] += stats["captured"]
            agg["integrator_steps"] += stats["integrator_steps"]
            for key, val in stats["timings"].items():
                agg["timings"][key] = agg["timings"].get(key, 0.0) + val
    out = (acc / len(offsets)).astype(jnp.float32)
    agg["aa_samples"] = len(offsets)
    agg["total_rays"] = agg["total_rays"] * len(offsets)
    agg["traced_rays"] = agg["traced_rays"] * len(offsets)
    agg["display_encoded"] = bool(display_encode
                                  and disk.spectrum == "blackbody")
    # For any later encoding: a pixel counts as disk if ANY pass hit it.
    agg["disk_mask"] = mask
    agg["disk_pixels"] = int(np.asarray(mask).sum())
    return out, agg
