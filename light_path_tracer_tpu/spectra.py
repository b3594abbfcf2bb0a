"""Relativistic disk spectroscopy: emission-line profiles + light curves.

Both observables fall out of the per-crossing record the disk imaging
path already produces (disk.py: each pixel's crossing radii and angular
momenta about the disk normal) — no new integration:

* **Emission-line profile** (`line_profile`): a monochromatic line
  emitted at rest energy E0 by disk gas arrives at E_obs = g * E0 with
  the same combined gravitational + Doppler shift
  g = E_obs/E_em (disk.keplerian_redshift) that colors the disk image.
  Binning every visible crossing's flux by its g gives the classic
  skewed diskline: a double-horned profile (blue/red horns from the
  approaching/receding limbs), with the red wing dragged far down by
  gravitational redshift near the ISCO — the Fe K-alpha shape used to
  measure black-hole spin. Image-plane pixels subtend equal solid
  angle, so per-pixel observed flux IS the correct flux weight; the
  per-crossing observed line flux scales as g**g_power times the rest-
  frame emissivity eps(r) = (r/r_in)^-q, exactly the imaging path's
  emission law (disk.disk_emission).

* **Hot-spot light curve** (`hotspot_light_curve`): total observed
  flux vs coordinate time for an orbiting bright spot — ONE geodesic
  trace, with the per-frame emission re-evaluated at the advected spot
  azimuth (the render_disk_frames mechanism, reduced over pixels
  instead of imaged). Doppler beaming modulates the flux once per
  orbit; lensing adds the characteristic asymmetric peak when the spot
  passes behind the hole.

The reference has no spectroscopy surface at all (its disk story is
absent entirely); this extends SURVEY §7's config-4 disk extension.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu import camera
from light_path_tracer_tpu.disk import (
    DiskConfig, HotSpot, trace_disk_rays, disk_emission, hotspot_pattern,
    _scene_metric,
    keplerian_redshift, keplerian_omega, r_isco, CAPTURED)
from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
from light_path_tracer_tpu.utils.timing import StageTimer


def _trace_disk_grid(scene, resolution, cfg, disk, timer, aa_samples=1,
                     record_time=False):
    """Shared setup: camera grids + one disk trace (render_disk's).

    aa_samples > 1 stacks jittered subpixel grids on the row axis
    (aa.aa_offsets pattern) — for spectra this multiplies the crossing
    SAMPLE COUNT, smoothing histogram bins near the sharp Doppler horns
    where per-pixel aliasing shows; flux weights are divided by the
    sample count so totals are unchanged.
    """
    from light_path_tracer_tpu.aa import aa_offsets
    metric = _scene_metric(scene)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    offsets = aa_offsets(aa_samples)

    with timer.stage("build_lookup") as out:
        alpha = jnp.concatenate([camera.build_alpha_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost, pixel_offset=tuple(o)) for o in offsets])
        theta = jnp.concatenate([camera.build_theta_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost, pixel_offset=tuple(o)) for o in offsets])
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        res = trace_disk_rays(
            metric, scene.r_obs, alpha.ravel(), theta.ravel(),
            scene.theta_obs, max(5000.0, 6.0 * scene.r_obs),
            cfg.max_steps, disk, backend=cfg.backend,
            precision=cfg.precision, method=cfg.integrator,
            record_time=record_time)
        out.append(res.status)

    dl = (jnp.concatenate([camera.doppler_lookup(
        resolution, fov, scene.boost, dtype=dtype,
        pixel_offset=tuple(o)) for o in offsets]).ravel()
          if scene.boosted else None)
    return metric, res, dl


def line_profile(scene: SceneConfig, resolution=(512, 512),
                 cfg: RenderConfig = RenderConfig(),
                 disk: DiskConfig = DiskConfig(),
                 n_bins: int = 200, g_lim=None, rest_energy: float = 6.4,
                 aa_samples: int = 1):
    """Observed line profile of a monochromatic disk emission line.

    Returns (energy_centers, flux, stats): flux[i] is the summed
    observed line flux arriving in energy bin i, energy_centers in the
    same units as `rest_energy` (default 6.4 = Fe K-alpha in keV; pass
    rest_energy=1.0 for the profile directly in g = E_obs/E_em).

    g_lim: (g_min, g_max) histogram range; None autoscales to the data
    with 2% margins. Flux weighting per crossing:
    g**disk.g_power * (r/r_in)^-q — photon-count flux for g_power=3
    (the DiskConfig default), bolometric-style for 4.
    """
    timer = StageTimer()
    _metric, res, dl = _trace_disk_grid(scene, resolution, cfg, disk,
                                        timer, aa_samples=aa_samples)
    r_in = disk.r_in if disk.r_in is not None else r_isco(
        scene.M, scene.a, disk.prograde, Q=scene.Q)

    with timer.stage("render") as out:
        n_slots = 1 if disk.opaque else disk.max_hits
        gs, ws = [], []
        for slot in range(n_slots):
            hit = res.n_hits > slot
            r_c = jnp.maximum(res.r_hits[slot], r_in)
            xi_slot = (res.xi_hits[slot]
                       if len(res.xi_hits) > slot else res.xi)
            g = keplerian_redshift(scene.M, scene.a, r_c, xi_slot,
                                   disk.prograde, Q=scene.Q)
            if dl is not None:
                g = g * dl
            eps = (r_c / r_in) ** (-disk.emissivity_index)
            w = jnp.where(hit, g ** disk.g_power * eps, 0.0) / aa_samples
            gs.append(jnp.where(hit, g, jnp.nan))
            ws.append(w)
        g_all = jnp.concatenate(gs)
        w_all = jnp.concatenate(ws)
        if g_lim is None:
            g_np = np.asarray(g_all)
            w_np = np.asarray(w_all)
            seen = g_np[w_np > 0]
            if seen.size == 0:
                raise ValueError(
                    "no disk crossings in the field of view — the line "
                    "profile is empty (check theta_obs / r_out / fov)")
            lo, hi = float(seen.min()), float(seen.max())
            margin = 0.02 * max(hi - lo, 1e-6)
            g_lim = (lo - margin, hi + margin)
        flux, edges = jnp.histogram(
            jnp.nan_to_num(g_all, nan=-1.0), bins=n_bins,
            range=g_lim, weights=w_all)
        out.append(flux)

    centers = 0.5 * (np.asarray(edges[:-1]) + np.asarray(edges[1:]))
    flux = np.asarray(flux, np.float64)
    stats = dict(
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        g_lim=tuple(g_lim),
        rest_energy=rest_energy,
        disk_pixels=int((np.asarray(res.n_hits) > 0).sum()),
        captured=int((np.asarray(res.status) == CAPTURED).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=resolution[0] * resolution[1] * aa_samples,
        traced_rays=resolution[0] * resolution[1] * aa_samples,
        timings=timer.finish())
    return centers * rest_energy, flux, stats


def hotspot_light_curve(scene: SceneConfig, resolution, times,
                        cfg: RenderConfig = RenderConfig(),
                        disk: DiskConfig = DiskConfig(),
                        spot: HotSpot = HotSpot(), pattern=None,
                        light_travel_delay: bool = False):
    """Total observed flux vs coordinate time for an orbiting hot spot.

    ONE geodesic trace; each sample re-evaluates the surface-brightness
    pattern at the advected azimuth and reduces over pixels (the
    render_disk_frames mechanism without materializing frames). Returns
    (times (T,), flux (T,), stats); flux is the un-tone-mapped physical
    intensity sum, so Doppler beaming and lensing magnification show at
    their true contrast. One spot orbit = stats['orbit_period'] in M.

    light_travel_delay=True records the coordinate time of every disk
    crossing during the trace (record_time) and evaluates the spot
    pattern at the RETARDED time t - delay(pixel): photons from the far
    side of the disk (and the lensed secondary image) left earlier, so
    the observer sees different pattern phases across one frame — the
    light-echo skew the equal-time approximation flattens. Delays are
    referenced to the earliest-arriving disk photon (a constant offset
    only re-phases a periodic pattern); stats['delay_spread'] reports
    the across-image spread in M.
    """
    timer = StageTimer()
    times = list(times)
    _metric, res, dl = _trace_disk_grid(scene, resolution, cfg, disk,
                                        timer,
                                        record_time=light_travel_delay)
    delay_hits = ()
    delay_spread = 0.0
    if light_travel_delay:
        # Reference the delays to the earliest-arriving recorded
        # crossing among lit pixels (slot 0 = the visible surface).
        hit0 = res.n_hits > 0
        if not bool(jnp.any(hit0)):
            # No pixel hits the disk (out-of-frame geometry): there is
            # nothing to retard — keep delays off instead of
            # propagating inf references into the pattern times.
            delay_hits = ()
        else:
            t0 = res.t_hits[0]
            big = jnp.asarray(jnp.inf, t0.dtype)
            t_ref = jnp.min(jnp.where(hit0, t0, big))
            delay_hits = tuple(t - t_ref for t in res.t_hits)
            t_max = jnp.max(jnp.where(hit0, t0, -big))
            delay_spread = float(t_max - t_ref)
    r_in = disk.r_in if disk.r_in is not None else r_isco(
        scene.M, scene.a, disk.prograde, Q=scene.Q)
    if pattern is None:
        pattern = hotspot_pattern(spot, scene.M, scene.a, disk.prograde,
                                  Q=scene.Q)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("render") as out:
        ts = jnp.asarray(times, dtype)

        # Trace arrays enter as jit ARGUMENTS (closing over them embeds
        # grid-sized constants that XLA constant-folds for minutes —
        # render_disk_frames's measured footgun).
        @jax.jit
        def curve(ts, n_hits, r_hits, xi, phi_hits, doppler, xi_hits,
                  delays):
            def flux_at(t):
                intensity, _rgb = disk_emission(
                    scene, disk, r_in, n_hits, r_hits, xi,
                    doppler=doppler, pattern=pattern,
                    phi_hits=phi_hits, t=t, xi_hits=xi_hits,
                    delay_hits=delays)
                return intensity.sum()
            return jax.vmap(flux_at)(ts)

        flux = curve(ts, res.n_hits, res.r_hits, res.xi, res.phi_hits,
                     dl, res.xi_hits, delay_hits)
        out.append(flux)

    stats = dict(
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        orbit_period=abs(2.0 * np.pi / keplerian_omega(
            scene.M, scene.a, spot.r0, disk.prograde, Q=scene.Q)),
        disk_pixels=int((np.asarray(res.n_hits) > 0).sum()),
        integrator_steps=int(res.n_steps),
        n_samples=len(times),
        delay_spread=delay_spread,
        total_rays=resolution[0] * resolution[1],
        traced_rays=resolution[0] * resolution[1],
        timings=timer.finish())
    return np.asarray(times, np.float64), np.asarray(flux, np.float64), stats
