"""Interferometric observables: rendered images in the visibility domain.

Radio interferometers (the EHT, for black holes) never see the image —
they sample its 2-D Fourier transform, the complex *visibility*
V(u, v) = ∬ I(l, m) e^{-2πi(ul + vm)} dl dm, on baselines (u, v)
measured in observing wavelengths (equivalently: cycles per radian of
sky angle, which is the unit used throughout this module). The
signature measurements — the deep first minimum of |V| whose baseline
encodes the shadow/ring diameter, the weak ringing beyond it from the
photon ring — are one FFT away from any image this framework renders.

This module provides that last mile on-device (jnp.fft rides XLA):

* `visibilities(image, fov)` — flux-normalized complex V on the FFT
  baseline grid, with correct tangent-plane pixel scale.
* `radial_profile(...)` — azimuthally averaged |V| vs baseline length,
  the standard 1-D reduction for near-circular sources.
* `first_null(...)` — baseline of the first deep minimum.
* `ring_diameter_from_null` / `disk_diameter_from_null` — invert the
  null through the two canonical analytic models: an infinitesimally
  thin ring (|V| = |J0(π b d)|, first zero at πbd = 2.404826) and a
  uniform disk (|V| = |2 J1(π b d)/(π b d)|, first zero at 3.831706).
* `shadow_diameter(image, fov)` — end-to-end: image → |V| profile →
  first null → angular diameter estimate.

Geometry: the pinhole camera samples the image uniformly on the
tangent plane (camera.py: x_cam, y_cam are tangents of the view
angles), and interferometry's (l, m) direction cosines coincide with
tangent-plane coordinates to first order in the field size — so the
FFT's uniform-grid assumption is exact in the camera's native
coordinates, with pixel scale Δl = 2·tan(fov/2)/N per axis (NOT
fov/N; identical to 2nd order for small fields, but free to get
right). Angles are radians, so baselines come out in wavelengths.

The reference has no interferometric surface at all (its products end
at PNG images); this extends the framework's observable set the same
way spectra.py did for spectroscopy. Everything here is O(N² log N)
elementwise+FFT work — negligible next to the geodesic trace, and a
single fused XLA program when jitted.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# First zeros of the Bessel functions J0 and J1: the visibility nulls
# of a thin ring and of a uniform disk of angular diameter d sit at
# baseline b = j0_1/(pi d) and j1_1/(pi d) respectively.
_J0_FIRST_ZERO = 2.404825557695773
_J1_FIRST_ZERO = 3.8317059702075125

_LUMA = np.array([0.299, 0.587, 0.114])


def intensity(image):
    """(H, W) nonnegative intensity from an (H, W[, 3]) rendered image.

    RGB collapses through the same luma weights render.py uses for
    grayscale sources; intensity is what an interferometer measures.
    """
    img = jnp.asarray(image)
    if img.ndim == 3:
        img = jnp.matmul(img, jnp.asarray(_LUMA, dtype=img.dtype),
                         precision=jax.lax.Precision.HIGHEST)
    return img


def pixel_scales(shape, fov):
    """Tangent-plane (Δm, Δl) [rad/pixel] for an (H, W) image with
    camera FOV (horizontal, vertical) — derived from the SAME focal
    lengths the render geometry uses (camera.focal_lengths: fx =
    (W/2)/tan(fov_h/2)), so the visibility pixel scale can never
    diverge from the camera model."""
    from light_path_tracer_tpu.camera import focal_lengths
    fx, fy = focal_lengths(shape, fov)
    return 1.0 / fy, 1.0 / fx  # (dm, dl)


def centroid_track(frames, fov):
    """Intensity-weighted image photocenter per frame (radians).

    The GRAVITY flare observable: an orbiting hot spot's APPARENT
    photocenter wanders on the sky as it orbits — by less than the
    spot's own orbital diameter, because the steady crescent and the
    lensed secondary image (which swings to the OPPOSITE side of the
    hole) both pull the centroid back toward the black hole. The
    reference has no time-domain product at all; this rides the
    one-trace movie recorders (volumetric.render_volumetric_movie
    stats['emission'], disk.render_disk_frames raw frames).

    Args:
      frames: (T, H, W), (H, W), or (..., 3) RGB linear intensity —
        use RAW emission, not tone-mapped display frames (tone maps
        are nonlinear and bias the centroid toward faint structure).
      fov: (horizontal, vertical) field of view in radians.

    Returns:
      (T, 2) [or (2,) for a single image] tangent-plane centroid
      offsets from the image center, columns (x, y) with +x along
      +columns and +y along +rows — exactly camera.pixel_to_angles'
      x_cam/y_cam convention (x = (col - W/2)/fx), so a point source
      at pixel p has centroid equal to that pixel's camera-ray tangent
      coordinates.
    """
    from light_path_tracer_tpu.camera import focal_lengths
    img = jnp.asarray(frames)
    if img.ndim >= 3 and img.shape[-1] == 3:
        img = jnp.matmul(img, jnp.asarray(_LUMA, dtype=img.dtype),
                         precision=jax.lax.Precision.HIGHEST)
    single = img.ndim == 2
    if single:
        img = img[None]
    _t, height, width = img.shape
    fx, fy = focal_lengths((height, width), fov)
    x = (jnp.arange(width, dtype=img.dtype) - width / 2.0) / fx
    y = (jnp.arange(height, dtype=img.dtype) - height / 2.0) / fy
    flux = jnp.maximum(jnp.sum(img, axis=(1, 2)), 1e-300)
    cx = jnp.sum(img * x[None, None, :], axis=(1, 2)) / flux
    cy = jnp.sum(img * y[None, :, None], axis=(1, 2)) / flux
    track = jnp.stack([cx, cy], axis=-1)
    return track[0] if single else track


def visibilities(image, fov, pad: int = 4):
    """Complex visibility of a rendered image on the FFT baseline grid.

    Args:
      image: (H, W) or (H, W, 3) nonnegative brightness.
      fov: (horizontal, vertical) field of view in radians
        (camera.fov_from_vertical's return).
      pad: zero-padding factor (the padded transform samples the same
        continuous visibility function more finely — standard practice
        for locating nulls between coarse FFT bins).

    Returns:
      (vis, u, v): vis (pH, pW) complex, flux-normalized so
      vis[center] == 1; u (pW,) and v (pH,) baseline coordinates in
      wavelengths (cycles/radian), fftshifted to ascending order.
    """
    img = intensity(image)
    height, width = img.shape
    dm, dl = pixel_scales((height, width), fov)
    ph, pw = int(height * pad), int(width * pad)

    total = jnp.sum(img)
    # Guard the dark-frame edge case; a zero image has zero visibility.
    norm = jnp.where(total > 0, total, 1.0)
    spec = jnp.fft.fftshift(jnp.fft.fft2(img / norm, s=(ph, pw)))
    u = jnp.fft.fftshift(jnp.fft.fftfreq(pw, d=dl))
    v = jnp.fft.fftshift(jnp.fft.fftfreq(ph, d=dm))
    # Re-center the phase on the image center so a centered source has
    # ~zero phase slope (fft2 references pixel [0, 0]).
    cy, cx = height / 2.0, width / 2.0
    phase = jnp.exp(2j * jnp.pi * (u[None, :] * dl * cx +
                                   v[:, None] * dm * cy))
    return spec * phase, u, v


def radial_profile(vis, u, v, n_bins: int = 0):
    """Azimuthally averaged |V| vs baseline length.

    Returns (baselines (n_bins,), amp (n_bins,)); bins with no samples
    carry amp = 0 (they only occur beyond the grid's corner radius).
    """
    amp2d = jnp.abs(vis)
    b = jnp.sqrt(u[None, :] ** 2 + v[:, None] ** 2)
    b_max = float(min(np.max(np.abs(np.asarray(u))),
                      np.max(np.abs(np.asarray(v)))))
    if n_bins <= 0:
        n_bins = max(vis.shape) // 2
    edges = jnp.linspace(0.0, b_max, n_bins + 1)
    idx = jnp.clip(jnp.searchsorted(edges, b.ravel(), side="right") - 1,
                   0, n_bins - 1)
    # Mask samples beyond b_max (grid corners) out of the average.
    in_range = (b.ravel() <= b_max)
    w = in_range.astype(amp2d.dtype)
    sums = jnp.zeros(n_bins, amp2d.dtype).at[idx].add(amp2d.ravel() * w)
    counts = jnp.zeros(n_bins, amp2d.dtype).at[idx].add(w)
    amp = jnp.where(counts > 0, sums / jnp.maximum(counts, 1), 0.0)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, amp


def first_null(baselines, amp):
    """Baseline of the first deep minimum of an |V| profile.

    The first null is the first local minimum after the central peak
    (|V| decreases from 1, bottoms out, and rises into the second
    lobe). Returns the parabolic-refined minimum location; NaN if the
    profile never turns back up (no null within the sampled range).
    Host-side (numpy) — this is analysis, not a hot path.
    """
    b = np.asarray(baselines, dtype=np.float64)
    a = np.asarray(amp, dtype=np.float64)
    # Local minima strictly inside the range.
    interior = (a[1:-1] <= a[:-2]) & (a[1:-1] < a[2:])
    idxs = np.nonzero(interior)[0] + 1
    if idxs.size == 0:
        return float("nan")
    i = int(idxs[0])
    # Parabolic refinement through (i-1, i, i+1).
    denom = a[i - 1] - 2 * a[i] + a[i + 1]
    if denom <= 0:
        return float(b[i])
    shift = 0.5 * (a[i - 1] - a[i + 1]) / denom
    db = b[1] - b[0]
    return float(b[i] + np.clip(shift, -1, 1) * db)


def ring_diameter_from_null(b_null):
    """Angular diameter [rad] of a thin ring whose first |V| null is at
    baseline b_null [wavelengths]: d = j0_1 / (π b)."""
    return _J0_FIRST_ZERO / (np.pi * b_null)


def disk_diameter_from_null(b_null):
    """Angular diameter [rad] of a uniform disk whose first |V| null is
    at baseline b_null [wavelengths]: d = j1_1 / (π b)."""
    return _J1_FIRST_ZERO / (np.pi * b_null)


def shadow_diameter(image, fov, model: str = "disk", pad: int = 4,
                    n_bins: int = 0):
    """Estimate a source's angular diameter from its visibility null.

    model="disk" inverts through the uniform-disk kernel (right for a
    filled shadow silhouette); model="ring" through the thin-ring
    kernel (right for photon-ring-dominated images). Returns
    (diameter_rad, b_null, (baselines, amp)) so callers can plot the
    profile they measured.
    """
    vis, u, v = visibilities(image, fov, pad=pad)
    baselines, amp = radial_profile(vis, u, v, n_bins=n_bins)
    b_null = first_null(np.asarray(baselines), np.asarray(amp))
    invert = {"disk": disk_diameter_from_null,
              "ring": ring_diameter_from_null}
    if model not in invert:
        raise ValueError(f"model must be 'disk' or 'ring', got {model!r}")
    return invert[model](b_null), b_null, (baselines, amp)


def visibility_at(image, fov, uv_points):
    """Exact complex visibility at arbitrary (u, v) baselines.

    Direct DFT against the image (no FFT-grid interpolation):
    V(u, v) = Σ I(l, m) e^{-2πi(ul + vm)} / Σ I, phase-referenced to
    the image center like `visibilities`. uv_points is (K, 2) as
    (u, v) in wavelengths; returns (K,) complex. O(K · H · W) — exact
    and cheap for the handfuls of stations real arrays have.
    """
    img = intensity(image)
    height, width = img.shape
    dm, dl = pixel_scales((height, width), fov)
    l = (jnp.arange(width) - width / 2.0) * dl
    m = (jnp.arange(height) - height / 2.0) * dm
    uv = jnp.atleast_2d(jnp.asarray(uv_points, jnp.float64))
    total = jnp.sum(img)
    norm = jnp.where(total > 0, total, 1.0)
    phase = (uv[:, 0][:, None, None] * l[None, None, :]
             + uv[:, 1][:, None, None] * m[None, :, None])
    kern = jnp.exp(-2j * jnp.pi * phase)
    return jnp.sum(kern * (img / norm)[None, :, :], axis=(1, 2))


def closure_phase(image, fov, b1, b2):
    """Closure phase [rad] on the baseline triangle (b1, b2, b3) with
    b3 = -(b1 + b2): arg of the bispectrum V(b1) V(b2) V(b3).

    The quantity interferometry actually trusts: per-station gain
    phases cancel identically around a closed triangle, so closure
    phase survives calibration errors that corrupt V's raw phase. For
    any point source it is 0 exactly (position phase slopes telescope
    around the triangle); for a centro-symmetric source it is 0 or π
    (V is real); asymmetry — e.g. the Doppler-boosted crescent of a
    disk image — shows up as a nonzero closure phase.
    """
    b1 = np.asarray(b1, np.float64)
    b2 = np.asarray(b2, np.float64)
    b3 = -(b1 + b2)
    v = visibility_at(image, fov, np.stack([b1, b2, b3]))
    bispectrum = v[0] * v[1] * v[2]
    return float(jnp.angle(bispectrum))
