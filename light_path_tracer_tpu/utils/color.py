"""Blackbody -> linear sRGB color mapping for the accretion-disk renderer.

A Doppler/gravitationally shifted blackbody spectrum is exactly a
blackbody at T_obs = g * T_em (Planck's law is form-invariant under
frequency scaling), so the observed *chromaticity* of a disk element
needs only the shifted temperature — the color pipeline is:

    T_obs -> CIE XYZ (Planck spectrum x CIE 1931 color matching
    functions) -> linear sRGB, luminance-normalized

The CIE 1931 2-degree color matching functions are evaluated with the
compact multi-lobe piecewise-Gaussian fit of Wyman, Sloan & Shirley
(JCGT 2013) — analytic, ~0.01 chromaticity accuracy, far better than
the perceptual differences at play here (a test pins D65-range
chromaticity at 6500 K). The XYZ -> linear sRGB matrix is the standard
IEC 61966-2-1 one.

Everything is precomputed into a 256-entry log-spaced RGB(T) table at
import (host NumPy); per-pixel evaluation is one interp per channel.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

T_MIN, T_MAX, N_TABLE = 500.0, 60000.0, 256

# Planck constants in (nm K) units: hc/k = 1.4388e7 nm K.
_HC_K = 1.43877688e7


def _piecewise_gauss(lam, alpha, mu, s1, s2):
    s = np.where(lam < mu, s1, s2)
    return alpha * np.exp(-0.5 * ((lam - mu) * s) ** 2)


def _cmf(lam):
    """CIE 1931 2-deg (xbar, ybar, zbar) via the Wyman-Sloan-Shirley
    multi-lobe Gaussian fit (their eq. 2 coefficients)."""
    x = (_piecewise_gauss(lam, 1.056, 599.8, 0.0264, 0.0323)
         + _piecewise_gauss(lam, 0.362, 442.0, 0.0624, 0.0374)
         + _piecewise_gauss(lam, -0.065, 501.1, 0.0490, 0.0382))
    y = (_piecewise_gauss(lam, 0.821, 568.8, 0.0213, 0.0247)
         + _piecewise_gauss(lam, 0.286, 530.9, 0.0613, 0.0322))
    z = (_piecewise_gauss(lam, 1.217, 437.0, 0.0845, 0.0278)
         + _piecewise_gauss(lam, 0.681, 459.0, 0.0385, 0.0725))
    return x, y, z


# Standard XYZ (D65 white) -> linear sRGB.
_XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
])


def _build_table():
    lam = np.linspace(380.0, 780.0, 201)            # nm
    xb, yb, zb = _cmf(lam)
    temps = np.geomspace(T_MIN, T_MAX, N_TABLE)
    # Relative spectral radiance B_lam ~ lam^-5 / (exp(hc/(lam k T)) - 1);
    # absolute scale divides out in the luminance normalization.
    with np.errstate(over="ignore"):
        b = lam[None, :] ** -5.0 / np.expm1(
            _HC_K / (lam[None, :] * temps[:, None]))
    X = np.trapezoid(b * xb[None, :], lam, axis=1)
    Y = np.trapezoid(b * yb[None, :], lam, axis=1)
    Z = np.trapezoid(b * zb[None, :], lam, axis=1)
    rgb = (_XYZ_TO_SRGB @ np.stack([X, Y, Z])).T
    # Luminance-normalize (color only; intensity is supplied by the
    # physics: sigma T_obs^4), clip out-of-gamut negatives, renormalize
    # so the max channel is 1 (keeps deep-red 500 K from vanishing).
    rgb = np.maximum(rgb / np.maximum(Y[:, None], 1e-30), 0.0)
    rgb = rgb / np.maximum(rgb.max(axis=1, keepdims=True), 1e-30)
    return temps, rgb.astype(np.float32)


_TEMPS, _RGB_TABLE = _build_table()
_LOG_T = np.log(_TEMPS).astype(np.float32)


def blackbody_rgb(T):
    """Linear-sRGB chromaticity (max-channel = 1) of a blackbody at
    temperature T [K], batched. T outside [T_MIN, T_MAX] clamps.

    The table is log-spaced, so the interpolation index is CLOSED FORM —
    two gathers + a lerp, no searchsorted (jnp.interp's sorted search
    lowers to a gather cascade).
    """
    logt = jnp.log(jnp.clip(jnp.asarray(T, jnp.float32), T_MIN, T_MAX))
    step = (_LOG_T[-1] - _LOG_T[0]) / (N_TABLE - 1)
    pos = jnp.clip((logt - _LOG_T[0]) / step, 0.0, N_TABLE - 1.0)
    i0 = jnp.clip(pos.astype(jnp.int32), 0, N_TABLE - 2)
    frac = (pos - i0.astype(pos.dtype))[..., None]
    table = jnp.asarray(_RGB_TABLE)
    return table[i0] * (1.0 - frac) + table[i0 + 1] * frac


def blackbody_chromaticity(T: float):
    """CIE (x, y) chromaticity at temperature T — test/diagnostic hook."""
    lam = np.linspace(380.0, 780.0, 201)
    xb, yb, zb = _cmf(lam)
    with np.errstate(over="ignore"):
        b = lam ** -5.0 / np.expm1(_HC_K / (lam * T))
    X, Y, Z = (np.trapezoid(b * c, lam) for c in (xb, yb, zb))
    s = X + Y + Z
    return float(X / s), float(Y / s)
