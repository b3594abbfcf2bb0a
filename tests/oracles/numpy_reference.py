"""Independent NumPy/SciPy oracles for the JAX tracer.

These are deliberately written with *different* machinery than the library:
  * the Kerr Hamiltonian is differentiated by complex-step differentiation
    (machine-precision numerical derivatives) instead of hand-derived
    analytic expressions, so it cross-checks the library's analytic RHS;
  * full-geodesic integration uses scipy.integrate.solve_ivp (RK45, event
    termination), the same strategy as the reference's slow path
    (geodesic_tracer.py:57-67), not a lock-step masked loop;
  * the Schwarzschild fixed-step oracle is a scalar Python loop (one ray at
    a time), cross-checking the vectorized masked implementation.
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import solve_ivp


# ---------------------------------------------------------------------------
# Schwarzschild scalar fixed-step oracle (orbit equation)
# ---------------------------------------------------------------------------

def schw_trace_scalar(M, r_obs, alpha, phi_max=50.0, h_max=0.05):
    """Scalar fixed-step RK4 on u'' = -u + 3 M u^2 with event lerp.

    Returns (status, final_alpha, n_half): status 1 escaped, -1 captured,
    0 invalid. Mirrors the algorithm (not the code) of the production
    tracer so float64 results should agree to ~1e-12.
    """
    R_S = 2.0 * M
    f0 = 1.0 - R_S / r_obs
    if f0 <= 0.0:
        return 0, np.nan, 0
    b = r_obs * np.sin(alpha) / np.sqrt(f0)
    if b == 0.0:
        return 0, np.nan, 0
    u = 1.0 / r_obs
    w_sq = 1.0 / b**2 - u**2 + 2.0 * M * u**3
    if w_sq < 0.0:
        return 0, np.nan, 0
    w = np.sqrt(w_sq)

    u_cap = 1.0 / (R_S * 1.01)
    u_esc = 1.0 / (2.0 * r_obs)
    phi = 0.0
    status = 2

    def rhs(u, w):
        return w, -u + 3.0 * M * u * u

    while phi < phi_max:
        h = min(h_max, phi_max - phi)
        if h <= 0:
            break
        k1u, k1w = rhs(u, w)
        k2u, k2w = rhs(u + 0.5 * h * k1u, w + 0.5 * h * k1w)
        k3u, k3w = rhs(u + 0.5 * h * k2u, w + 0.5 * h * k2w)
        k4u, k4w = rhs(u + h * k3u, w + h * k3w)
        u_n = u + (h / 6.0) * (k1u + 2 * k2u + 2 * k3u + k4u)
        w_n = w + (h / 6.0) * (k1w + 2 * k2w + 2 * k3w + k4w)

        if u < u_cap <= u_n:
            frac = 1.0 if u_n == u else np.clip(
                (u_cap - u) / (u_n - u), 0.0, 1.0)
            phi += frac * h
            w = w + frac * (w_n - w)
            u = u_cap
            status = -1
            break
        if u > u_esc >= u_n:
            frac = 1.0 if u_n == u else np.clip(
                (u_esc - u) / (u_n - u), 0.0, 1.0)
            phi += frac * h
            w = w + frac * (w_n - w)
            u = u_esc
            status = 1
            break
        u, w = u_n, w_n
        phi += h

    r_f = 1.0 / u
    n_half = int(abs(phi) // np.pi)
    if status == -1 or r_f <= R_S * 1.1:
        return -1, np.nan, n_half
    dr_dphi = -w / u**2
    heading = np.arctan2(dr_dphi * np.sin(phi) + r_f * np.cos(phi),
                         dr_dphi * np.cos(phi) - r_f * np.sin(phi))
    final_alpha = np.arccos(np.clip(-np.cos(heading), -1.0, 1.0))
    return 1, final_alpha, n_half


# ---------------------------------------------------------------------------
# Kerr Hamiltonian + complex-step derivatives
# ---------------------------------------------------------------------------

def kerr_inverse_metric(M, a, r, th):
    """Contravariant Kerr metric components in Boyer-Lindquist coords.

    Works with complex inputs (for complex-step differentiation):
    trig via np.sin/np.cos on complex arguments.
    """
    sin = np.sin(th)
    cos = np.cos(th)
    sin2 = sin * sin
    Sigma = r * r + a * a * cos * cos
    Delta = r * r - 2.0 * M * r + a * a
    A = (r * r + a * a) ** 2 - a * a * Delta * sin2
    g_tt = -A / (Sigma * Delta)
    g_tphi = -2.0 * M * a * r / (Sigma * Delta)
    g_rr = Delta / Sigma
    g_thth = 1.0 / Sigma
    g_phiphi = (Delta - a * a * sin2) / (Sigma * Delta * sin2)
    return g_tt, g_tphi, g_rr, g_thth, g_phiphi


def kerr_hamiltonian(M, a, r, th, p_t, p_r, p_th, p_phi):
    g_tt, g_tphi, g_rr, g_thth, g_phiphi = kerr_inverse_metric(M, a, r, th)
    return 0.5 * (g_tt * p_t * p_t + 2.0 * g_tphi * p_t * p_phi
                  + g_rr * p_r * p_r + g_thth * p_th * p_th
                  + g_phiphi * p_phi * p_phi)


def kerr_rhs5_complex_step(M, a, r, th, p_r, p_th, p_t, p_phi, eps=1e-200):
    """Hamilton's equations via complex-step d/dr and d/dtheta of H.

    dx/dl = dH/dp (analytic, trivial); dp/dl = -dH/dx where the partial
    derivatives are Im(H(x + i*eps))/eps — exact to machine precision.
    """
    g_tt, g_tphi, g_rr, g_thth, g_phiphi = kerr_inverse_metric(M, a, r, th)
    dr = g_rr * p_r
    dth = g_thth * p_th
    dphi = g_tphi * p_t + g_phiphi * p_phi

    H_r = kerr_hamiltonian(M, a, r + 1j * eps, th, p_t, p_r, p_th, p_phi)
    H_th = kerr_hamiltonian(M, a, r, th + 1j * eps, p_t, p_r, p_th, p_phi)
    dp_r = -np.imag(H_r) / eps
    dp_th = -np.imag(H_th) / eps
    return dr, dth, dphi, dp_r, dp_th


# ---------------------------------------------------------------------------
# scipy full-geodesic integration (independent escape-angle oracle)
# ---------------------------------------------------------------------------

def integrate_kerr_scipy(M, a, state5, p_t, p_phi, r_obs,
                         lambda_max=5000.0, rtol=1e-10, atol=1e-12):
    """solve_ivp RK45 on the reduced 5-D state with terminal events.

    Returns (final_state5, outcome) with outcome in
    {'captured', 'escaped', 'maxrange'}.
    """
    r_plus = M + np.sqrt(M * M - a * a)
    r_cap = r_plus * 1.01
    r_esc = 2.0 * r_obs

    def rhs(_lam, y):
        r, th, phi, p_r, p_th = y
        dr, dth, dphi, dp_r, dp_th = kerr_rhs5_complex_step(
            M, a, r, th, p_r, p_th, p_t, p_phi)
        return [dr, dth, dphi, dp_r, dp_th]

    def ev_cap(_lam, y):
        return y[0] - r_cap
    ev_cap.terminal = True
    ev_cap.direction = -1

    def ev_esc(_lam, y):
        return y[0] - r_esc
    ev_esc.terminal = True
    ev_esc.direction = 1

    sol = solve_ivp(rhs, [0.0, lambda_max], list(state5), method="RK45",
                    events=[ev_cap, ev_esc], rtol=rtol, atol=atol)
    y_f = sol.y[:, -1]
    if sol.t_events[0].size:
        outcome = "captured"
    elif sol.t_events[1].size:
        outcome = "escaped"
    else:
        outcome = "maxrange"
    return y_f, outcome


def kerr_escape_angle(M, a, state5, p_t, p_phi):
    """Final viewing angle from an escaped state — independent scalar
    implementation of the coordinate-velocity extraction."""
    r, th, phi, p_r, p_th = state5
    sin_th, cos_th = np.sin(th), np.cos(th)
    sin2 = max(sin_th * sin_th, 1e-15)
    Sigma = r * r + a * a * cos_th * cos_th
    Delta = r * r - 2.0 * M * r + a * a
    dr_dl = Delta / Sigma * p_r
    dth_dl = p_th / Sigma
    dphi_dl = (-2.0 * M * a * r / (Sigma * Delta) * p_t
               + (Delta - a * a * sin2) / (Sigma * Delta * sin2) * p_phi)
    sp, cp = np.sin(phi), np.cos(phi)
    vx = sin_th * cp * dr_dl + r * cos_th * cp * dth_dl - r * sin_th * sp * dphi_dl
    vy = sin_th * sp * dr_dl + r * cos_th * sp * dth_dl + r * sin_th * cp * dphi_dl
    vz = cos_th * dr_dl - r * sin_th * dth_dl
    v = np.sqrt(vx * vx + vy * vy + vz * vz)
    return np.arccos(np.clip(-vx / v, -1.0, 1.0))
