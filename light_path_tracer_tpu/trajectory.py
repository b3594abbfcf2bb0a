"""Full-trajectory geodesic integration (the reference's scipy path).

Parity surface: /root/reference/geodesic_tracer.py:22-82 — integrate the
public 8-D Hamiltonian state with terminal capture/escape events and return
the *whole path* for visualization and conservation checks (the compiled
tracers only return the final angle).

Array design: a fixed-length `lax.scan` with per-step masked freezing
records the path at every step; the scan is batched over rays (vmap), so
one jitted program integrates and records any number of trajectories.
Adaptivity is approximated with a curvature-scheduled step (smaller h near
the horizon), which is enough for plotting and conservation testing; the
production angle path is ops/kerr_trace.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu.ops import tableau as tb


class Trajectory(NamedTuple):
    states: jnp.ndarray    # (n_steps+1, ..., 8) recorded path
    lambdas: jnp.ndarray   # (n_steps+1, ...) affine parameter
    outcome: jnp.ndarray   # (...,) int32: 1 escaped, -1 captured, 0 invalid
    n_valid: jnp.ndarray   # (...,) int32 number of live samples


@functools.partial(
    jax.jit,
    static_argnames=("metric", "n_steps", "r_obs", "rtol", "atol"))
def integrate_geodesic_8d_adaptive(metric, state0, *, r_obs,
                                   n_steps: int = 2000,
                                   rtol: float = 1e-8, atol: float = 1e-10):
    """Adaptive DP45 path recorder on the public 8-D state.

    The batched equivalent of the reference's scipy solve_ivp RK45 slow
    path (geodesic_tracer.py:57-67): same tolerances (rtol 1e-8 /
    atol 1e-10), terminal capture/escape events with interpolation onto
    the crossing, and the whole accepted-step sequence recorded (the
    dense-output analogue). Runs as a lax.scan over fixed attempt slots;
    rejected attempts re-record the current point.

    state0: (..., 8); batched over leading axes.
    """
    r_stop_inner = metric.capture_radius()
    r_stop_outer = 2.0 * float(r_obs)
    dtype = state0.dtype
    lead = state0.shape[:-1]

    def rhs(s):
        return metric.geodesic_equations(0.0, s)

    def attempt(carry, _):
        s, k1, h, lam, done = carry
        hh = h[..., None]
        k2 = rhs(s + hh * tb.A21 * k1)
        k3 = rhs(s + hh * (tb.A31 * k1 + tb.A32 * k2))
        k4 = rhs(s + hh * (tb.A41 * k1 + tb.A42 * k2 + tb.A43 * k3))
        k5 = rhs(s + hh * (tb.A51 * k1 + tb.A52 * k2 + tb.A53 * k3
                           + tb.A54 * k4))
        k6 = rhs(s + hh * (tb.A61 * k1 + tb.A62 * k2 + tb.A63 * k3
                           + tb.A64 * k4 + tb.A65 * k5))
        s5 = s + hh * (tb.B1 * k1 + tb.B3 * k3 + tb.B4 * k4
                       + tb.B5 * k5 + tb.B6 * k6)
        k7 = rhs(s5)

        err = hh * (tb.E1 * k1 + tb.E3 * k3 + tb.E4 * k4
                    + tb.E5 * k5 + tb.E6 * k6 + tb.E7 * k7)
        sc = atol + rtol * jnp.maximum(jnp.abs(s), jnp.abs(s5))
        err_norm = jnp.sqrt(jnp.mean((err / sc) ** 2, axis=-1))
        finite = jnp.all(jnp.isfinite(s5), axis=-1)
        accept = ~done & finite & (err_norm <= 1.0)

        r_prev, r_next = s[..., 1], s5[..., 1]
        cap = accept & (r_prev > r_stop_inner) & (r_next <= r_stop_inner)
        esc = accept & (r_prev < r_stop_outer) & (r_next >= r_stop_outer)
        den = jnp.where(r_next == r_prev, 1.0, r_next - r_prev)
        frac = jnp.where(
            cap, jnp.clip((r_stop_inner - r_prev) / den, 0.0, 1.0),
            jnp.where(esc, jnp.clip((r_stop_outer - r_prev) / den,
                                    0.0, 1.0), 1.0))
        # Cubic-Hermite event interpolation (endpoint derivatives are
        # free via FSAL) — keeps the terminal sample on the solution
        # manifold (null condition holds) unlike a linear lerp.
        fr = frac[..., None]
        fr2 = fr * fr
        fr3 = fr2 * fr
        s_interp = ((2 * fr3 - 3 * fr2 + 1) * s
                    + (fr3 - 2 * fr2 + fr) * hh * k1
                    + (-2 * fr3 + 3 * fr2) * s5
                    + (fr3 - fr2) * hh * k7)
        s_new = jnp.where((cap | esc)[..., None], s_interp, s5)

        factor = 0.9 * jnp.maximum(err_norm, 1e-30) ** (-0.2)
        h_new = jnp.where(accept, h * jnp.clip(factor, 0.2, 5.0),
                          jnp.where(~done & finite,
                                    h * jnp.maximum(factor, 0.2),
                                    h * 0.25))
        h_new = jnp.minimum(h_new, 1.0 * r_stop_outer)

        s_out = jnp.where(accept[..., None], s_new, s)
        k1_out = jnp.where((accept & ~(cap | esc))[..., None], k7, k1)
        lam_out = jnp.where(accept, lam + frac * h, lam)
        done_out = done | cap | esc | ~finite
        return ((s_out, k1_out, h_new, lam_out, done_out),
                (s_out, lam_out, accept & ~done))

    lam0 = jnp.zeros(lead, dtype)
    done0 = jnp.zeros(lead, bool)
    h0 = jnp.full(lead, 0.1, dtype)
    carry0 = (state0, rhs(state0), h0, lam0, done0)
    (s_f, _k, _h, _lam, _done), (path, lams, live) = jax.lax.scan(
        attempt, carry0, None, length=n_steps)

    states = jnp.concatenate([state0[None], path], axis=0)
    lambdas = jnp.concatenate([lam0[None], lams], axis=0)
    live_full = jnp.concatenate(
        [jnp.ones((1,) + lead, bool), live], axis=0)
    # Compact: move accepted samples to the front (rejected attempt slots
    # re-recorded the previous point), so states[:n_valid] is the path.
    order = jnp.argsort(~live_full, axis=0, stable=True)
    states = jnp.take_along_axis(states, order[..., None], axis=0)
    lambdas = jnp.take_along_axis(lambdas, order, axis=0)
    n_valid = jnp.sum(live_full, axis=0).astype(jnp.int32)
    final_r = s_f[..., 1]
    outcome = jnp.where(final_r <= r_stop_inner * 1.1, -1,
                        jnp.where(jnp.all(jnp.isfinite(s_f), axis=-1),
                                  1, 0)).astype(jnp.int32)
    return Trajectory(states, lambdas, outcome, n_valid)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "n_steps", "r_obs"))
def integrate_geodesic_8d(metric, state0, *, r_obs, n_steps: int = 4000,
                          h_base: float = 0.5):
    """Integrate 8-D states (…, 8) with capture/escape stopping.

    Stopping radii match geodesic_tracer.py:42-55: inner =
    metric.capture_radius(), outer = 2 * r_obs.
    """
    r_stop_inner = metric.capture_radius()
    r_stop_outer = 2.0 * float(r_obs)
    dtype = state0.dtype
    h_base = jnp.asarray(h_base, dtype)

    def rhs(s):
        return metric.geodesic_equations(0.0, s)

    def step(carry, _):
        s, lam, done = carry
        r = s[..., 1]
        # Curvature-scheduled step: shrink near the inner boundary.
        h = h_base * jnp.clip((r - r_stop_inner) / (10.0 * r_stop_inner),
                              0.02, 1.0)
        h = jnp.where(done, 0.0, h)[..., None]

        k1 = rhs(s)
        k2 = rhs(s + 0.5 * h * k1)
        k3 = rhs(s + 0.5 * h * k2)
        k4 = rhs(s + h * k3)
        s_next = s + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

        r_next = s_next[..., 1]
        newly_done = (r_next <= r_stop_inner) | (r_next >= r_stop_outer) | \
            ~jnp.all(jnp.isfinite(s_next), axis=-1)
        s_out = jnp.where(done[..., None], s, s_next)
        lam_out = jnp.where(done, lam, lam + h[..., 0])
        done_out = done | newly_done
        return (s_out, lam_out, done_out), (s_out, lam_out, done_out)

    lam0 = jnp.zeros(state0.shape[:-1], dtype)
    done0 = jnp.zeros(state0.shape[:-1], bool)
    (_s_f, _lam_f, done_f), (path, lams, dones) = jax.lax.scan(
        step, (state0, lam0, done0), None, length=n_steps)

    states = jnp.concatenate([state0[None], path], axis=0)
    lambdas = jnp.concatenate([lam0[None], lams], axis=0)
    n_valid = 1 + jnp.sum(~dones, axis=0).astype(jnp.int32)

    final_r = _s_f[..., 1]
    outcome = jnp.where(final_r <= r_stop_inner * 1.1, -1,
                        jnp.where(jnp.all(jnp.isfinite(_s_f), axis=-1),
                                  1, 0)).astype(jnp.int32)
    return Trajectory(states, lambdas, outcome, n_valid)


def trace_ray_trajectory(metric, r_obs, alpha, theta=0.0,
                         theta_obs=np.pi / 2, n_steps: int = 4000,
                         h_base: float = 0.5, dtype=jnp.float32,
                         method: str = "adaptive"):
    """Single-ray full-path trace (geodesic_tracer.py:74-82 front-end).

    method: 'adaptive' (DP45, reference-tolerance — the scipy-path
    equivalent) or 'fixed' (curvature-scheduled RK4).
    Returns (Trajectory, outcome_str). outcome: 'captured'/'escaped'/
    'invalid'.
    """
    alpha_arr = jnp.asarray([alpha], dtype)
    state8, invalid = metric.initial_conditions_8d(
        float(r_obs), alpha_arr, theta, theta_obs)
    if bool(invalid[0]):
        return None, "invalid"
    if method == "adaptive":
        traj = integrate_geodesic_8d_adaptive(
            metric, state8[0], r_obs=float(r_obs),
            n_steps=min(n_steps, 2000))
    else:
        traj = integrate_geodesic_8d(
            metric, state8[0], r_obs=float(r_obs), n_steps=n_steps,
            h_base=h_base)
    outcome = {1: "escaped", -1: "captured", 0: "invalid"}[int(traj.outcome)]
    return traj, outcome


def plot_trajectories(metric, r_obs, angles_deg, ax=None, dtype=jnp.float32):
    """Equatorial-plane trajectory overlay (geodesic_tracer.py:89-142).

    Requires matplotlib (the optional viz extra); imports lazily so
    environments without display deps can use the rest of the package.
    """
    import matplotlib.pyplot as plt

    if ax is None:
        _fig, ax = plt.subplots(figsize=(10, 10))

    circle = np.linspace(0, 2 * np.pi, 200)
    r_horizon = metric.capture_radius()
    ax.fill(r_horizon * np.cos(circle), r_horizon * np.sin(circle),
            "k", label="Event horizon")
    if hasattr(metric, "R_PHOTON"):
        r_ph = metric.R_PHOTON
        ax.plot(r_ph * np.cos(circle), r_ph * np.sin(circle),
                "r--", linewidth=1.5, label="Photon sphere")
    ax.plot(r_obs, 0, "go", markersize=10, label=f"Observer (r={r_obs}M)")

    for alpha_deg in angles_deg:
        traj, outcome = trace_ray_trajectory(
            metric, r_obs, np.radians(alpha_deg), dtype=dtype)
        if traj is None:
            continue
        n = int(traj.n_valid)
        r = np.asarray(traj.states[:n, 1])
        phi = np.asarray(traj.states[:n, 3])
        x = r * np.cos(phi)
        y = r * np.sin(phi)
        color = "steelblue" if outcome == "escaped" else "crimson"
        style = "-" if outcome == "escaped" else "--"
        ax.plot(x, y, color=color, linestyle=style, linewidth=1.2,
                label=f"α={alpha_deg}° ({outcome})")

    alpha_crit = np.degrees(metric.alpha_crit(r_obs))
    ax.set_title(f"Photon trajectories (critical angle ≈ {alpha_crit:.2f}°)")
    ax.set_xlabel("x / M")
    ax.set_ylabel("y / M")
    ax.set_aspect("equal")
    ax.legend(loc="upper left", fontsize=8)
    ax.grid(True, alpha=0.3)
    return ax
