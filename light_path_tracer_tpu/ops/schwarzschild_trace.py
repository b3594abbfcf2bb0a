"""Batched Schwarzschild orbit-equation tracer.

Batched replacement for the reference's per-ray Numba loop
(/root/reference/metrics.py:50-145): one `lax.while_loop` advances the
*entire* ray batch in lock-step through the reduced 2-D orbit ODE
u''(phi) = -u + 3 M u^2 with fixed-step RK4, per-lane masked
capture/escape events with linear interpolation onto the crossing, and a
vectorized escape-heading angle extraction.

Status codes (metrics.py:69): 1 escaped, -1 captured, 0 invalid,
2 max-range (folded into escaped at extraction, metrics.py:127-145).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu.ops.types import TraceResult

# np.int32, not Python int — same x64 promotion hazard as
# ops.kerr_trace (see the comment on its status constants).
RUNNING = np.int32(2)
ESCAPED = np.int32(1)
CAPTURED = np.int32(-1)
INVALID = np.int32(0)


def _lerp_frac(prev, nxt, target):
    """Fraction of the step at which `prev -> nxt` crosses `target`."""
    denom = nxt - prev
    frac = jnp.where(denom == 0.0, 1.0, (target - prev) /
                     jnp.where(denom == 0.0, 1.0, denom))
    return jnp.clip(frac, 0.0, 1.0)


@functools.partial(
    jax.jit, static_argnames=("metric", "r_obs", "phi_max", "h_max"))
def trace_rays_schwarzschild(metric, r_obs, alphas,
                             phi_max: float = 50.0, h_max: float = 0.05):
    """Trace a batch of Schwarzschild rays; returns TraceResult.

    Parameters mirror metrics.py:817-833 (phi_max=50, h=0.05 defaults).
    alphas: (N,) viewing angles (radians). Runs as a single XLA program.
    """
    dtype = alphas.dtype
    M = jnp.asarray(metric.M, dtype)
    R_S = metric.R_S

    u0, w0, invalid = metric.orbit_initial_state(r_obs, alphas)
    u_capture = jnp.asarray(1.0 / (R_S * 1.01), dtype)
    u_escape = jnp.asarray(1.0 / (2.0 * r_obs), dtype)
    phi_max_a = jnp.asarray(phi_max, dtype)
    n_steps = int(np.ceil(phi_max / h_max))

    status0 = jnp.where(invalid, INVALID, RUNNING).astype(jnp.int32)
    phi0 = jnp.zeros_like(alphas)

    def rhs(u, w):
        # Metric-supplied orbit equation (Schwarzschild: -u + 3 M u^2;
        # Reissner-Nordstrom adds -2 Q^2 u^3). `metric` is static, so
        # the body inlines into the compiled loop.
        return metric.orbit_rhs(u, w)

    def cond(carry):
        step, u, w, phi, status = carry
        return (step < n_steps) & jnp.any(status == RUNNING)

    def body(carry):
        step, u, w, phi, status = carry
        active = status == RUNNING
        h = jnp.minimum(jnp.asarray(h_max, dtype), phi_max_a - phi)
        h = jnp.maximum(h, 0.0)

        k1u, k1w = rhs(u, w)
        k2u, k2w = rhs(u + 0.5 * h * k1u, w + 0.5 * h * k1w)
        k3u, k3w = rhs(u + 0.5 * h * k2u, w + 0.5 * h * k2w)
        k4u, k4w = rhs(u + h * k3u, w + h * k3w)
        u_next = u + (h / 6.0) * (k1u + 2.0 * k2u + 2.0 * k3u + k4u)
        w_next = w + (h / 6.0) * (k1w + 2.0 * k2w + 2.0 * k3w + k4w)

        cap = (u < u_capture) & (u_next >= u_capture)
        esc = (u > u_escape) & (u_next <= u_escape) & ~cap

        frac_cap = _lerp_frac(u, u_next, u_capture)
        frac_esc = _lerp_frac(u, u_next, u_escape)
        frac = jnp.where(cap, frac_cap, jnp.where(esc, frac_esc, 1.0))

        u_new = jnp.where(cap, u_capture,
                          jnp.where(esc, u_escape, u_next))
        w_new = w + frac * (w_next - w)
        phi_new = phi + frac * h

        status_new = jnp.where(cap, CAPTURED,
                               jnp.where(esc, ESCAPED, status))

        u = jnp.where(active, u_new, u)
        w = jnp.where(active, w_new, w)
        phi = jnp.where(active, phi_new, phi)
        status = jnp.where(active, status_new, status)
        return step + 1, u, w, phi, status

    step_f, u_f, w_f, phi_f, status_f = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), u0, w0, phi0, status0))

    final_alpha, n_half, captured_by_radius = metric.orbit_extract_angle(
        phi_f, u_f, w_f)

    # Max-range (still RUNNING) folds into escaped; radius check can
    # reclassify as captured (metrics.py:134-135).
    escaped_like = (status_f == ESCAPED) | (status_f == RUNNING)
    captured = (status_f == CAPTURED) | (escaped_like & captured_by_radius)
    invalid_f = status_f == INVALID

    status_out = jnp.where(
        invalid_f, INVALID,
        jnp.where(captured, CAPTURED, ESCAPED)).astype(jnp.int32)
    nan = jnp.asarray(jnp.nan, dtype)
    final_alpha = jnp.where(status_out == ESCAPED, final_alpha, nan)
    n_half = jnp.where(invalid_f, 0, n_half)
    return TraceResult(final_alpha, n_half, status_out, step_f)
