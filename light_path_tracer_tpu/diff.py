"""Differentiable geodesic tracing: gradients THROUGH the integrator.

A capability no CPU/Numba tracer can offer and the reference does not
attempt: because the whole pipeline here is functional JAX, a
fixed-length `lax.scan` tracer is reverse-mode differentiable, so the
final deflection field's sensitivity to the physical scene —
∂(final_alpha)/∂(a, M, r_obs, theta_obs) — comes from `jax.grad`
instead of finite differences, and inverse problems ("which spin
produced this deflection field / this lensed image?") become gradient
descent: the array framework earns something new from its
architecture, not just speed.

Design notes (why this is a separate path from ops/kerr_trace.py):

* The production tracers use `lax.while_loop`, which XLA cannot
  reverse-differentiate. This module re-expresses the fixed-step RK4
  comparison integrator (ops/kerr_rk4.py, itself the parity port of
  reference metrics.py:570-658) as a fixed-length `lax.scan` with
  per-lane done-freezing (h = 0 once captured/escaped) — same
  semantics lane-for-lane when every ray terminates within `n_steps`,
  plus a valid reverse pass.
* (M, a) ride `models.kerr.TracedKerr`, the traced-parameter variant
  the animation path already uses, so parameters are tangents, not
  compiled constants.
* Event localization (the linear interpolation onto the
  capture/escape radius crossing, metrics.py:630-647) is kept INSIDE
  the differentiable graph: the crossing fraction depends smoothly on
  the state, which is exactly the implicit-function derivative of the
  stopping condition. Gradients are therefore smooth wherever the
  outcome classification is locally constant (every escaping ray not
  exactly on the shadow boundary).
* Gradient validity requires no lane to go non-finite mid-trace (a
  NaN excursion would poison the shared (M, a) cotangent through the
  batched RHS). Escaping rays traced in float64 at the default steps
  are clean; `trace_final_alpha_diff` returns the status so callers
  and tests can assert it. Degenerate-measure-zero configurations
  (rays exactly along the screen axes, final_alpha exactly 0 or π)
  sit on clamp boundaries (sqrt(max(x, 0)), arccos(clip)) where the
  derivative is one-sided; keep fit rays off them.

`fit_scene_params` wraps the tracer in a Levenberg–Marquardt loop
with forward-mode Jacobians — the "measure the spin from a deflection
field" demo; tests recover a=0.7 from data generated at a=0.7
starting at a=0.35, and pin jax.grad against central finite
differences.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu.models.kerr import TracedKerr
from light_path_tracer_tpu.ops.kerr_rk4 import _rk4_step
from light_path_tracer_tpu.ops.kerr_trace import (
    RUNNING, ESCAPED, CAPTURED, INVALID, _all_finite, _select, _lerp)

#: Parameters fit_scene_params knows how to optimize, in the order the
#: flat parameter vector uses.
FITTABLE = ("a", "M", "r_obs", "theta_obs")


@functools.partial(jax.jit, static_argnames=("n_steps", "h_max"))
def trace_final_alpha_diff(M, a, r_obs, alphas, thetas, theta_obs,
                           n_steps: int = 2048, h_max: float = 0.5):
    """Differentiable batched Kerr trace -> (final_alpha, status).

    Args mirror trace_rays_kerr_rk4 but every physics argument may be a
    traced jnp scalar (differentiable). alphas/thetas are (N,) screen
    viewing angles/azimuths. Returns (final_alpha (N,), status (N,))
    with status in {ESCAPED, CAPTURED, INVALID, RUNNING}; RUNNING means
    n_steps was too small for that lane. final_alpha is NaN for
    non-escaped lanes (same contract as the production tracers).
    """
    dtype = alphas.dtype
    M = jnp.asarray(M, dtype)
    a = jnp.asarray(a, dtype)
    r_obs = jnp.asarray(r_obs, dtype)
    theta_obs = jnp.asarray(theta_obs, dtype)
    metric = TracedKerr(M, a)

    r_capture = metric.capture_radius()
    r_escape = r_obs * 2.0

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    rhs = lambda y: metric.rhs5(y, p_t, p_phi)
    status0 = jnp.where(invalid0, INVALID, RUNNING).astype(jnp.int32)

    h_base = jnp.asarray(h_max, dtype)

    def step(carry, _):
        y, status = carry
        running = status == RUNNING

        # Near-horizon shrink (kerr_rk4.py semantics); h = 0 freezes
        # done lanes, so their y passes through the step unchanged and
        # the reverse pass sees an identity.
        r_curr = y[0]
        h = h_base
        h = jnp.where(r_curr < r_capture * 4.0, jnp.minimum(h, 0.25), h)
        h = jnp.where(r_curr < r_capture * 2.0, jnp.minimum(h, 0.10), h)
        h = jnp.where(r_curr < r_capture * 1.2, jnp.minimum(h, 0.05), h)
        h = jnp.where(running, h, 0.0)

        y_next = _rk4_step(rhs, y, h)
        ok = _all_finite(y_next) & (y_next[0] > 0.0)
        # Sanitize before anything downstream touches it: frozen/failed
        # lanes must not route NaN into the lerp (reverse-mode safety).
        y_next = _select(ok, y_next, y)

        adv = running & ok
        r_prev, r_next = y[0], y_next[0]
        cap = adv & (r_prev > r_capture) & (r_next <= r_capture)
        esc = adv & (r_prev < r_escape) & (r_next >= r_escape) & ~cap

        denom = r_next - r_prev
        safe_den = jnp.where(denom == 0.0, 1.0, denom)
        target = jnp.where(cap, r_capture, r_escape)
        frac = jnp.where(
            (denom == 0.0) | ~(cap | esc), 1.0,
            jnp.clip((target - r_prev) / safe_den, 0.0, 1.0))
        y_evt = _lerp(y, y_next, frac)
        y_out = _select(adv, _select(cap | esc, y_evt, y_next), y)

        status_out = jnp.where(
            running & ~ok, INVALID,
            jnp.where(cap, CAPTURED,
                      jnp.where(esc, ESCAPED, status))).astype(jnp.int32)
        return (y_out, status_out), None

    (y_f, status_f), _ = jax.lax.scan(step, (y0, status0), None,
                                      length=n_steps)

    captured = status_f == CAPTURED
    ext_status, final_alpha, _n_half = metric.extract_angle(
        y_f, p_t, p_phi, captured)
    escaped = (status_f == ESCAPED) & (ext_status == 1)
    nan = jnp.asarray(jnp.nan, dtype)
    final_alpha = jnp.where(escaped, final_alpha, nan)
    # Degenerate extraction on an escaped lane (ext_status == 0) maps
    # to INVALID, matching the production tracers' contract
    # (ops/kerr_trace.py finalize_angles) — otherwise a lane would
    # report ESCAPED with final_alpha = NaN and poison fit residuals
    # that mask on status == ESCAPED.
    status_out = jnp.where(
        escaped, ESCAPED,
        jnp.where((status_f == ESCAPED) & (ext_status == 0), INVALID,
                  status_f)).astype(jnp.int32)
    return final_alpha, status_out


def _params_vector(params, defaults, dtype):
    """(values in FITTABLE order, free-name list) from a params dict."""
    free = [k for k in FITTABLE if k in params]
    vec = jnp.asarray([float(params[k]) for k in free], dtype)
    fixed = {k: jnp.asarray(float(v), dtype) for k, v in defaults.items()
             if k not in free}
    return vec, free, fixed


def fit_scene_params(observed_alpha, alphas, thetas, init_params,
                     fixed_params, *, n_steps: int = 2048,
                     h_max: float = 0.5, iters: int = 20,
                     tol: float = 1e-14):
    """Recover scene parameters from an observed deflection field.

    Levenberg-Marquardt over the masked final-alpha residual vector:
    the Jacobian comes from forward-mode autodiff through the scan
    tracer (P <= 4 parameters -> P cheap forward passes), and the
    damped normal-equations solve converges quadratically on the
    smooth weak-deflection landscape. (Near-critical rays make the
    landscape oscillatory in the parameters — the e^(pi w) sensitivity
    of photon-ring grazers — so fits should be fed rays safely outside
    the critical curve; tests/test_diff.py probes both regimes.) The
    damping adapts classically: accepted steps divide lambda by 3,
    rejected steps multiply it by 10 and retry.

    Args:
      observed_alpha: (N,) observed final viewing angles (NaN = ray the
        observation lost; masked out).
      alphas, thetas: (N,) the screen coordinates those rays were shot
        at (the "instrument" — known).
      init_params: dict of starting guesses for the parameters to FIT,
        keys from FITTABLE (e.g. {"a": 0.3}).
      fixed_params: dict with the non-fitted physics, must supply
        whichever of M/a/r_obs/theta_obs are not being fit.
      n_steps/h_max: tracer resolution (match data generation).
      iters: max LM iterations; tol: stop once loss falls below it.

    Returns (fitted dict, loss history list). Loss = masked MSE of the
    final viewing angle in radians^2.
    """
    dtype = jnp.asarray(observed_alpha).dtype
    obs = jnp.asarray(observed_alpha, dtype)
    alphas = jnp.asarray(alphas, dtype)
    thetas = jnp.asarray(thetas, dtype)
    obs_ok = jnp.isfinite(obs)
    obs_filled = jnp.where(obs_ok, obs, 0.0)

    vec0, free, fixed = _params_vector(init_params, fixed_params, dtype)

    def unpack(vec):
        p = dict(fixed)
        for i, k in enumerate(free):
            p[k] = vec[i]
        return p

    def residual(vec):
        p = unpack(vec)
        pred, status = trace_final_alpha_diff(
            p["M"], p["a"], p["r_obs"], alphas, thetas, p["theta_obs"],
            n_steps=n_steps, h_max=h_max)
        ok = obs_ok & (status == ESCAPED)
        n = jnp.maximum(jnp.sum(ok), 1)
        return jnp.where(ok, pred - obs_filled, 0.0) / jnp.sqrt(n)

    res_and_jac = jax.jit(lambda v: (residual(v), jax.jacfwd(residual)(v)))
    loss_of = jax.jit(lambda v: jnp.sum(residual(v) ** 2))

    def clip_physical(vec):
        # |a| < M keeps the horizon real.
        if "a" in free:
            i = free.index("a")
            m_now = (vec[free.index("M")] if "M" in free else fixed["M"])
            vec = vec.at[i].set(jnp.clip(vec[i], -0.998 * m_now,
                                         0.998 * m_now))
        return vec

    vec = vec0
    lam = 1e-3
    history = [float(loss_of(vec))]
    for _ in range(iters):
        r, J = res_and_jac(vec)
        # Explicit full precision: the normal equations are precision-
        # sensitive, and a float32 product may otherwise run in TF32.
        g = jnp.matmul(J.T, r, precision=jax.lax.Precision.HIGHEST)
        H = jnp.matmul(J.T, J, precision=jax.lax.Precision.HIGHEST)
        accepted = False
        for _retry in range(8):
            delta = jnp.linalg.solve(
                H + lam * jnp.eye(len(vec), dtype=dtype), g)
            cand = clip_physical(vec - delta)
            cand_loss = float(loss_of(cand))
            if np.isfinite(cand_loss) and cand_loss < history[-1]:
                vec, lam, accepted = cand, max(lam / 3.0, 1e-12), True
                history.append(cand_loss)
                break
            lam *= 10.0
        if not accepted or history[-1] < tol:
            break
    return {k: float(vec[i]) for i, k in enumerate(free)}, history
