"""Batched adaptive Dormand-Prince 4(5) Kerr tracer.

Batched replacement for the reference's per-ray adaptive hot loop
(/root/reference/metrics.py:419-567): a single `lax.while_loop` advances the
entire ray batch in lock-step. Each iteration performs one DP45 *attempt*
per lane — six RHS evaluations plus the FSAL stage — then a per-lane masked
accept/reject:

  * error norm: mixed abs/rel over all 5 state components
    (metrics.py:506-514), with per-lane tolerances (axis-refine band,
    metrics.py:431-432).
  * reject: h *= max(0.2, 0.9 * err^-0.2) (metrics.py:516-522);
    non-finite proposal: h *= 0.25 (metrics.py:500-504);
    h underflow -> invalid.
  * accept: capture (r <= 1.01 r_+) / escape (r >= 2 r_obs) crossings are
    linearly interpolated onto the boundary (metrics.py:528-548); FSAL
    reuses stage 7 as the next step's stage 1 (metrics.py:551-554);
    growth h *= 5 (tiny error) or min(5, 0.9 * err^-0.2)
    (metrics.py:560-564).

Divergent ray lifetimes are the structural hard part (3 steps vs 200k):
lanes that finish are frozen by masking, and the loop exits as soon as
*all* lanes in the batch are done — callers bound straggler blast radius by
chunking + difficulty-sorting the batch (ops/batch.py), a whole-batch form
of active-ray compaction. On the GPU the fused Pallas kernel
(ops/pallas/kerr_trace_kernel.py) runs this same loop per block of rays,
so each block exits on its own.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu.ops import tableau as tb
from light_path_tracer_tpu.ops.types import TraceResult

# np.int32 (a STRONG type in JAX promotion), not Python int: under
# jax_enable_x64 a weak-int literal inside jnp.where promotes the
# status lattice to int64, which the same code traced inside the Pallas
# kernel would then carry as 64-bit integers.
RUNNING = np.int32(2)
ESCAPED = np.int32(1)
CAPTURED = np.int32(-1)
INVALID = np.int32(0)

# Tolerance presets: (atol, rtol) normal / axis-refined. float64 matches
# the reference (metrics.py:431-432). Three float32 tiers, calibrated by
# a tolerance sweep on the 1024^2 Kerr a=0.9 workload: final-alpha RMSE
# vs the f64 oracle falls from 2.6e-4 to 3.0e-5 rad as atol=rtol goes
# from 3e-5 to 1e-6 — no f32 roundoff floor anywhere in this range.
#   * "fast" (3e-5): the throughput tier; clears the 1e-3-rad angle gate
#     with 4x margin.
#   * "precise" (3e-6): the middle tier.
#   * "gate" (f32: 1e-6, f64: 1e-7): the acceptance-gate accuracy tier.
#     float32 at atol 1e-6 is the knee of the f32 sweep, and it passes
#     the image gate under bilinear sampling on non-chaotic pixels
#     (chip_smoke.py's lens phase). Under the reference's nearest-texel
#     sampling ANY two tolerance-distinct runs plateau at a texel-flip
#     noise floor (a rint flip is an O(texel-contrast) jump with
#     probability ~ angle_err x focal), so the as-written nearest-
#     sampling gate passes only on the f64 path at reference
#     tolerances.
TOLS = {
    jnp.dtype(jnp.float64): dict(atol=1e-8, rtol=1e-6,
                                 atol_ref=1e-10, rtol_ref=1e-8,
                                 h_min=1e-12, tiny_err=1e-10),
    jnp.dtype(jnp.float32): dict(atol=3e-5, rtol=3e-5,
                                 atol_ref=1e-5, rtol_ref=1e-5,
                                 h_min=1e-7, tiny_err=1e-8),
}

TOLS_PRECISE = {
    jnp.dtype(jnp.float64): TOLS[jnp.dtype(jnp.float64)],
    jnp.dtype(jnp.float32): dict(atol=3e-6, rtol=3e-6,
                                 atol_ref=1e-6, rtol_ref=1e-6,
                                 h_min=1e-7, tiny_err=1e-9),
}

TOLS_GATE = {
    jnp.dtype(jnp.float64): dict(atol=1e-7, rtol=1e-7,
                                 atol_ref=3e-8, rtol_ref=3e-8,
                                 h_min=1e-12, tiny_err=1e-10),
    jnp.dtype(jnp.float32): dict(atol=1e-6, rtol=1e-6,
                                 atol_ref=3e-7, rtol_ref=3e-7,
                                 h_min=1e-7, tiny_err=1e-9),
}


def get_tols(dtype, precision: str = "fast"):
    """Tolerance preset for a compute dtype.

    precision: "fast" | "precise" | "gate" | "tol:<x>" — the last sets
    atol = rtol = x (axis-refine tier x/3, mirroring fast's 3e-5 -> 1e-5
    ratio), for tolerance sweeps and per-integrator calibration; it stays
    a plain string so it remains a hashable static jit argument.
    """
    dt = jnp.dtype(dtype)
    if precision.startswith("tol:"):
        t = float(precision[4:])
        base = TOLS[dt]
        return dict(atol=t, rtol=t, atol_ref=t / 3.0, rtol_ref=t / 3.0,
                    h_min=base["h_min"], tiny_err=base["tiny_err"])
    tables = {"fast": TOLS, "precise": TOLS_PRECISE, "gate": TOLS_GATE}
    if precision not in tables:
        raise ValueError(f"precision must be 'fast', 'precise', 'gate' "
                         f"or 'tol:<x>', got {precision!r}")
    return tables[precision][dt]


def _wsum(h, ks, cs):
    """h * sum(c_i * k_i) for a list of 5-tuples ks with scalar weights."""
    acc = tuple(cs[0] * k for k in ks[0])
    for k5, c in zip(ks[1:], cs[1:]):
        acc = tuple(a + c * k for a, k in zip(acc, k5))
    return tuple(h * a for a in acc)


def _axpy(y, d):
    return tuple(yi + di for yi, di in zip(y, d))


def _all_finite(y):
    ok = jnp.isfinite(y[0])
    for yi in y[1:]:
        ok = ok & jnp.isfinite(yi)
    return ok


def _select(mask, a, b):
    return tuple(jnp.where(mask, ai, bi) for ai, bi in zip(a, b))


def _lerp(y, y_next, frac):
    return tuple(yi + frac * (ni - yi) for yi, ni in zip(y, y_next))


def _hermite_eval(y0, y1, f0, f1, h, s):
    """Cubic Hermite interpolant on the accepted step at fraction s.

    Uses the step's endpoint derivatives (k1 and the FSAL stage k7), which
    are already computed — so boundary-crossing interpolation is 3rd-order
    accurate instead of the reference's linear lerp (metrics.py:528-548),
    which loses ~1e-3 rad on the huge far-field steps the adaptive
    controller takes. Returns the interpolated state tuple.
    """
    s2 = s * s
    s3 = s2 * s
    h00 = 2.0 * s3 - 3.0 * s2 + 1.0
    h10 = s3 - 2.0 * s2 + s
    h01 = -2.0 * s3 + 3.0 * s2
    h11 = s3 - s2
    return tuple(h00 * a + h10 * h * fa + h01 * b + h11 * h * fb
                 for a, b, fa, fb in zip(y0, y1, f0, f1))


def _hermite_crossing_frac(r0, r1, fr0, fr1, h, target, frac_linear,
                           n_newton: int = 4):
    """Step fraction where the Hermite interpolant of r crosses `target`.

    Newton iterations on p_r(s) - target from the linear-lerp estimate;
    clamped to [0, 1] and guarded against flat derivatives (falls back to
    the linear estimate).
    """
    s = frac_linear
    for _ in range(n_newton):
        s2 = s * s
        p = ((2.0 * s2 * s - 3.0 * s2 + 1.0) * r0
             + (s2 * s - 2.0 * s2 + s) * h * fr0
             + (-2.0 * s2 * s + 3.0 * s2) * r1
             + (s2 * s - s2) * h * fr1)
        dp = ((6.0 * s2 - 6.0 * s) * r0
              + (3.0 * s2 - 4.0 * s + 1.0) * h * fr0
              + (-6.0 * s2 + 6.0 * s) * r1
              + (3.0 * s2 - 2.0 * s) * h * fr1)
        ok = jnp.abs(dp) > 1e-30
        step = jnp.where(ok, (p - target) / jnp.where(ok, dp, 1.0), 0.0)
        s = jnp.clip(s - step, 0.0, 1.0)
    # If Newton diverged (interpolant non-monotone), keep the linear frac.
    bad = ~jnp.isfinite(s)
    return jnp.where(bad, frac_linear, s)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "lambda_max",
                     "max_steps", "event_interp", "early_capture",
                     "formulation", "precision", "method"))
def trace_rays_kerr(metric, r_obs, alphas, thetas, theta_obs,
                    axis_refine, lambda_max: float, max_steps: int = 200000,
                    event_interp: str = "hermite",
                    early_capture: bool = True,
                    formulation: str = "theta",
                    force_invalid=None,
                    precision: str = "fast",
                    method: str = "dp45"):
    """Trace a batch of Kerr rays adaptively; returns TraceResult.

    alphas/thetas: (N,) screen viewing angle / azimuth; theta_obs scalar;
    axis_refine: (N,) bool tolerance-tightening mask.
    lambda_max default at call sites: max(5000, 6 r_obs) (metrics.py:1121).
    formulation: 'theta' (default — reference-parity polar coordinate)
    or 'mu' (transcendental-free rational RHS); same geodesics either
    way (tests/test_integrators.py cross-checks the two paths). NOTE:
    'mu' alone is ill-conditioned for rays passing near the polar axis
    (Kerr.pole_risk); mu users should go through trace_rays_kerr_hybrid,
    which re-traces those lanes in theta form. theta is the default.
    """
    return _trace_rays_kerr_impl(
        metric, r_obs, alphas, thetas, theta_obs, axis_refine,
        lambda_max, max_steps, event_interp, early_capture, formulation,
        force_invalid, precision, method)


def _h_init_for(r_obs, dtype):
    """Initial step size max(1, r_obs/100) — traced-safe: in flyby
    sequences (sequence.render_flyby) r_obs is a jnp scalar inside an
    enclosing jit, so the Python max()/float() of the static path would
    fail on the tracer."""
    if isinstance(r_obs, (int, float, np.floating, np.integer)):
        return max(1.0, 0.01 * float(r_obs))
    return jnp.maximum(jnp.asarray(1.0, dtype),
                       0.01 * jnp.asarray(r_obs, dtype))


def _trace_rays_kerr_impl(metric, r_obs, alphas, thetas, theta_obs,
                          axis_refine, lambda_max, max_steps,
                          event_interp, early_capture, formulation,
                          force_invalid, precision="fast",
                          method="dp45"):
    """Unjitted body of trace_rays_kerr. `metric` may be a TracedKerr
    with traced (M, a) when called from inside an enclosing jit (the
    recompilation-free parameter-sweep path, sequence.py)."""
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)
    atol = jnp.where(axis_refine, tols["atol_ref"], tols["atol"]).astype(dtype)
    rtol = jnp.where(axis_refine, tols["rtol_ref"], tols["rtol"]).astype(dtype)
    h_min = jnp.asarray(tols["h_min"], dtype)
    tiny_err = tols["tiny_err"]

    r_capture = jnp.asarray(metric.capture_radius(), dtype)
    r_escape = jnp.asarray(r_obs * 2.0, dtype)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    if formulation == "mu":
        y0 = metric.state_to_mu(y0)
    if force_invalid is not None:
        # Hybrid-tracer poisoning: lanes destined for the theta-form
        # retrace are frozen at step 0 so they cost no integration work.
        invalid0 = invalid0 | force_invalid
    status0 = jnp.where(invalid0, INVALID, RUNNING).astype(jnp.int32)
    r_plunge = (metric.plunge_radii(r_obs, alphas, thetas, theta_obs)
                if early_capture else None)

    y_f, status_f, _lam_f, step_f = dp45_integrate(
        metric, y0, p_t, p_phi, status0,
        atol=atol, rtol=rtol, h_min=h_min, tiny_err=tiny_err,
        r_capture=r_capture, r_escape=r_escape,
        lambda_max=lambda_max, h_init=_h_init_for(r_obs, dtype),
        max_steps=max_steps, event_interp=event_interp,
        r_plunge=r_plunge, formulation=formulation, method=method)
    if formulation == "mu":
        y_f = metric.state_from_mu(y_f)

    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f, p_t, p_phi, status_f)
    return TraceResult(final_alpha, n_half, status_out, step_f)


def finalize_angles(metric, y_f, p_t, p_phi, status_f):
    """Final 5-D state -> (final_alpha, n_half_orbits, status).

    The shared extraction epilogue (metrics.py:363-416 semantics): escape
    heading via the coordinate-velocity chain rule, NaN final_alpha for
    anything that did not escape, degenerate-state INVALID promotion.
    Used by the XLA batch tracer, the Pallas wrapper, and the disk-mode
    tracers (whose final state a composite render reuses for the lensed
    background behind/through the disk).
    """
    dtype = y_f[0].dtype
    captured = status_f == CAPTURED
    ext_status, final_alpha, n_half = metric.extract_angle(
        y_f, p_t, p_phi, captured)

    invalid_f = (status_f == INVALID) | (ext_status == 0)
    cap_f = ~invalid_f & (ext_status == -1)
    status_out = jnp.where(
        invalid_f, INVALID,
        jnp.where(cap_f, CAPTURED, ESCAPED)).astype(jnp.int32)
    nan = jnp.asarray(jnp.nan, dtype)
    final_alpha = jnp.where(status_out == ESCAPED, final_alpha, nan)
    n_half = jnp.where(invalid_f & (status_f == INVALID), 0, n_half)
    return final_alpha, n_half, status_out


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "emission_fn",
                     "lambda_max", "max_steps", "precision", "method",
                     "absorption_fn", "sat_window"))
def trace_rays_volumetric(metric, r_obs, alphas, thetas, theta_obs,
                          emission_fn, lambda_max: float,
                          max_steps: int = 200000,
                          precision: str = "fast",
                          method: str = "dp45",
                          absorption_fn=None,
                          sat_window: int = 0):
    """Trace rays accumulating a volumetric radiative-transfer integral.

    emission_fn(y5, p_t, p_phi) -> per-lane emissivity weight (e.g.
    g^p j_rest(r, theta); volumetric.make_emission_fn builds the RIAF
    forms) is integrated along each geodesic as an error-controlled 6th
    state component (dp45_integrate extra_rhs) — the radiative-transfer
    mode behind horizon-scale hot-flow images. No reference counterpart
    (the reference renders background lensing only). XLA path only;
    emission_fn/absorption_fn must be cached/stable function objects
    (they are jit static args — volumetric.make_transfer_fns lru_caches
    per (metric, config)).

    absorption_fn (optional) enables self-absorbed (optically thick)
    transfer: absorption_fn(y5, p_t, p_phi) -> the invariant opacity
    chi = nu_local * alpha_nu,rest (per unit affine length). The state
    then carries TWO extra components — the attenuated intensity I and
    the optical depth tau accumulated from the camera:

        d tau / d lambda = chi(y5)
        d I   / d lambda = exp(-tau) * emission(y5)

    which is exactly the formal solution of dI/ds = j - alpha I
    evaluated along the backward (camera -> source) trace: each
    emission element is attenuated by the matter between it and the
    camera. absorption_fn = None is the optically-thin limit (one
    extra component, chi = 0 identically, bitwise the original path).
    Both components ride the SAME embedded error estimator, so the
    controller resolves the photosphere (the tau ~ 1 transition) like
    any other dynamics.

    Certain-capture early exit is deliberately OFF: plunging photons
    collect emission all the way down to the capture surface, and the
    plunge shortcut would park them early and lose it.

    Returns VolumetricResult; the final-state angle fields mean a
    single trace serves both the emission layer and a lensed
    background composite (optical_depth then also screens the
    background: transmitted = exp(-tau) * background).
    """
    from light_path_tracer_tpu.ops.types import VolumetricResult
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    if absorption_fn is None:
        y0 = (*y0, jnp.zeros_like(y0[0]))
        extra = lambda y, pt, pp: (emission_fn(y[:5], pt, pp),)
    else:
        # y[5] = I (attenuated intensity), y[6] = tau (optical depth
        # from the camera). exp underflows to 0.0 past tau ~ 88 in f32
        # — benign: a fully opaque foreground transmits nothing. The
        # -30 floor bounds exp(+|tau|) on unphysical RK stage probes
        # (negative A coefficients x large h can drive the stage tau
        # negative; an overflowed stage derivative reject-cycles the
        # controller) — accepted states have tau >= 0 and never clip.
        y0 = (*y0, jnp.zeros_like(y0[0]), jnp.zeros_like(y0[0]))
        extra = lambda y, pt, pp: (
            jnp.exp(-jnp.maximum(y[6], -30.0))
            * emission_fn(y[:5], pt, pp),
            absorption_fn(y[:5], pt, pp))
    status0 = jnp.where(invalid0, INVALID, RUNNING).astype(jnp.int32)

    y_f, status_f, _lam, steps = dp45_integrate(
        metric, y0, p_t, p_phi, status0,
        atol=jnp.full_like(alphas, tols["atol"]),
        rtol=jnp.full_like(alphas, tols["rtol"]),
        h_min=jnp.asarray(tols["h_min"], dtype),
        tiny_err=tols["tiny_err"],
        r_capture=jnp.asarray(metric.capture_radius(), dtype),
        r_escape=jnp.asarray(r_obs * 2.0, dtype),
        lambda_max=lambda_max, h_init=_h_init_for(r_obs, dtype),
        max_steps=max_steps, method=method, extra_rhs=extra,
        sat_window=sat_window, sat_monitor=(0,),
        sat_r_max=saturation_r_max(metric) if sat_window else None)

    zero = jnp.asarray(0.0, dtype)
    em = jnp.where(status_f == INVALID, zero, y_f[5])
    tau = (jnp.zeros_like(em) if absorption_fn is None
           else jnp.where(status_f == INVALID, zero, y_f[6]))
    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f[:5], p_t, p_phi, status_f)
    # finalize_angles promotes degenerate extractions to INVALID; the
    # accumulated emission of such a lane is still physical, so em keys
    # off the INTEGRATION status above, not status_out.
    return VolumetricResult(em, final_alpha, n_half, status_out, steps,
                            tau)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "transfer_fn",
                     "n_bands", "lambda_max", "max_steps", "precision",
                     "method", "sat_window", "sat_monitor"))
def trace_rays_spectral(metric, r_obs, alphas, thetas, theta_obs,
                        transfer_fn, n_bands: int, lambda_max: float,
                        max_steps: int = 200000,
                        precision: str = "fast",
                        method: str = "dp45",
                        sat_window: int = 0,
                        sat_monitor: tuple = None):
    """Multi-frequency radiative-transfer trace: ONE geodesic
    integration carrying 1 + n_bands coupled extra state components.

    transfer_fn(y, p_t, p_phi) -> (d tau_hat, d I_1, ..., d I_n)
    receives the FULL state tuple (r, theta, phi, p_r, p_theta,
    tau_hat, I_1..I_n) so each band's emission term can read the
    running reduced optical depth (volumetric.make_spectral_transfer
    builds the synchrotron-like frequency scalings: all bands share
    tau_hat because a power-law opacity separates as
    tau_i = f_i^(1-q) tau_hat). All components ride the embedded
    error estimator. XLA path only; transfer_fn must be a
    cached/stable function object (jit static arg).

    sat_window > 0 enables the emission-saturation early exit
    (dp45_integrate docstring); sat_monitor lists the INTENSITY extras
    indices (default: the n_bands band integrals — callers reusing this
    state layout for movies/order buckets pass their own frame/bucket
    indices, skipping bookkeeping components like t or the winding m).
    """
    from light_path_tracer_tpu.ops.types import SpectralResult
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)
    if sat_monitor is None:
        sat_monitor = tuple(range(1, 1 + n_bands))

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    zeros = jnp.zeros_like(y0[0])
    y0 = (*y0, *([zeros] * (1 + n_bands)))
    status0 = jnp.where(invalid0, INVALID, RUNNING).astype(jnp.int32)

    y_f, status_f, _lam, steps = dp45_integrate(
        metric, y0, p_t, p_phi, status0,
        atol=jnp.full_like(alphas, tols["atol"]),
        rtol=jnp.full_like(alphas, tols["rtol"]),
        h_min=jnp.asarray(tols["h_min"], dtype),
        tiny_err=tols["tiny_err"],
        r_capture=jnp.asarray(metric.capture_radius(), dtype),
        r_escape=jnp.asarray(r_obs * 2.0, dtype),
        lambda_max=lambda_max, h_init=_h_init_for(r_obs, dtype),
        max_steps=max_steps, method=method, extra_rhs=transfer_fn,
        sat_window=sat_window, sat_monitor=sat_monitor,
        sat_r_max=saturation_r_max(metric) if sat_window else None)

    zero = jnp.asarray(0.0, dtype)
    ok = status_f != INVALID
    tau = jnp.where(ok, y_f[5], zero)
    em = tuple(jnp.where(ok, y_f[6 + i], zero) for i in range(n_bands))
    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f[:5], p_t, p_phi, status_f)
    return SpectralResult(em, tau, final_alpha, n_half, status_out,
                          steps)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "transfer_fn",
                     "n_extras", "lambda_max", "max_steps",
                     "precision", "method", "sat_window",
                     "sat_monitor"))
def trace_rays_aux(metric, r_obs, alphas, thetas, theta_obs,
                   transfer_fn, n_extras: int, aux,
                   lambda_max: float, max_steps: int = 200000,
                   precision: str = "fast", method: str = "dp45",
                   sat_window: int = 0, sat_monitor: tuple = ()):
    """Generic coupled-extras trace with per-ray auxiliary constants.

    transfer_fn(y, p_t, p_phi, aux) -> tuple of n_extras derivatives;
    y is the full state (r, theta, phi, p_r, p_theta, *extras) and aux
    an arbitrary pytree of per-ray traced arrays captured by the
    integrand like p_t/p_phi are (e.g. the camera-side Walker-Penrose
    basis constants of polarized volumetric transfer — quantities that
    depend on each ray's INITIAL state, which the loop state no longer
    carries). transfer_fn must be a cached/stable function object (jit
    static arg); aux is traced, so varying it does NOT recompile.
    """
    from light_path_tracer_tpu.ops.types import ExtrasResult
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    zeros = jnp.zeros_like(y0[0])
    y0 = (*y0, *([zeros] * n_extras))
    status0 = jnp.where(invalid0, INVALID, RUNNING).astype(jnp.int32)
    extra = lambda y, pt, pp: transfer_fn(y, pt, pp, aux)

    y_f, status_f, _lam, steps = dp45_integrate(
        metric, y0, p_t, p_phi, status0,
        atol=jnp.full_like(alphas, tols["atol"]),
        rtol=jnp.full_like(alphas, tols["rtol"]),
        h_min=jnp.asarray(tols["h_min"], dtype),
        tiny_err=tols["tiny_err"],
        r_capture=jnp.asarray(metric.capture_radius(), dtype),
        r_escape=jnp.asarray(r_obs * 2.0, dtype),
        lambda_max=lambda_max, h_init=_h_init_for(r_obs, dtype),
        max_steps=max_steps, method=method, extra_rhs=extra,
        sat_window=sat_window, sat_monitor=sat_monitor,
        sat_r_max=saturation_r_max(metric) if sat_window else None)

    zero = jnp.asarray(0.0, dtype)
    ok = status_f != INVALID
    extras = tuple(jnp.where(ok, y_f[5 + i], zero)
                   for i in range(n_extras))
    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f[:5], p_t, p_phi, status_f)
    return ExtrasResult(extras, final_alpha, n_half, status_out, steps)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "r_surface",
                     "lambda_max", "max_steps", "precision", "method",
                     "record_time"))
def trace_rays_surface(metric, r_obs, alphas, thetas, theta_obs,
                       r_surface: float, lambda_max: float,
                       max_steps: int = 200000,
                       precision: str = "fast",
                       method: str = "dp45",
                       record_time: bool = False):
    """Trace rays onto an opaque spherical surface at r = r_surface.

    The stellar-surface imaging primitive (star.py: neutron-star hot
    spots, pulse profiles — no reference counterpart): the surface is
    simply the capture event at r_capture = r_surface, so the shared
    adaptive loop Hermite-localizes the full state onto the sphere and
    CAPTURED rays carry their surface intersection (theta, phi) and
    momentum (p_r, p_theta) — everything a surface emission model
    needs (redshift via the conserved xi = L/E, emission angle via the
    localized p_r). ESCAPED rays missed the star and keep their lensed
    escape heading for background compositing.

    record_time=True additionally integrates coordinate time as an
    error-controlled extra state component (dt/dlambda = metric.tdot),
    event-shortened to the hit point — the light-travel delay from the
    camera for retarded-phase pulse profiles. (The disk paths' side
    trapezoid needs a disk_plane; here t rides extra_rhs instead.)

    XLA path only. r_surface must exceed the metric's capture radius.
    """
    from light_path_tracer_tpu.ops.types import SurfaceResult
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    extra = None
    if record_time:
        y0 = (*y0, jnp.zeros_like(y0[0]))
        extra = lambda y, pt, pp: (metric.tdot(y[:5], pt, pp),)
    status0 = jnp.where(invalid0, INVALID, RUNNING).astype(jnp.int32)

    y_f, status_f, _lam, steps = dp45_integrate(
        metric, y0, p_t, p_phi, status0,
        atol=jnp.full_like(alphas, tols["atol"]),
        rtol=jnp.full_like(alphas, tols["rtol"]),
        h_min=jnp.asarray(tols["h_min"], dtype),
        tiny_err=tols["tiny_err"],
        r_capture=jnp.asarray(r_surface, dtype),
        r_escape=jnp.asarray(r_obs * 2.0, dtype),
        lambda_max=lambda_max, h_init=_h_init_for(r_obs, dtype),
        max_steps=max_steps, method=method, extra_rhs=extra)

    t_hit = (y_f[5] if record_time else jnp.zeros_like(y_f[0]))
    xi = p_phi / jnp.maximum(-p_t, jnp.asarray(1e-30, dtype))
    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f[:5], p_t, p_phi, status_f)
    return SurfaceResult(y_f[1], y_f[2], y_f[3], y_f[4], xi, t_hit,
                         final_alpha, n_half, status_out, steps)


def saturation_r_max(metric):
    """Radial band bound for the emission-saturation early exit.

    Only lanes currently whirling inside/near the spherical-photon-orbit
    shell are allowed to exit on saturation: a lane OUTSIDE this band
    showing no emission change is merely transiting empty space (it may
    yet reach the emitting region), while a lane that has spent a full
    saturation window inside the band without any monitored change is a
    trapped near-critical orbiter whose remaining budget provably adds
    nothing (a 2048-step cap on the grinding pointing reproduced the
    200k-step run bitwise). 1.2x the outermost
    unstable photon orbit bounds every spherical photon orbit with
    margin; metrics without the closed form fall back to the photon
    sphere / twice the capture surface (purely conservative — a smaller
    band only disables the optimization).
    """
    upr = getattr(metric, "unstable_photon_radii", None)
    if upr is not None:
        r_band = max(float(r) for r in upr())
    elif getattr(metric, "R_PHOTON", None) is not None:
        r_band = float(metric.R_PHOTON)
    else:
        r_band = 2.0 * float(metric.capture_radius())
    return 1.2 * r_band


def dp45_integrate(metric, y0, p_t, p_phi, status0, *, atol, rtol, h_min,
                   tiny_err, r_capture, r_escape, lambda_max, h_init,
                   max_steps, event_interp="hermite", disk_plane=None,
                   max_disk_hits=2, r_plunge=None, formulation="theta",
                   method="dp45", disk_normal=None, extra_disks=None,
                   record_momentum=False, record_time=False,
                   extra_rhs=None, sat_window=0, sat_monitor=(),
                   sat_r_max=None):
    """The shared lock-step adaptive integration loop (DP45 or DOP853).

    method selects the embedded Runge-Kutta pair:
      * "dp45" — Dormand-Prince 4(5) + FSAL, the reference-parity
        integrator (metrics.py:419-567): 6 RHS evaluations per attempt.
      * "dop853" — Hairer's 8th-order DOP853 (12 RHS evaluations per
        attempt + the FSAL end stage, combined 5th/3rd-order error
        estimator): ~an order more accurate per step, so far fewer
        steps at equal tolerance — the step-count lever once the
        per-step cost is at its roofline.
    Both share the identical accept/reject masking, event interpolation,
    disk recording, and step control below.

    Shape-polymorphic over the ray axis/axes: the XLA path calls it on
    (N,) arrays; the fused Pallas kernel calls it on (block,) ray blocks
    held in registers.
    Returns (y_final, status, lambda, steps_executed) — plus, when
    `disk_plane=(r_in, r_out, theta_plane, opaque)` is given, a
    `disk_hits` dict with the first `max_disk_hits` equatorial-plane
    crossing radii per ray (the accretion-disk extension: BASELINE.json
    config 4 — the reference has no disk). With opaque=True the ray
    terminates at its first in-disk crossing (status stays as-is; the
    hit record marks the pixel). `extra_disks` appends further
    independent planes — a sequence of ((r_in, r_out, theta_plane,
    opaque), normal_or_None) — each recorded on its own sign track
    under hits["extra"] (multi-plane disks: several disks in ONE
    trace); a ray terminates at its first in-disk crossing of any
    OPAQUE plane.

    formulation: 'theta' integrates the reference-parity state
    [r, theta, phi, p_r, p_theta] via metric.rhs5; 'mu' integrates
    [r, mu=cos(theta), phi, p_r, p_mu] via the transcendental-free
    metric.rhs5_mu (caller converts y0 with metric.state_to_mu and the
    result back with metric.state_from_mu). disk_plane's theta_plane is
    always given in theta; it is converted here for 'mu'.

    Emission-saturation early exit (sat_window > 0; extras traces only):
    a near-critical photon-ring lane neither captures nor escapes — it
    can grind the full step budget (seen: 204,819 steps on the
    volumetric-decomposition pointing under the previous accelerator's
    arithmetic, a REJECT LIMIT CYCLE whose entire state froze bitwise
    from ~step 500 while the same ray ends in 175 steps on the CPU;
    whether it occurs on the GPU is open, ROADMAP D3). Once a
    lane's monitored path integrals stop changing AT ALL, the remaining
    budget provably contributes nothing. A lane exits when, for
    `sat_window` CONSECUTIVE attempts (accepted or rejected — a
    rejected attempt cannot change the extras by construction, and the
    limit-cycled grinder never accepts again), no component of
    y[5 + i] for i in `sat_monitor` changed bitwise, AND its r lies
    inside the trapped-orbit band r <= sat_r_max
    (saturation_r_max(metric) — the band guard keeps a not-yet-emitting
    lane still transiting toward the source from exiting early; outside
    the band a lane cannot be trapped, so its no-change streak is
    transit, not saturation). Exit sets lam = lambda_max: the lane
    reads as budget-complete (status RUNNING, like genuine lambda
    exhaustion). Monitor
    only intensity-like extras — bookkeeping coordinates (winding m,
    coordinate time t, optical depth tau) keep changing on a genuinely
    whirling orbiter forever, and growing tau/m only decreases/
    re-buckets FUTURE emission, which the criterion already requires to
    be zero.
    """
    dtype = y0[0].dtype
    lam_max = jnp.asarray(lambda_max, dtype)
    if formulation == "mu":
        rhs = lambda y: metric.rhs5_mu(y, p_t, p_phi)
    else:
        rhs = lambda y: metric.rhs5(y, p_t, p_phi)
    if extra_rhs is not None:
        # Path-integral accumulator (volumetric emission, volumetric.py):
        # the state gains extra components with d(extras)/dlambda =
        # extra_rhs(y, p_t, p_phi) — y is the FULL state tuple
        # (r, theta, phi, p_r, p_theta, *extras) and the return is a
        # tuple of one derivative per extra component, so coupled
        # transfer terms (e.g. intensity attenuated by the accumulated
        # optical depth, trace_rays_volumetric absorption mode) see the
        # current extras at every RK stage. The extras are integrated
        # by the SAME embedded pair under the SAME error control as the
        # dynamics — so the controller adapts steps to resolve the
        # emissivity profile even where the geodesic alone is smooth
        # (in the near-flat far field steps otherwise grow ~5x per
        # accept and would straddle the entire emitting volume; a side
        # trapezoid like record_time's would silently under-sample
        # there). The caller appends the matching zeros to y0; every
        # tuple helper (_axpy/_wsum/Hermite/scales) is
        # component-generic, so events shorten the integral to the
        # event point exactly like the coordinates.
        if formulation == "mu":
            raise ValueError("extra_rhs requires formulation='theta' "
                             "(the emissivity evaluates the theta "
                             "chart)")
        base_rhs = rhs
        rhs = lambda y: (*base_rhs(y[:5]), *extra_rhs(y, p_t, p_phi))
    if record_time:
        # Coordinate-time recorder (opt-in: two extra tdot evaluations
        # per lock-step iteration — light curves only, imaging paths
        # leave it off). t never feeds back into the dynamics, so it is
        # accumulated by trapezoid over each ACCEPTED (possibly
        # event-shortened) segment — O(h^3) local error, far below the
        # delay resolution light curves need — instead of widening the
        # error-controlled state.
        if formulation == "mu":
            raise ValueError("record_time requires formulation='theta' "
                             "(tdot evaluates the theta chart)")
        if disk_plane is None:
            raise ValueError("record_time needs a disk_plane (it exists "
                             "to time crossings)")
        rhs_t = lambda y: metric.tdot(y, p_t, p_phi)

    k1_0 = rhs(y0)
    h0 = jnp.full_like(y0[0], h_init)
    lam0 = jnp.zeros_like(y0[0])

    def _as_basis_fn(nrm):
        """Tilted-disk surface normal: a static ((n), (e1), (e2)) tuple
        (flat tilted plane) or a callable r -> ((n), (e1), (e2))
        (warped disk: radius-dependent tilt, e.g. Bardeen-Petterson).
        The detector runs on the scale-free s = n(r) . xhat(theta, phi)
        and the recorded azimuth is the in-plane atan2(xhat.e2,
        xhat.e1) — both already physical on the double-cover chart
        (xhat carries sin(theta)'s sign). theta-form only (the mu chart
        folds the branch), and XLA-path only (the fused kernel records
        equatorial crossings only). None = equatorial plane (cos-theta
        detector)."""
        if nrm is None:
            return None
        if callable(nrm):
            return nrm
        return lambda r, _c=nrm: _c

    if disk_plane is not None:
        # One or more independent disk planes in ONE trace: plane 0 is
        # (disk_plane, disk_normal); extra_disks appends further
        # ((r_in, r_out, theta_plane, opaque), normal) tracks, each with
        # its own max_disk_hits crossing slots (multi-plane disks — no
        # reference counterpart).
        _planes = [(disk_plane, disk_normal)] + [
            (pl, nrm) for pl, nrm in (extra_disks or ())]
        if (formulation == "mu"
                and any(nrm is not None for _pl, nrm in _planes)):
            raise ValueError("tilted disk requires formulation='theta'")
        _basis_fns = [_as_basis_fn(nrm) for _pl, nrm in _planes]
        # Crossing detection runs on cos(theta) in BOTH formulations
        # (for "mu" the state coordinate IS cos(theta)): a sign change
        # of cos(theta) - cos(theta_plane) catches the equatorial plane
        # on every branch of the double-cover chart (theta = +-pi/2,
        # 3pi/2, ...). The L = 0 center-column rays pass OVER the pole
        # (theta runs negative) and hit the plane at theta = -pi/2 —
        # a theta - pi/2 detector misses those crossings entirely
        # (seen as a dark one-pixel seam down disk renders).
        _plane_cs = [float(np.cos(pl[2])) for pl, _nrm in _planes]

        # "down" flags are carried as 0.0/1.0 in the compute dtype, not
        # as bool vectors in the while_loop carry.
        def _track0(has_xi):
            return {
                "n": jnp.zeros(y0[0].shape, jnp.int32),
                "r": tuple(jnp.zeros_like(y0[0])
                           for _ in range(max_disk_hits)),
                "phi": tuple(jnp.zeros_like(y0[0])
                             for _ in range(max_disk_hits)),
                # Crossing momentum (p_r, p_theta of the Hermite-
                # localized crossing state): polarization transport
                # (polarization.py) rebuilds the full photon wave
                # vector at the emission point from these + the
                # conserved (E, L). Opt-in: the extra carry costs the
                # disk hot loop ~20% (bench config 4), so imaging
                # paths leave it off.
                "pr": tuple(jnp.zeros_like(y0[0])
                            for _ in range(max_disk_hits
                                           if record_momentum else 0)),
                "pth": tuple(jnp.zeros_like(y0[0])
                             for _ in range(max_disk_hits
                                            if record_momentum else 0)),
                "down": tuple(jnp.zeros_like(y0[0])
                              for _ in range(max_disk_hits)),
                # Coordinate time of the localized crossing (opt-in,
                # record_time): the light-travel delay from the camera
                # to the emission point, exact under frame dragging
                # (flipping the photon momentum AND the integration
                # direction leaves the elapsed t invariant).
                "t": tuple(jnp.zeros_like(y0[0])
                           for _ in range(max_disk_hits
                                          if record_time else 0)),
                # Tilted mode records the ray's angular momentum about
                # the disk normal at each crossing (the emitter Doppler
                # needs xi_n = n.L/E, not the conserved L_z).
                "xi": (tuple(jnp.zeros_like(y0[0])
                             for _ in range(max_disk_hits))
                       if has_xi else ()),
            }

        hits0 = _track0(_basis_fns[0] is not None)
        if len(_planes) > 1:
            hits0["extra"] = tuple(
                _track0(b is not None) for b in _basis_fns[1:])
        if record_time:
            # Running coordinate time of each lane's CURRENT state
            # (t = 0 at the camera); at termination this is the time at
            # capture/escape, returned as hits["t_now"].
            hits0["t_now"] = jnp.zeros_like(y0[0])
    else:
        hits0 = {"n": jnp.zeros((), jnp.int32), "r": (), "phi": (),
                 "pr": (), "pth": (), "down": (), "xi": (), "t": ()}

    if sat_window and not sat_monitor:
        raise ValueError("sat_window > 0 needs a non-empty sat_monitor "
                         "(with nothing monitored every in-band lane "
                         "would 'saturate')")
    # Dummy 0-d counters keep the carry structure uniform when off.
    sat_cnt0 = (jnp.zeros(y0[0].shape, jnp.int32) if sat_window
                else jnp.zeros((), jnp.int32))
    frz_cnt0 = (jnp.zeros(y0[0].shape, jnp.int32) if sat_window
                else jnp.zeros((), jnp.int32))
    sat_r_band = (jnp.asarray(sat_r_max, dtype) if sat_window else None)

    def cond(carry):
        step, y, k1, h, lam, status, hits, _sat, _frz = carry
        running = (status == RUNNING) & (lam < lam_max)
        # A max over the block rather than jnp.any: the Pallas Triton
        # route has no lowering for reduce_or.
        return (step < max_steps) & (jnp.max(running.astype(jnp.int32)) > 0)

    def body(carry):
        step, y, k1, h, lam, status, hits, sat_cnt, frz_cnt = carry
        running = (status == RUNNING) & (lam < lam_max)
        h_eff = jnp.minimum(h, lam_max - lam)
        h_eff = jnp.maximum(h_eff, 0.0)

        # -- RK stages (k1 via FSAL) --
        if method == "dop853":
            ks = [k1]
            for row in tb.D853_A[1:]:
                incr = _wsum(h_eff, [ks[j] for j, _ in row],
                             [v for _, v in row])
                ks.append(rhs(_axpy(y, incr)))
            y5 = _axpy(y, _wsum(h_eff, [ks[j] for j, _ in tb.D853_B],
                                [v for _, v in tb.D853_B]))
            k7 = rhs(y5)          # FSAL end stage (stage 13)
            ks.append(k7)
        else:
            k2 = rhs(_axpy(y, _wsum(h_eff, [k1], [tb.A21])))
            k3 = rhs(_axpy(y, _wsum(h_eff, [k1, k2], [tb.A31, tb.A32])))
            k4 = rhs(_axpy(y, _wsum(h_eff, [k1, k2, k3],
                                    [tb.A41, tb.A42, tb.A43])))
            k5 = rhs(_axpy(y, _wsum(h_eff, [k1, k2, k3, k4],
                                    [tb.A51, tb.A52, tb.A53, tb.A54])))
            k6 = rhs(_axpy(y, _wsum(h_eff, [k1, k2, k3, k4, k5],
                                    [tb.A61, tb.A62, tb.A63, tb.A64,
                                     tb.A65])))
            y5 = _axpy(y, _wsum(h_eff, [k1, k3, k4, k5, k6],
                                [tb.B1, tb.B3, tb.B4, tb.B5, tb.B6]))
            k7 = rhs(y5)

        finite_ok = _all_finite(y5) & (y5[0] > 0.0)

        # -- per-component error scale (shared by both pairs) --
        scales = []
        for i, (yi, ni) in enumerate(zip(y, y5)):
            mag = jnp.maximum(jnp.abs(yi), jnp.abs(ni))
            if formulation == "mu" and i == 1:
                # mu = cos(theta) spans [-1, 1] while theta sits near
                # pi/2 on typical rays, so mu's relative term vanishes at
                # the equator and the controller would over-resolve the
                # polar coordinate ~(pi/2 rtol/atol)^(1/5)x vs the theta
                # form. Weight mu's error on the theta scale (valid:
                # |d mu| = sin(theta) |d theta| <= |d theta|; pole-bound
                # lanes are rerouted to theta form by the hybrid anyway).
                mag = jnp.maximum(mag, np.pi / 2)
            if dtype == jnp.float32:
                # Increment-aware scale (|y| + |h k|, the classic RK
                # scaling): in f32 the embedded estimator's own roundoff
                # is ~eps * h * max_j|k_j|; where the stage derivatives
                # are huge (the 1/sin^2-stiff polar-axis region:
                # |dphi| ~ 1e4) that roundoff exceeds atol + rtol|y| and
                # the controller rejects FOREVER — measured as rays
                # grinding the full 200k-step budget that a
                # same-tolerance f64 scalar run finishes in ~58 steps.
                # Both endpoint stages bound the spike (k1 before it,
                # k7 = FSAL end stage inside/after it); scaling by them
                # bounds the roundoff term at ~eps/rtol << 1.
                # f64 keeps the reference's exact |y|-only scale
                # (metrics.py:506-514) for bug-for-bug parity.
                if method == "dop853":
                    # DOP853's larger steps can hold the whole polar
                    # derivative spike strictly *inside* the step (and
                    # its A coefficients reach ~43, amplifying stage
                    # roundoff), so the endpoint stages alone do not
                    # bound the estimator roundoff — measured as f32
                    # lanes grinding the full step budget. Scale by the
                    # max over ALL stages instead.
                    kmag = jnp.abs(k1[i])
                    for kj in ks[1:]:
                        kmag = jnp.maximum(kmag, jnp.abs(kj[i]))
                else:
                    kmag = jnp.maximum(jnp.abs(k1[i]), jnp.abs(k7[i]))
                mag = mag + h_eff * kmag
            scales.append(atol + rtol * mag)

        # -- embedded error norm over the 5 components --
        if method == "dop853":
            # Hairer's combined 5th/3rd-order estimator (dop853.f):
            # err = |h| * |e5|^2 / sqrt(|e5|^2 + 0.01 |e3|^2), RMS-scaled.
            one = jnp.ones_like(h_eff)
            e5 = _wsum(one, [ks[j] for j, _ in tb.D853_E5],
                       [v for _, v in tb.D853_E5])
            e3 = _wsum(one, [ks[j] for j, _ in tb.D853_E3],
                       [v for _, v in tb.D853_E3])
            e5_sq = jnp.zeros_like(h_eff)
            e3_sq = jnp.zeros_like(h_eff)
            for ei5, ei3, sc in zip(e5, e3, scales):
                r5 = jnp.where(finite_ok, ei5 / sc, 0.0)
                r3 = jnp.where(finite_ok, ei3 / sc, 0.0)
                e5_sq = e5_sq + r5 * r5
                e3_sq = e3_sq + r3 * r3
            denom = e5_sq + 0.01 * e3_sq
            err_norm = (h_eff * e5_sq
                        / jnp.sqrt(jnp.maximum(float(len(y0)) * denom,
                                               1e-30)))
            # Stage derivatives can overflow to inf in f32 (the huge
            # A-coefficients probe far from y; near the sin^2 floor the
            # RHS overflows) while y5 itself stays finite; inf/inf above
            # is then NaN, which satisfies NEITHER accept nor reject and
            # freezes the lane at constant h forever (measured: full
            # 200k-step grinds on ordinary far-field rays). Non-finite
            # error means the attempt probed garbage: force a hard
            # reject (inf ** -0.125 = 0, so shrink bottoms at 0.2).
            err_norm = jnp.where(jnp.isfinite(err_norm), err_norm,
                                 jnp.asarray(jnp.inf, dtype))
        else:
            err = _wsum(h_eff, [k1, k3, k4, k5, k6, k7],
                        [tb.E1, tb.E3, tb.E4, tb.E5, tb.E6, tb.E7])
            err_sq = jnp.zeros_like(h_eff)
            for ei, sc in zip(err, scales):
                ratio = jnp.where(finite_ok, ei / sc, 0.0)
                err_sq = err_sq + ratio * ratio
            err_norm = jnp.sqrt(err_sq / float(len(y0)))

        accept = running & finite_ok & (err_norm <= 1.0)
        reject = running & finite_ok & (err_norm > 1.0)
        blowup = running & ~finite_ok

        # -- events on accepted lanes (capture has priority) --
        r_prev, r_next = y[0], y5[0]
        cap = accept & (r_prev > r_capture) & (r_next <= r_capture)
        if r_plunge is not None:
            # Certain-capture early exit: inbound crossing of the
            # innermost photon orbit (metric.plunge_radii) is a
            # guaranteed plunge; stop here instead of integrating the
            # shrinking steps down to the horizon.
            cap = cap | (accept & (r_next <= r_plunge)
                         & (r_next < r_prev))
        esc = accept & (r_prev < r_escape) & (r_next >= r_escape) & ~cap

        denom = r_next - r_prev
        safe_den = jnp.where(denom == 0.0, 1.0, denom)
        frac_cap = jnp.clip((r_capture - r_prev) / safe_den, 0.0, 1.0)
        frac_esc = jnp.clip((r_escape - r_prev) / safe_den, 0.0, 1.0)
        frac_lin = jnp.where(denom == 0.0, 1.0,
                             jnp.where(cap, frac_cap,
                                       jnp.where(esc, frac_esc, 1.0)))
        if event_interp == "hermite":
            target = jnp.where(cap, r_capture, r_escape)
            frac = jnp.where(
                cap | esc,
                _hermite_crossing_frac(r_prev, r_next, k1[0], k7[0],
                                       h_eff, target, frac_lin),
                frac_lin)
            y_event = _hermite_eval(y, y5, k1, k7, h_eff, frac)
        else:
            frac = frac_lin
            y_event = _lerp(y, y5, frac)
        y_acc = _select(cap | esc, y_event, y5)
        lam_acc = lam + frac * h_eff

        # -- step-size control (one pow serves both shrink and grow) --
        # Exponent = -1/(error-estimator order + 1): DP45 controls the
        # 4th-order error (metrics.py:516-522), DOP853 the 7th-order.
        exponent = -0.125 if method == "dop853" else -0.2
        factor = 0.9 * jnp.maximum(err_norm, 1e-30) ** exponent
        shrink = jnp.maximum(0.2, factor)
        grow = jnp.where(err_norm < tiny_err, 5.0,
                         jnp.minimum(5.0, factor))
        h_new = jnp.where(accept, h * grow,
                          jnp.where(reject, h * shrink,
                                    jnp.where(blowup, h * 0.25, h)))
        underflow = (reject | blowup) & (h_new < h_min)

        # -- state/status update (masked) --
        upd = accept
        y_out = _select(upd, y_acc, y)
        # FSAL: stage 7 seeds the next step's stage 1 on plain accepts.
        k1_out = _select(upd & ~(cap | esc), k7, k1)
        lam_out = jnp.where(upd, lam_acc, lam)

        corrupt = upd & ~_all_finite(y_acc)
        status_out = jnp.where(cap, CAPTURED,
                               jnp.where(esc, ESCAPED, status))
        status_out = jnp.where(underflow | corrupt, INVALID, status_out)
        status_out = status_out.astype(jnp.int32)

        sat_cnt_out = sat_cnt
        frz_cnt_out = frz_cnt
        if sat_window:
            # Emission-saturation exit (see docstring): count
            # consecutive ATTEMPTS — accepted or rejected — whose
            # monitored path integrals were bitwise no-ops; a full
            # window inside the trapped-orbit band ends the lane as
            # budget-complete (lam := lam_max). Counting attempts, not
            # accepted steps, is load-bearing: the grinder seen so far
            # (the decomposition mode's 204,819-step pointing) is a
            # REJECT LIMIT CYCLE — its whole state freezes bitwise and
            # it never accepts again, so an accepted-step counter would
            # never fire. A rejected
            # attempt cannot change the extras by construction, so it
            # legitimately extends the no-change streak.
            changed = jnp.zeros(upd.shape, bool)
            for i in sat_monitor:
                changed = changed | (y_out[5 + i] != y[5 + i])
            sat_cnt_out = jnp.where(
                running, jnp.where(changed, 0, sat_cnt + 1), sat_cnt)
            # Frozen-state exit, band-free: a lane whose ENTIRE state
            # is bitwise-unchanged for a full window cannot be making
            # legal progress anywhere — a monotone reject-shrink streak
            # underflows h_min (INVALID) within ~300 attempts, and any
            # accepted step moves the dynamics by >> 1 ulp unless h has
            # collapsed below ulp-effectiveness — so a 2048-attempt
            # freeze is a numerical limit cycle at ANY radius (512^2
            # grids produce them outside the photon-shell band too:
            # polar-plunge columns freeze at large r).
            changed_state = changed
            for k in range(len(y0)):
                changed_state = changed_state | (y_out[k] != y[k])
            frz_cnt_out = jnp.where(
                running, jnp.where(changed_state, 0, frz_cnt + 1),
                frz_cnt)
            saturated = (running & (status_out == RUNNING)
                         & (((sat_cnt_out >= sat_window)
                             & (y_out[0] <= sat_r_band))
                            | (frz_cnt_out >= sat_window)))
            lam_out = jnp.where(saturated, lam_max, lam_out)

        hits_out = hits
        if record_time:
            # Trapezoid over the accepted segment [y, y_acc] of length
            # frac * h_eff (event-shortened steps integrate only up to
            # the event, so t at capture/escape is the event time).
            td_prev = rhs_t(y)
            td_acc = rhs_t(y_acc)
            seg = frac * h_eff
            t_now = hits["t_now"]
            t_acc_val = t_now + 0.5 * seg * (td_prev + td_acc)
        if disk_plane is not None:
            # Per-plane crossing detection on the accepted step segment
            # (up to the event fraction), located with the same
            # interpolant used for events.
            def _record(track, plane, basis_fn, plane_c):
                """One plane's sign track -> (new track, y_cross,
                first_hit mask)."""
                r_in_p, r_out_p, _th_p, _opq = plane

                def dval(ys):
                    if basis_fn is None:
                        if formulation == "mu":
                            return ys[1] - plane_c  # state IS cos(theta)
                        return jnp.cos(ys[1]) - plane_c
                    (nx, ny, nz), _e1, _e2 = basis_fn(ys[0])
                    sth, cth = jnp.sin(ys[1]), jnp.cos(ys[1])
                    sph, cph = jnp.sin(ys[2]), jnp.cos(ys[2])
                    return nx * sth * cph + ny * sth * sph + nz * cth

                d_prev = dval(y)
                d_next = dval(y_acc)
                # Strict sign change, plus the tangent case of landing
                # exactly on the plane (measure-zero center-column
                # pixels otherwise leave a 1-px seam in disk renders).
                crossed = upd & ((d_prev * d_next < 0.0)
                                 | ((d_next == 0.0) & (d_prev != 0.0)))
                den = jnp.where(d_next == d_prev, 1.0, d_next - d_prev)
                frac_c = jnp.clip(-d_prev / den, 0.0, 1.0)
                if event_interp == "hermite":
                    # k7 is the derivative at y5 (the un-shortened
                    # endpoint); when a capture/escape event shortened
                    # this same step (y_acc != y5), Hermite with k7
                    # would be inconsistent — fall back to linear on
                    # those (rare) lanes.
                    y_cross_h = _hermite_eval(y, y_acc, k1, k7,
                                              frac * h_eff, frac_c)
                    y_cross = _select(cap | esc,
                                      _lerp(y, y_acc, frac_c),
                                      y_cross_h)
                else:
                    y_cross = _lerp(y, y_acc, frac_c)
                r_c = y_cross[0]
                in_disk = crossed & (r_c >= r_in_p) & (r_c <= r_out_p)
                # "down" = upper hemisphere -> lower (+z -> -z):
                # cos(theta) decreasing — d is cos-based in both
                # formulations.
                going_down = d_next < d_prev
                down_f = going_down.astype(r_c.dtype)

                # PHYSICAL azimuth of the crossing. On the
                # sin(theta) < 0 double-cover branch (over-the-pole
                # rays: theta ran negative, or past pi) the chart phi
                # is off by pi: x = r sin(theta) cos(phi), so the
                # physical azimuth is phi + pi there. Without this,
                # hot-spot/texture patterns sample the wrong side of
                # the disk on exactly the center-column pixels the
                # cos-detector fix heals. The mu chart folds the branch
                # away, so disk mode is theta-only (enforced at the
                # wrappers).
                if basis_fn is not None:
                    (nx_c, ny_c, nz_c), e1_c, e2_c = basis_fn(y_cross[0])
                    sth, cth = jnp.sin(y_cross[1]), jnp.cos(y_cross[1])
                    sph, cph = jnp.sin(y_cross[2]), jnp.cos(y_cross[2])
                    xh, yh, zh = sth * cph, sth * sph, cth
                    u1 = xh * e1_c[0] + yh * e1_c[1] + zh * e1_c[2]
                    u2 = xh * e2_c[0] + yh * e2_c[1] + zh * e2_c[2]
                    phi_c = jnp.arctan2(u2, u1)
                    # n.L from the crossing state: the standard
                    # canonical angular-momentum components
                    #  L_x = -sin(phi) p_theta - cot(theta) cos(phi) p_phi
                    #  L_y =  cos(phi) p_theta - cot(theta) sin(phi) p_phi
                    #  L_z =  p_phi
                    # (exactly conserved for a = 0; the flat-embedding
                    # projection for tilted Kerr — DiskConfig.tilt docs).
                    th_c, ph_c, pth_c = y_cross[1], y_cross[2], y_cross[4]
                    sth_c = jnp.sin(th_c)
                    # Sign-PRESERVING clamp: replacing a tiny negative
                    # sin(theta) with +eps would flip the sign of cot
                    # and hence of the recorded xi on near-pole
                    # crossings.
                    sth_safe = jnp.where(
                        jnp.abs(sth_c) < 1e-12,
                        jnp.where(sth_c < 0.0, -1e-12, 1e-12).astype(
                            sth_c.dtype),
                        sth_c)
                    cot_c = jnp.cos(th_c) / sth_safe
                    sph_c, cph_c = jnp.sin(ph_c), jnp.cos(ph_c)
                    lx = -sph_c * pth_c - cot_c * cph_c * p_phi
                    ly = cph_c * pth_c - cot_c * sph_c * p_phi
                    xi_c = nx_c * lx + ny_c * ly + nz_c * p_phi
                else:
                    phi_c = y_cross[2]
                    xi_c = None
                    if formulation != "mu":
                        phi_c = jnp.where(jnp.sin(y_cross[1]) < 0.0,
                                          phi_c + np.pi, phi_c)

                t_c = None
                if record_time:
                    # Trapezoid over the sub-segment up to the crossing
                    # (length frac_c * seg).
                    td_cross = rhs_t(y_cross)
                    t_c = t_now + 0.5 * (frac_c * seg) * (td_prev
                                                          + td_cross)

                n = track["n"]
                new_r = list(track["r"])
                new_phi = list(track["phi"])
                new_pr = list(track["pr"])
                new_pth = list(track["pth"])
                new_down = list(track["down"])
                new_xi = list(track["xi"])
                new_t = list(track["t"])
                for slot in range(max_disk_hits):
                    take = in_disk & (n == slot)
                    new_r[slot] = jnp.where(take, r_c, new_r[slot])
                    new_phi[slot] = jnp.where(take, phi_c, new_phi[slot])
                    if new_pr:
                        new_pr[slot] = jnp.where(take, y_cross[3],
                                                 new_pr[slot])
                        new_pth[slot] = jnp.where(take, y_cross[4],
                                                  new_pth[slot])
                    new_down[slot] = jnp.where(take, down_f,
                                               new_down[slot])
                    if new_t:
                        new_t[slot] = jnp.where(take, t_c, new_t[slot])
                    if xi_c is not None:
                        new_xi[slot] = jnp.where(take, xi_c, new_xi[slot])
                n = jnp.where(in_disk, jnp.minimum(n + 1, max_disk_hits),
                              n)
                new_track = {"n": n, "r": tuple(new_r),
                             "phi": tuple(new_phi),
                             "pr": tuple(new_pr), "pth": tuple(new_pth),
                             "down": tuple(new_down), "xi": tuple(new_xi),
                             "t": tuple(new_t)}
                first_hit = in_disk & (n == 1)
                return new_track, y_cross, first_hit, t_c

            tracks = [{k: hits[k]
                       for k in ("n", "r", "phi", "pr", "pth",
                                 "down", "xi", "t")}]
            tracks += list(hits.get("extra", ()))
            new_tracks = []
            # Opaque termination: the ray parks at its FIRST in-disk
            # crossing of any opaque plane (list order breaks the
            # measure-zero tie of two planes crossed in one step; a
            # translucent plane never terminates).
            stopped = jnp.zeros_like(upd)
            if record_time:
                t_stop = t_acc_val
            for (plane, _nrm), bfn, pc, track in zip(
                    _planes, _basis_fns, _plane_cs, tracks):
                new_track, y_cross_p, first_hit, t_c_p = _record(
                    track, plane, bfn, pc)
                new_tracks.append(new_track)
                if plane[3]:  # opaque
                    stop = (first_hit & (status_out == RUNNING)
                            & ~stopped)
                    y_out = _select(stop, y_cross_p, y_out)
                    status_out = jnp.where(stop, ESCAPED,
                                           status_out).astype(jnp.int32)
                    if record_time:
                        # A ray parked at the crossing stops its clock
                        # there too (t_end == its recorded crossing t).
                        t_stop = jnp.where(stop, t_c_p, t_stop)
                    stopped = stopped | stop
            hits_out = dict(new_tracks[0])
            if len(new_tracks) > 1:
                hits_out["extra"] = tuple(new_tracks[1:])
            if record_time:
                hits_out["t_now"] = jnp.where(upd, t_stop, t_now)

        return (step + 1, y_out, k1_out, h_new, lam_out, status_out,
                hits_out, sat_cnt_out, frz_cnt_out)

    carry0 = (jnp.asarray(0, jnp.int32), y0, k1_0, h0, lam0, status0,
              hits0, sat_cnt0, frz_cnt0)
    (step_f, y_f, _k1_f, _h_f, lam_f, status_f, hits_f,
     _sat_f, _frz_f) = jax.lax.while_loop(cond, body, carry0)
    if disk_plane is not None:
        return y_f, status_f, lam_f, step_f, hits_f
    return y_f, status_f, lam_f, step_f


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "lambda_max",
                     "max_steps", "event_interp", "s_thresh", "slots",
                     "precision", "method"))
def trace_rays_kerr_hybrid(metric, r_obs, alphas, thetas, theta_obs,
                           axis_refine, lambda_max: float,
                           max_steps: int = 200000,
                           event_interp: str = "hermite",
                           s_thresh: float = 1e-3,
                           slots: int | None = None,
                           dynamic_params=None,
                           precision: str = "fast",
                           method: str = "dp45"):
    """Kerr tracer: mu-form bulk + theta-form pole fallback.

    The rational mu = cos(theta) formulation needs no transcendentals
    per step but is ill-conditioned for the few rays that pass near the
    polar axis (p_mu ~ 1/sin(theta) diverges — typically the one screen
    column aimed straight over the pole). This driver:

      1. predicts those lanes from the conserved quantities at launch
         (Kerr.pole_risk) and poisons them so they cost zero steps;
      2. traces everything else in mu form;
      3. gathers the poisoned/invalid lanes into fixed `slots` and
         re-traces them in theta form at full depth, then scatters back.

    All inside one jitted XLA program.
    dynamic_params: optional traced (M, a) — metric is then a placeholder
    (recompilation-free parameter sweeps) — or traced (M, a, r_obs): the
    observer radius joins the traced carry too (flyby/approach sequences;
    the static `r_obs` argument is then only a compile-key placeholder,
    but `lambda_max` must still bound the LARGEST radius of the sweep,
    e.g. max(5000, 6 * r_obs_max)).
    Falls back to pure theta form when the observer is nearly polar
    (sin(theta_obs) < 0.1: most of the grid would be pole-risk anyway).
    """
    import math

    if dynamic_params is not None:
        from light_path_tracer_tpu.models.kerr import TracedKerr
        eff_metric = TracedKerr(
            jnp.asarray(dynamic_params[0], alphas.dtype),
            jnp.asarray(dynamic_params[1], alphas.dtype))
    else:
        eff_metric = metric
    dyn_r = dynamic_params is not None and len(dynamic_params) >= 3
    eff_r_obs = (jnp.asarray(dynamic_params[2], alphas.dtype) if dyn_r
                 else float(r_obs))

    def run(al, th, rf, form, fi=None):
        return _trace_rays_kerr_impl(
            eff_metric, eff_r_obs, al, th, float(theta_obs), rf,
            float(lambda_max), max_steps, event_interp, True, form, fi,
            precision, method)

    if abs(math.sin(float(theta_obs))) < 0.1:
        # Nearly-polar observer: most rays hug the axis; mu form would
        # reroute nearly everything, so integrate it all in theta form.
        return run(alphas, thetas, axis_refine, "theta")

    n = int(alphas.shape[0])
    risk = eff_metric.pole_risk(
        eff_r_obs, alphas, thetas, float(theta_obs), s_thresh)
    if slots is None:
        # Sized for the default s_thresh: measured risk fraction at
        # s_thresh=1e-3 is ~1.6% of an equatorial-observer grid; n//32
        # leaves ~2x margin. Overflow degrades gracefully (see below).
        slots = min(n, max(8192, -(-n // 32)))
    slots = min(slots, n)

    # Poison only the risk lanes that pass 2 is guaranteed to pick up
    # (the first `slots` of them) — if a pathological scene produces more
    # risk lanes than slots, the excess integrate in mu form instead of
    # being frozen into invalid pixels.
    idx_r = jnp.nonzero(risk, size=slots, fill_value=n)[0]
    poison = jnp.zeros((n,), bool).at[idx_r].set(True, mode="drop")

    res_a = run(alphas, thetas, axis_refine, "mu", fi=poison)

    redo = poison | (res_a.status == INVALID)
    idx = jnp.nonzero(redo, size=slots, fill_value=0)[0]
    res_b = run(alphas[idx], thetas[idx], axis_refine[idx], "theta")

    take = redo[idx]
    fa = res_a.final_alpha.at[idx].set(
        jnp.where(take, res_b.final_alpha, res_a.final_alpha[idx]))
    nh = res_a.n_half_orbits.at[idx].set(
        jnp.where(take, res_b.n_half_orbits, res_a.n_half_orbits[idx]))
    st = res_a.status.at[idx].set(
        jnp.where(take, res_b.status, res_a.status[idx]))
    return TraceResult(fa, nh, st, res_a.n_steps + res_b.n_steps)
