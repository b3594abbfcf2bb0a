#!/usr/bin/env python
"""Full-scale accuracy gate: 1024^2 Kerr a=0.9 lensed render on the GPU.

Gate (BASELINE.json north star): image RMSE of the f32 path vs the f64
reference-tolerance path < 1e-3. Both traces run over the full grid on
the card (f64 is native there), so no pixel sampling is needed.

  1. f32 tiers "fast", "precise" and "gate" (the fused Pallas kernel) and
     f64 "gate" (atol 1e-7) are traced over the full grid.
  2. f64 at the reference tolerances (metrics.py:431-432) is the oracle.
  3. Each tier's lookup and the oracle's are rendered against the same
     smooth multi-scale texture; the RMSE is reported over all pixels,
     off the photon ring, and over non-chaotic pixels (winding < 2),
     nearest and bilinear.

The last row is the volumetric gate: a 256^2 Kerr a=0.9 torus image in
f32 (production config, incl. the emission-saturation exit) vs the f64
reference-tolerance trace — per-pixel emission relative-error
percentiles plus the mean-flux error.

Prints one JSON line per tier, each naming the card. Fails when JAX finds
no GPU.
  python scripts/f32_gate.py
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from light_path_tracer_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from light_path_tracer_tpu.models import Kerr
    from light_path_tracer_tpu import camera
    from light_path_tracer_tpu.ops.batch import trace_batch
    from light_path_tracer_tpu.render import render_lensed_image

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"f32_gate.py: no GPU (JAX's first device is "
                 f"{dev.platform})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()

    dim = (1024, 1024)
    spin, r_obs = 0.9, 100.0
    metric = Kerr(M=1.0, a=spin)
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    alpha_crit = metric.alpha_crit(r_obs)

    def trace(dtype, precision):
        a = camera.build_alpha_lookup(dim, fov, dtype=dtype).ravel()
        t = camera.build_theta_lookup(dim, fov, dtype=dtype).ravel()
        res = trace_batch(metric, r_obs, a, t, precision=precision)
        fa = np.asarray(res.final_alpha, np.float64).reshape(dim)
        t0 = time.perf_counter()        # second run: compiled
        np.asarray(trace_batch(metric, r_obs, a, t,
                               precision=precision).final_alpha)
        return (fa, np.asarray(res.n_half_orbits).reshape(dim),
                time.perf_counter() - t0)

    with jax.default_matmul_precision("highest"):
        fa64, w64, dt64 = trace(jnp.float64, "fast")
        alpha = camera.build_alpha_lookup(dim, fov, dtype=jnp.float32)
        for label, dtype, precision in (
                ("f32_fast", jnp.float32, "fast"),
                ("f32_precise", jnp.float32, "precise"),
                ("f32_gate", jnp.float32, "gate"),
                ("f64_gate", jnp.float64, "gate")):
            fa, w, dt = trace(dtype, precision)
            row = _evaluate(jnp, render_lensed_image, dim, fov, alpha,
                            alpha_crit, fa, w, fa64, w64)
            row.update(metric=f"{label}_vs_f64_image_rmse_1024sq_kerr_"
                              f"a0.9_lensed", card=card,
                       trace_seconds=dt, oracle_trace_seconds=dt64)
            print(json.dumps(row), flush=True)
        _volumetric_gate(jax, jnp, card)


def _smooth_texture(dim):
    yy, xx = np.meshgrid(np.linspace(0, 1, dim[0]),
                         np.linspace(0, 1, dim[1]), indexing="ij")
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (3 * xx + 2 * yy)),
        0.5 + 0.5 * np.sin(2 * np.pi * (5 * yy - 1 * xx) + 1.0),
        0.5 + 0.5 * np.sin(2 * np.pi * (2 * xx * yy + 4 * xx) + 2.0),
    ], axis=-1).astype(np.float32)


def _evaluate(jnp, render_lensed_image, dim, fov, alpha, alpha_crit, fa,
              w, fa64, w64):
    """Image and angle errors of one tier against the f64 oracle.

    Near the critical curve the lensing map's condition number diverges,
    so image error there is unbounded at ANY precision; photon-ring
    pixels of winding order >= 2 amplify any perturbation by ~e^(pi w).
    The meaningful image gate is therefore off the ring / on
    non-chaotic pixels; the ring is gated in angle space."""
    tex = jnp.asarray(_smooth_texture(dim))

    def render(f, wd, sampling):
        return np.asarray(render_lensed_image(
            tex, alpha, jnp.asarray(f, jnp.float32),
            jnp.asarray(wd, jnp.uint16), alpha_crit, fov,
            sampling=sampling))

    off_ring = np.abs(np.asarray(alpha) - alpha_crit) > 0.05 * alpha_crit
    calm = (w < 2) & (w64 < 2)
    out = {"unit": "rmse", "gate": 1e-3}
    for sampling in ("nearest", "bilinear"):
        d = render(fa, w, sampling) - render(fa64, w64, sampling)
        out[f"image_rmse_{sampling}"] = float(np.sqrt(np.mean(d ** 2)))
        out[f"image_rmse_off_ring_{sampling}"] = float(
            np.sqrt(np.mean(d[off_ring] ** 2)))
        out[f"image_rmse_nonchaotic_{sampling}"] = float(
            np.sqrt(np.mean(d[calm] ** 2)))
    out["value"] = out["image_rmse_nonchaotic_bilinear"]
    out["pass_image_gate_nonchaotic_bilinear"] = out["value"] < 1e-3
    both = np.isfinite(fa) & np.isfinite(fa64)
    d_fa = np.abs(fa - fa64)[both]
    out.update(
        shadow_agreement=float(np.mean(np.isnan(fa) == np.isnan(fa64))),
        winding_match=float(np.mean(w == w64)),
        nonchaotic_fraction=float(calm.mean()),
        final_alpha_rmse_rad=float(np.sqrt(np.mean(d_fa ** 2))),
        final_alpha_median_err_rad=float(np.median(d_fa)),
        final_alpha_p99_err_rad=float(np.percentile(d_fa, 99)))
    return out


def _volumetric_gate(jax, jnp, card):
    """f32 volumetric torus at 256^2 vs the f64 reference-tolerance trace
    of the same rays, both on the card."""
    from light_path_tracer_tpu import camera
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_volumetric
    from light_path_tracer_tpu.utils.config import RenderConfig, SceneConfig
    from light_path_tracer_tpu.volumetric import (RIAFConfig,
                                                  make_transfer_fns,
                                                  render_volumetric)

    dim = (256, 256)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=float(np.radians(80.0)),
                        vertical_fov_deg=16.0)
    riaf = RIAFConfig()
    cfg = RenderConfig()
    _img, st32 = render_volumetric(scene, dim, cfg, riaf)
    em32 = np.asarray(st32["emission"], np.float64).ravel()

    metric = scene.metric()
    em_fn, ab_fn = make_transfer_fns(metric, riaf)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    a64 = camera.build_alpha_lookup(dim, fov, psi=scene.psi,
                                    dtype=jnp.float64).ravel()
    t64 = camera.build_theta_lookup(dim, fov, psi=scene.psi,
                                    dtype=jnp.float64).ravel()
    res64 = trace_rays_volumetric(
        metric, scene.r_obs, a64, t64, scene.theta_obs, em_fn,
        max(5000.0, 6.0 * scene.r_obs), cfg.max_steps,
        absorption_fn=ab_fn)
    em64 = np.asarray(res64.emission, np.float64)

    # Relative error scaled by the oracle's peak (per-pixel division
    # would explode on the empty far field, where both agree on ~0).
    scale = max(float(em64.max()), 1e-30)
    rel = np.abs(em32 - em64) / scale
    flux_rel = abs(float(em32.mean() - em64.mean())) / max(
        float(em64.mean()), 1e-30)
    print(json.dumps({
        "metric": "f32_vs_f64_volumetric_emission_256sq_torus",
        "unit": "relative_to_peak", "card": card,
        "value": float(np.sqrt(np.mean(rel ** 2))),
        "gate": 1e-2,
        "pass_p99_rel_gate": bool(np.percentile(rel, 99) < 1e-2),
        "pass_flux_gate": bool(flux_rel < 1e-3),
        "rel_err_median": float(np.median(rel)),
        "rel_err_p99": float(np.percentile(rel, 99)),
        "rel_err_max": float(rel.max()),
        "flux_rel_err": flux_rel,
        "sat_window": cfg.sat_window,
    }), flush=True)


if __name__ == "__main__":
    main()
