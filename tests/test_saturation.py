"""Emission-saturation early exit (round-5 verdict item 1).

A near-critical photon-ring orbiter neither captures nor escapes: it
can grind the full step budget even though its path integrals have
stopped changing. dp45_integrate's sat_window exit ends such a lane once
its monitored extras have been bitwise-unchanged for a full window of
accepted steps while inside the photon-shell radial band
(ops/kerr_trace.py docstring).

The grind was seen only on the previous accelerator's arithmetic (the
same rays finish in ~100 steps on CPU), so these tests pin the MECHANISM
and the no-op contract on CPU; whether the exit ever fires on the GPU is
an open question (ROADMAP D3). Reference anchor: the 200k hard cap,
/root/reference/metrics.py:452, is the reference's only answer to
trapped orbiters — this exit is the part it lacks.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from light_path_tracer_tpu.models import Kerr
from light_path_tracer_tpu.ops.kerr_trace import (saturation_r_max,
                                                  trace_rays_volumetric)
from light_path_tracer_tpu.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu.volumetric import (RIAFConfig,
                                              make_transfer_fns,
                                              render_volumetric,
                                              render_volumetric_decomposed,
                                              render_volumetric_spectrum)

METRIC = Kerr(M=1.0, a=0.9)
R_OBS = 100.0
THETA_OBS = float(np.radians(80.0))
# f32 capture-boundary alpha at screen azimuth 0 for the scene above
# (bisected once; the tests only need "dwells many in-band steps").
ALPHA_BOUNDARY = 0.04788942448789385

SCENE = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0, theta_obs=THETA_OBS,
                    vertical_fov_deg=16.0)
CFG = RenderConfig(backend="xla", max_steps=20000)
CFG_OFF = dataclasses.replace(CFG, sat_window=0)


def _boundary_fan(n=9):
    base = np.float32(ALPHA_BOUNDARY)
    return jnp.asarray(
        [base + k * np.float32(abs(base) * 6e-8)
         for k in range(-(n // 2), n - n // 2)], jnp.float32)


def _empty_shell_fns():
    """Emission shell entirely OUTSIDE the camera radius: rays collect
    nothing until (if ever) they escape outward through it — the
    integrand is exactly zero during any photon-shell dwell."""
    riaf = RIAFConfig(profile="shell", shell_in=150.0, shell_out=160.0,
                      g_power=0.0)
    return make_transfer_fns(METRIC, riaf)


def test_saturation_r_max_band():
    # 1.2x the outermost (retrograde) unstable photon orbit.
    r_pro, r_retro = METRIC.unstable_photon_radii()
    assert saturation_r_max(METRIC) == pytest.approx(1.2 * r_retro)
    assert saturation_r_max(METRIC) < 6.0  # well inside the torus scene


def test_exit_fires_for_in_band_no_change_lanes():
    """Boundary rays dwell ~100 accepted steps inside the photon shell;
    with zero integrand and a window smaller than the dwell, the exit
    must fire (far fewer lock-step iterations)."""
    em_fn, _ = _empty_shell_fns()
    alphas = _boundary_fan()
    thetas = jnp.zeros_like(alphas)
    res_off = trace_rays_volumetric(
        METRIC, R_OBS, alphas, thetas, THETA_OBS, em_fn, 5000.0, 200000,
        precision="gate", sat_window=0)
    res_on = trace_rays_volumetric(
        METRIC, R_OBS, alphas, thetas, THETA_OBS, em_fn, 5000.0, 200000,
        precision="gate", sat_window=8)
    assert int(res_on.n_steps) < int(res_off.n_steps) // 2
    # Pre-exit accumulation is preserved exactly (zero here).
    np.testing.assert_array_equal(np.asarray(res_on.emission), 0.0)


def test_band_guard_blocks_far_field_exit():
    """Weak-deflection rays never enter the photon-shell band: even
    with a tiny window and a zero integrand they must run to their
    natural termination — identical steps, status, and emission."""
    em_fn, _ = _empty_shell_fns()
    alphas = jnp.asarray(np.linspace(0.15, 0.3, 8), jnp.float32)
    thetas = jnp.zeros_like(alphas)
    res_off = trace_rays_volumetric(
        METRIC, R_OBS, alphas, thetas, THETA_OBS, em_fn, 5000.0, 200000,
        sat_window=0)
    res_on = trace_rays_volumetric(
        METRIC, R_OBS, alphas, thetas, THETA_OBS, em_fn, 5000.0, 200000,
        sat_window=8)
    assert int(res_on.n_steps) == int(res_off.n_steps)
    np.testing.assert_array_equal(np.asarray(res_on.status),
                                  np.asarray(res_off.status))
    np.testing.assert_array_equal(np.asarray(res_on.emission),
                                  np.asarray(res_off.emission))


def test_sat_window_requires_monitor():
    em_fn, _ = _empty_shell_fns()
    from light_path_tracer_tpu.ops.kerr_trace import dp45_integrate
    with pytest.raises(ValueError, match="sat_monitor"):
        dp45_integrate(
            METRIC, (jnp.ones(4),) * 6, -jnp.ones(4), jnp.ones(4),
            jnp.full(4, 2, jnp.int32), atol=jnp.full(4, 1e-5),
            rtol=jnp.full(4, 1e-5), h_min=jnp.asarray(1e-7),
            tiny_err=1e-8, r_capture=jnp.asarray(2.0),
            r_escape=jnp.asarray(200.0), lambda_max=100.0, h_init=1.0,
            max_steps=10, extra_rhs=lambda y, pt, pp: (y[0] * 0.0,),
            sat_window=8, sat_monitor=())


@pytest.mark.parametrize("mode", ["thin", "absorbed", "decomposed",
                                  "spectral"])
def test_default_window_is_noop_on_clean_scene(mode):
    """With the production window (2048 >> any legitimate in-band
    dwell) a clean 32-squared render is BITWISE identical to the
    exit disabled — the exit only ever removes provably dead work."""
    fns = {
        "thin": lambda c: render_volumetric(SCENE, (32, 32), c,
                                            RIAFConfig()),
        "absorbed": lambda c: render_volumetric(
            SCENE, (32, 32), c, RIAFConfig(alpha0=0.3)),
        "decomposed": lambda c: render_volumetric_decomposed(
            SCENE, (32, 32), c, RIAFConfig(), n_orders=3),
        "spectral": lambda c: render_volumetric_spectrum(
            SCENE, (32, 32), (0.5, 1.0), c, RIAFConfig(alpha0=1.0)),
    }
    img_on, st_on = fns[mode](CFG)
    img_off, st_off = fns[mode](CFG_OFF)
    np.testing.assert_array_equal(np.asarray(img_on),
                                  np.asarray(img_off))
    assert st_on["integrator_steps"] == st_off["integrator_steps"]


@pytest.mark.slow
def test_polarized_default_window_noop():
    from light_path_tracer_tpu.polarization import (
        render_polarized_volumetric)
    scene = dataclasses.replace(SCENE, psi_y=0.0)
    evpa_on, pf_on, i_on, _ = render_polarized_volumetric(
        scene, (24, 24), CFG)
    evpa_off, pf_off, i_off, _ = render_polarized_volumetric(
        scene, (24, 24), CFG_OFF)
    np.testing.assert_array_equal(i_on, i_off)
    np.testing.assert_array_equal(pf_on, pf_off)
