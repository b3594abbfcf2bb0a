"""Fused Pallas kernel tests: Triton interpret mode on the CPU, a CUDA
lowering check that needs no card, and the backend choice.

The kernel and the XLA path share the dp45_integrate body, so the
interpret-mode comparisons check the blocking, masking, padding and
output plumbing; the lowering check catches primitives the Triton route
cannot lower (reduce_or, negated folded literals, integer_pow of a
literal) before they reach a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from light_path_tracer_tpu import camera
from light_path_tracer_tpu.disk import DiskConfig, r_isco, trace_disk_rays
from light_path_tracer_tpu.models import JohannsenPsaltis, Kerr, KerrNewman
from light_path_tracer_tpu.ops import batch
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr
from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
    trace_disk_rays_pallas, trace_rays_kerr_pallas)

R_OBS = 100.0
INC = float(np.radians(80.0))

METRICS = {
    "kerr": Kerr(M=1.0, a=0.9),
    "kerr_newman": KerrNewman(M=1.0, a=0.5, Q=0.4),
    "johannsen_psaltis": JohannsenPsaltis(M=1.0, a=0.5, eps3=0.5),
}


def _grid(size, dtype=jnp.float32):
    """A size^2 pinhole-camera grid (40 deg vertical field of view)."""
    fov = camera.fov_from_vertical(np.radians(40.0), (size, size))
    al = camera.build_alpha_lookup((size, size), fov)
    th = camera.build_theta_lookup((size, size), fov)
    return (jnp.asarray(al, dtype).ravel(), jnp.asarray(th, dtype).ravel())


def _disk_plane(metric):
    return (float(r_isco(metric.M, metric.a, True)), 20.0,
            float(np.pi / 2), True)


def _stable_escaped(metric, alphas, st_a, st_b, theta_obs=np.pi / 2):
    """Both escaped and not within 5% of the critical angle (grazers
    amplify the roundoff of a different step order)."""
    ac = metric.alpha_crit(R_OBS, theta_obs)
    return ((st_a == 1) & (st_b == 1)
            & (np.abs(np.asarray(alphas) - ac) > 0.05 * ac))


@pytest.mark.parametrize("name", sorted(METRICS))
def test_kernel_matches_xla_on_grid(name):
    """32^2 lens/shadow grid through the kernel (interpret mode) vs the
    XLA loop: outcomes agree and stable escaped headings match."""
    m = METRICS[name]
    al, th = _grid(32)
    rf = jnp.zeros(al.shape, bool)
    rp = trace_rays_kerr_pallas(m, R_OBS, al, th, np.pi / 2, rf, 5000.0,
                                20000, interpret=True)
    rx = trace_rays_kerr(m, R_OBS, al, th, np.pi / 2, rf, 5000.0, 20000)
    sp, sx = np.asarray(rp.status), np.asarray(rx.status)
    assert (sp == sx).mean() > 0.99
    assert (sp == -1).any() and (sp == 1).any()
    stable = _stable_escaped(m, al, sp, sx)
    d = np.abs(np.asarray(rp.final_alpha)[stable]
               - np.asarray(rx.final_alpha)[stable])
    assert np.percentile(d, 99) < 1e-3
    assert int(rp.n_steps) > 0


def test_kernel_disk_recorder_matches_xla():
    """The disk-crossing recorder in the kernel (32^2, i = 80 deg) vs the
    XLA disk trace: hit masks and crossing radii agree."""
    m = METRICS["kerr"]
    al, th = _grid(32)
    rp = trace_disk_rays_pallas(m, R_OBS, al, th, INC, 5000.0, 20000,
                                _disk_plane(m), 2, interpret=True)
    rx = trace_disk_rays(m, R_OBS, al, th, INC, 5000.0, 20000,
                         DiskConfig(), backend="xla")
    hp, hx = np.asarray(rp.n_hits) > 0, np.asarray(rx.n_hits) > 0
    assert hx.sum() > 50
    assert (hp == hx).mean() > 0.99
    both = hp & hx
    d = np.abs(np.asarray(rp.r_hits[0])[both]
               - np.asarray(rx.r_hits[0])[both])
    assert np.percentile(d, 99) < 1e-2


def test_pallas_invalid_and_captured_lanes():
    """Padding lanes (45 rays over two 32-ray blocks) are masked invalid
    and cut off; a deep-shadow ray and the on-axis ray are captured with
    NaN headings, a wide ray escapes."""
    m = Kerr(M=1.0, a=0.9)
    ac = m.alpha_crit(R_OBS)
    rng = np.random.default_rng(0)
    alphas = np.concatenate([[0.2 * ac, 2.0 * ac, 0.0],
                             rng.uniform(1.5 * ac, 4 * ac, 42)])
    thetas = np.concatenate([[0.3, 1.0, 0.0], rng.uniform(-np.pi, np.pi, 42)])
    al = jnp.asarray(alphas, jnp.float32)
    th = jnp.asarray(thetas, jnp.float32)
    rf = jnp.zeros(al.shape, bool)
    rp = trace_rays_kerr_pallas(m, R_OBS, al, th, np.pi / 2, rf, 5000.0,
                                5000, block=32, interpret=True)
    rx = trace_rays_kerr(m, R_OBS, al, th, np.pi / 2, rf, 5000.0, 5000)
    assert rp.status.shape == (45,) and rp.final_alpha.shape == (45,)
    assert int(rp.status[0]) == -1 and np.isnan(float(rp.final_alpha[0]))
    assert int(rp.status[1]) == 1 and np.isfinite(float(rp.final_alpha[1]))
    assert int(rp.status[2]) == -1
    np.testing.assert_array_equal(np.asarray(rp.status),
                                  np.asarray(rx.status))


def test_pallas_rejects_f64():
    m = Kerr(M=1.0, a=0.9)
    z = jnp.zeros(4, jnp.float64)
    with pytest.raises(ValueError, match="float32-only"):
        trace_rays_kerr_pallas(m, R_OBS, z, z, np.pi / 2,
                               jnp.zeros(4, bool), 5000.0, 100,
                               interpret=True)
    with pytest.raises(ValueError, match="float32-only"):
        trace_disk_rays_pallas(m, R_OBS, z, z, INC, 5000.0, 100,
                               _disk_plane(m), 2, interpret=True)


@pytest.mark.parametrize("mode", ["lens", "disk"])
def test_kernel_lowers_for_cuda(mode):
    """Triton lowering for CUDA at production settings (200k-step budget,
    default block), on a host without a card."""
    m = METRICS["kerr"]
    al = jnp.zeros(64, jnp.float32)
    if mode == "lens":
        fn = jax.jit(lambda a: trace_rays_kerr_pallas(
            m, R_OBS, a, a, np.pi / 2, a > 0, 5000.0, 200000))
    else:
        fn = jax.jit(lambda a: trace_disk_rays_pallas(
            m, R_OBS, a, a, INC, 5000.0, 200000, _disk_plane(m), 2))
    text = fn.trace(al).lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text


@pytest.mark.parametrize("platform, dtype, backend, metric, want", [
    ("gpu", jnp.float32, "auto", None, "pallas"),
    ("gpu", jnp.float64, "auto", None, "xla"),
    ("cpu", jnp.float32, "auto", None, "xla"),
    ("gpu", jnp.float32, "xla", None, "xla"),
    ("cpu", jnp.float32, "pallas", None, "pallas"),
    ("gpu", jnp.float32, "auto", "custom", "xla"),
])
def test_kerr_backend_choice(monkeypatch, platform, dtype, backend, metric,
                             want):
    """'auto' is the kernel on a GPU in float32 and XLA otherwise; an
    explicit choice is kept; an autodiff-RHS metric resolves to XLA."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if metric == "custom":
        class _Autodiff:
            supports_pallas = False
        metric = _Autodiff()
    assert batch._kerr_backend(backend, jnp.dtype(dtype), metric) == want


def test_kerr_backend_rejects_pallas_for_autodiff_metric():
    class _Autodiff:
        supports_pallas = False
    with pytest.raises(ValueError, match="no Pallas kernel"):
        batch._kerr_backend("pallas", jnp.dtype(jnp.float32), _Autodiff())


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_card(gpu):
    """The kernel as compiled for the card vs the XLA loop (chip_smoke.py
    runs the same comparison at 1024^2)."""
    m = METRICS["kerr"]
    al, th = _grid(128)
    rf = jnp.zeros(al.shape, bool)
    rp = trace_rays_kerr_pallas(m, R_OBS, al, th, np.pi / 2, rf, 5000.0,
                                200000)
    rx = trace_rays_kerr(m, R_OBS, al, th, np.pi / 2, rf, 5000.0, 200000)
    sp, sx = np.asarray(rp.status), np.asarray(rx.status)
    assert (sp == sx).mean() > 0.99
    stable = _stable_escaped(m, al, sp, sx)
    d = np.abs(np.asarray(rp.final_alpha)[stable]
               - np.asarray(rx.final_alpha)[stable])
    assert np.percentile(d, 99) < 2e-3
