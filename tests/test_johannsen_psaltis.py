"""Johannsen-Psaltis deformed Kerr: oracles and limits.

The family runs on the generic autodiff-Hamiltonian RHS (no Carter
constant exists), so the tests lean on structure-independent checks:
the eps3 -> 0 Kerr limit, Hamiltonian (null-condition) conservation
along integrated geodesics, an independent static-case photon-sphere
oracle built directly from the covariant metric functions, and the
numeric-bisection critical angle validated against Kerr's analytic
envelope.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from light_path_tracer_tpu.models import (JohannsenPsaltis, Kerr,
                                          make_metric)
from light_path_tracer_tpu.models.johannsen_psaltis import (
    _covariant_terms_jp)
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr, ESCAPED


R_OBS = 100.0


def _rays():
    al = np.linspace(0.05, 0.3, 5)
    th = np.linspace(0.3, 5.8, 5)
    return (jnp.asarray(al, jnp.float64), jnp.asarray(th, jnp.float64))


def test_eps3_zero_rhs_matches_kerr_hand_form():
    jp = JohannsenPsaltis(1.0, 0.7, eps3=0.0)
    k = Kerr(1.0, 0.7)
    y = tuple(jnp.asarray([v, 2 * v], jnp.float64)
              for v in (8.0, 1.2, 0.3, -0.4, 2.1))
    p_phi = jnp.asarray([3.0, -1.0], jnp.float64)
    a1 = jp.rhs5(y, -1.0, p_phi)
    a2 = k.rhs5(y, -1.0, p_phi)
    for x, z in zip(a1, a2):
        np.testing.assert_allclose(np.asarray(x), np.asarray(z),
                                   rtol=0, atol=1e-13)


@pytest.mark.slow
def test_eps3_zero_trace_matches_kerr():
    alphas, thetas = _rays()
    kw = dict(axis_refine=jnp.zeros(5, bool), lambda_max=5000.0,
              max_steps=100000)
    r_jp = trace_rays_kerr(JohannsenPsaltis(1.0, 0.9, eps3=0.0),
                           R_OBS, alphas, thetas, np.pi / 2, **kw)
    r_k = trace_rays_kerr(Kerr(1.0, 0.9),
                          R_OBS, alphas, thetas, np.pi / 2, **kw)
    np.testing.assert_array_equal(np.asarray(r_jp.status),
                                  np.asarray(r_k.status))
    esc = np.asarray(r_k.status) == ESCAPED
    # Same trajectory to integrator roundoff (the autodiff RHS agrees
    # with the hand form to ~1e-16 per evaluation; JP's early-capture
    # exit is disabled, so captured lanes may park differently but
    # escaped headings must match tightly).
    np.testing.assert_allclose(np.asarray(r_jp.final_alpha)[esc],
                               np.asarray(r_k.final_alpha)[esc],
                               rtol=0, atol=1e-8)


def test_hamiltonian_conserved_along_flow():
    # No Carter constant exists — but H = (1/2) g^{mu nu} p_mu p_nu = 0
    # (null condition) must hold along every geodesic of the autodiff
    # flow. Integrate the full 8-D path (geodesic_equations is
    # hook-generic, so JP inherits it) and check H at every step.
    from light_path_tracer_tpu.trajectory import integrate_geodesic_8d
    jp = JohannsenPsaltis(1.0, 0.8, eps3=4.0)
    state8, invalid = jp.initial_conditions_8d(
        R_OBS, jnp.asarray([0.07, 0.12], jnp.float64), 0.8,
        np.radians(75.0))
    assert not bool(np.asarray(invalid).any())
    traj = integrate_geodesic_8d(jp, state8, r_obs=R_OBS,
                                 n_steps=8000, h_base=0.5)
    states = np.asarray(traj.states)  # (S+1, 2, 8)
    n = int(np.asarray(traj.n_valid).min())
    s = states[:n]
    r, th = jnp.asarray(s[..., 1]), jnp.asarray(s[..., 2])
    p_t, p_r = jnp.asarray(s[..., 4]), jnp.asarray(s[..., 5])
    p_th, p_phi = jnp.asarray(s[..., 6]), jnp.asarray(s[..., 7])
    (g_tt, g_tphi, g_rr, g_thth, g_phiphi, *_rest) = jp._inv_terms(r, th)
    H = (g_tt * p_t ** 2 + 2 * g_tphi * p_t * p_phi + g_rr * p_r ** 2
         + g_thth * p_th ** 2 + g_phiphi * p_phi ** 2)
    assert float(jnp.max(jnp.abs(H))) < 1e-7


@pytest.mark.slow
def test_alpha_crit_bisection_and_deformation_ordering():
    # eps3 = 0 must reproduce Kerr's analytic shadow envelope; the
    # deformation shifts it monotonically (eps3 < 0 grows the shadow,
    # eps3 > 0 shrinks it — the JP no-hair-test signature).
    a = 0.9
    ana = Kerr(1.0, a).alpha_crit(R_OBS, np.pi / 2)
    num0 = JohannsenPsaltis(1.0, a, eps3=0.0).alpha_crit(R_OBS, np.pi / 2)
    assert abs(num0 - ana) / ana < 1e-3
    num_m = JohannsenPsaltis(1.0, a, eps3=-3.0).alpha_crit(
        R_OBS, np.pi / 2)
    num_p = JohannsenPsaltis(1.0, a, eps3=3.0).alpha_crit(
        R_OBS, np.pi / 2)
    assert num_m > num0 > num_p
    # The shifts are measurable, not noise (bisection resolves ~1e-5).
    assert num_m - num0 > 1e-3 * num0
    assert num0 - num_p > 1e-3 * num0


@pytest.mark.slow
def test_static_photon_sphere_oracle():
    """a = 0, eps3 != 0: the deformed static metric's critical angle
    from first principles — photon sphere where (C/f)' = 0, critical
    impact parameter b = sqrt(C/f)(r_ph), viewing angle
    arcsin(b sqrt(f(r_obs)) / r_obs) — entirely from the covariant
    metric functions, no tracing."""
    M, eps3 = 1.0, 5.0
    jp = JohannsenPsaltis(M, 0.0, eps3=eps3)

    def f_of(r):
        h = eps3 * M ** 3 / r ** 3  # a=0: Sigma=r^2
        return (1.0 + h) * (1.0 - 2.0 * M / r)

    r = np.linspace(2.2, 8.0, 400001)
    fr = f_of(r)
    C = r ** 2
    # d/dr (C/f) = 0  <=>  C' f - C f' = 0; locate the sign change.
    g = np.gradient(C / fr, r)
    sign = np.sign(g)
    idx = np.nonzero(np.diff(sign) > 0)[0]
    assert idx.size >= 1
    i = int(idx[0])
    r_ph = r[i] - g[i] * (r[i + 1] - r[i]) / (g[i + 1] - g[i])
    b_crit = np.sqrt(r_ph ** 2 / f_of(r_ph))
    alpha_expect = np.arcsin(b_crit * np.sqrt(f_of(R_OBS)) / R_OBS)

    alpha_traced = jp.alpha_crit(R_OBS, np.pi / 2)
    assert abs(alpha_traced - alpha_expect) / alpha_expect < 1e-3


@pytest.mark.slow
def test_shadow_render_and_cli_dispatch():
    from light_path_tracer_tpu.pipeline import render_shadow
    from light_path_tracer_tpu.utils.config import (SceneConfig,
                                                    RenderConfig)
    scene = SceneConfig(M=1.0, a=0.6, eps3=2.0, r_obs_mult=100.0,
                        vertical_fov_deg=16.0)
    img, stats = render_shadow(scene, (40, 40),
                               RenderConfig(dtype="float64",
                                            backend="xla"))
    img = np.asarray(img)
    assert (img == 0).sum() > 10          # a shadow exists
    assert (img == 1).sum() > 800         # most of the frame escapes
    assert stats["integrator_steps"] > 0


def test_make_metric_dispatch_and_exclusions():
    assert isinstance(make_metric(1.0, 0.5, 0.0, 2.0), JohannsenPsaltis)
    assert isinstance(make_metric(1.0, 0.5, 0.0, 0.0), Kerr)
    with pytest.raises(ValueError):
        make_metric(1.0, 0.0, 0.5, 2.0)  # charge + deformation


def test_disk_and_sequence_reject_eps3():
    from light_path_tracer_tpu.disk import _scene_metric
    from light_path_tracer_tpu.utils.config import SceneConfig
    with pytest.raises(ValueError):
        _scene_metric(SceneConfig(M=1.0, a=0.5, eps3=1.0))


@pytest.mark.slow
def test_capture_radius_tracks_the_barrier():
    # eps3 < 0 moves the g^rr pole OUTSIDE Kerr's horizon; the capture
    # surface must clear it (else rays die as NaN instead of
    # capturing). eps3 >= 0 keeps Kerr's 1.01 r_+.
    jp_neg = JohannsenPsaltis(1.0, 0.9, eps3=-3.0)
    k = Kerr(1.0, 0.9)
    assert jp_neg.capture_radius() > 1.2 * k.capture_radius()
    # eps3 > 0: the barrier stays at/inside the horizon region (the
    # Delta < 0 band just below r_+ trips the scan too), so the capture
    # surface stays within a couple percent of Kerr's.
    jp_pos = JohannsenPsaltis(1.0, 0.9, eps3=3.0)
    assert (0.99 * k.capture_radius() <= jp_pos.capture_radius()
            <= 1.05 * k.capture_radius())
    # And captures actually classify as captures at eps3 < 0:
    res = trace_rays_kerr(jp_neg, R_OBS,
                          jnp.asarray([0.01], jnp.float64),
                          jnp.asarray([0.1], jnp.float64), np.pi / 2,
                          jnp.zeros(1, bool), lambda_max=5000.0,
                          max_steps=60000)
    assert int(res.status[0]) == -1


@pytest.mark.slow
def test_alpha_crit_bracket_expands_for_strong_deformation():
    """Strong eps3 < 0 (barrier at r = (-eps3)^(1/3) M = 10M for a=0)
    grows the shadow past the 3x-Schwarzschild initial bisection
    bracket; alpha_crit must EXPAND the upper edge and find it instead
    of silently returning the bracket cap."""
    jp = JohannsenPsaltis(1.0, 0.0, eps3=-1000.0)
    r_obs = 20.0
    hi0 = 3.0 * np.arcsin(min(1.0, 3.0 * np.sqrt(3.0) / r_obs))
    assert jp.capture_radius() > 10.0          # the barrier, not r_+
    ac = jp.alpha_crit(r_obs, np.pi / 2, n_azimuth=8, iters=14,
                       max_steps=30000)
    assert hi0 * 1.1 < ac < np.pi / 2          # beyond the old cap


def test_hand_rhs_matches_autodiff_oracle():
    """Round-4 hand-derived rhs5 vs the jax.grad-of-Hamiltonian form
    (rhs5_autodiff over the same _inv_terms): roundoff-level agreement
    on random states — the same hand-vs-autodiff contract Kerr and
    Kerr-Newman pin."""
    m = JohannsenPsaltis(1.0, 0.7, eps3=2.5)
    rng = np.random.default_rng(0)
    n = 2048
    r = jnp.asarray(rng.uniform(m.capture_radius() * 1.05, 80.0, n))
    th = jnp.asarray(rng.uniform(0.05, np.pi - 0.05, n))
    state = (r, th, jnp.asarray(rng.uniform(-np.pi, np.pi, n)),
             jnp.asarray(rng.normal(0, 1, n)),
             jnp.asarray(rng.normal(0, 3, n)))
    p_phi = jnp.asarray(rng.normal(0, 4, n))
    hand = m.rhs5(state, -1.0, p_phi)
    auto = m.rhs5_autodiff(state, -1.0, p_phi)
    for x, z in zip(hand, auto):
        x, z = np.asarray(x), np.asarray(z)
        rel = np.abs(x - z) / np.maximum(np.abs(z), 1e-12)
        assert rel.max() < 1e-8


def test_hand_rhs_negative_eps3_matches_autodiff():
    """The deformed-barrier regime (eps3 < 0 moves the pathology
    outside r_+): same oracle agreement there."""
    m = JohannsenPsaltis(1.0, 0.5, eps3=-3.0)
    rng = np.random.default_rng(1)
    n = 1024
    r = jnp.asarray(rng.uniform(m.capture_radius() * 1.05, 50.0, n))
    th = jnp.asarray(rng.uniform(0.1, np.pi - 0.1, n))
    state = (r, th, jnp.zeros(n),
             jnp.asarray(rng.normal(0, 1, n)),
             jnp.asarray(rng.normal(0, 3, n)))
    p_phi = jnp.asarray(rng.normal(0, 4, n))
    hand = m.rhs5(state, -1.0, p_phi)
    auto = m.rhs5_autodiff(state, -1.0, p_phi)
    for x, z in zip(hand, auto):
        x, z = np.asarray(x), np.asarray(z)
        rel = np.abs(x - z) / np.maximum(np.abs(z), 1e-12)
        assert rel.max() < 1e-8


@pytest.mark.slow
def test_jp_runs_on_pallas_tile_kernel():
    """JP's hand-derived RHS runs in the fused kernel (interpret mode
    here; tests/test_pallas.py covers the CUDA lowering) and agrees with
    the XLA path."""
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_rays_kerr_pallas)

    m = JohannsenPsaltis(1.0, 0.9, eps3=2.0)
    assert getattr(m, "supports_pallas", True)
    rng = np.random.default_rng(2)
    n = 256
    ac = m.alpha_crit(R_OBS)
    alphas = jnp.asarray(rng.uniform(0.3 * ac, 4 * ac, n), jnp.float32)
    thetas = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float32)
    refine = jnp.zeros(n, bool)
    rp = trace_rays_kerr_pallas(m, R_OBS, alphas, thetas, np.pi / 2,
                                refine, 5000.0, 20000, block=32,
                                interpret=True)
    rx = trace_rays_kerr(m, R_OBS, alphas, thetas, np.pi / 2, refine,
                         5000.0, 20000)
    sp, sx = np.asarray(rp.status), np.asarray(rx.status)
    assert (sp == sx).mean() > 0.99
    both = (sp == 1) & (sx == 1)
    alb = np.asarray(alphas)
    stable = both & (np.abs(alb - ac) > 0.05 * ac)
    d = np.abs(np.asarray(rp.final_alpha)[stable]
               - np.asarray(rx.final_alpha)[stable])
    assert np.percentile(d, 99) < 1e-3
