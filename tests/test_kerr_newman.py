"""Kerr-Newman (charged + rotating) tests — the fourth metric family.

The decisive oracle: KerrNewman inherits Kerr's hand-derived rhs5 /
rhs5_mu with the charge folded in through the static _q2 branch, and
KerrNewman.rhs5_autodiff builds the SAME Hamilton's equations from
jax.grad of the Hamiltonian — at every (a, Q) the two must agree to
roundoff on random states, which validates the hand-derived charge
terms end to end (and at Q = 0 the hand form must be exactly Kerr's).
At a = 0, traced escape angles must match the INDEPENDENT
Reissner-Nordstrom orbit-equation path (different state space,
different integrator)."""

import numpy as np
import jax.numpy as jnp
import pytest

from light_path_tracer_tpu.models import (
    Kerr, KerrNewman, ReissnerNordstrom, make_metric)
from light_path_tracer_tpu.ops.batch import trace_batch


def _rand_state(n, seed):
    rng = np.random.default_rng(seed)
    state = (jnp.asarray(rng.uniform(2.5, 80.0, n)),
             jnp.asarray(rng.uniform(0.2, np.pi - 0.2, n)),
             jnp.asarray(rng.uniform(-np.pi, np.pi, n)),
             jnp.asarray(rng.uniform(-1.0, 1.0, n)),
             jnp.asarray(rng.uniform(-6.0, 6.0, n)))
    p_t = jnp.full((n,), -1.0)
    p_phi = jnp.asarray(rng.uniform(-6.0, 6.0, n))
    return state, p_t, p_phi


def test_hand_form_is_exactly_kerr_at_q0():
    """Q = 0 must take the q2-free static branch: bitwise Kerr."""
    kn = KerrNewman(M=1.0, a=0.9, Q=0.0)
    k = Kerr(M=1.0, a=0.9)
    state, p_t, p_phi = _rand_state(256, 5)
    for d_kn, d_k in zip(kn.rhs5(state, p_t, p_phi),
                         k.rhs5(state, p_t, p_phi)):
        assert (np.asarray(d_kn) == np.asarray(d_k)).all()


@pytest.mark.parametrize("a,q", [(0.9, 0.0), (0.6, 0.5), (0.0, 0.8),
                                 (0.3, 0.9)])
def test_rhs_hand_form_matches_autodiff(a, q):
    """The decisive oracle: hand-derived charge terms vs jax.grad of
    the Hamiltonian, at every corner of the (a, Q) space."""
    kn = KerrNewman(M=1.0, a=a, Q=q)
    state, p_t, p_phi = _rand_state(256, 7)
    out_hand = kn.rhs5(state, p_t, p_phi)
    out_ad = kn.rhs5_autodiff(state, p_t, p_phi)
    for d_h, d_a in zip(out_hand, out_ad):
        np.testing.assert_allclose(np.asarray(d_h), np.asarray(d_a),
                                   rtol=2e-12, atol=1e-12)


def test_rhs5_mu_matches_theta_form():
    """The transcendental-free mu formulation agrees with the theta
    form after the canonical transformation, at Q != 0."""
    kn = KerrNewman(M=1.0, a=0.6, Q=0.6)
    state, p_t, p_phi = _rand_state(128, 9)
    r, th, phi, p_r, p_th = state
    y_mu = kn.state_to_mu(state)
    d_th = kn.rhs5(state, p_t, p_phi)
    d_mu = kn.rhs5_mu(y_mu, p_t, p_phi)
    # dr, dphi, dp_r transform trivially; dmu = -sin(th) * dtheta.
    np.testing.assert_allclose(np.asarray(d_mu[0]), np.asarray(d_th[0]),
                               rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(d_mu[1]), -np.sin(np.asarray(th)) * np.asarray(d_th[1]),
        rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d_mu[2]), np.asarray(d_th[2]),
                               rtol=1e-10)


def test_closed_forms_and_limits():
    kn = KerrNewman(M=1.0, a=0.6, Q=0.5)
    assert np.isclose(kn.r_plus,
                      1.0 + np.sqrt(1 - 0.36 - 0.25), rtol=1e-12)
    # xi/eta general-Delta form reduces to Kerr's Bardeen expressions.
    k = Kerr(M=1.0, a=0.6)
    kn0 = KerrNewman(M=1.0, a=0.6, Q=0.0)
    for r in np.linspace(2.1, 4.0, 7):
        xi_g, eta_g = kn0._xi_eta(r)
        xi_b, eta_b = k._xi_eta(r)
        assert np.isclose(xi_g, xi_b, rtol=1e-12)
        assert np.isclose(eta_g, eta_b, rtol=1e-10)
    # Photon-orbit band reduces to Bardeen's radii at Q=0.
    np.testing.assert_allclose(kn0.unstable_photon_radii(),
                               k.unstable_photon_radii(), rtol=1e-8)
    with pytest.raises(ValueError, match="naked"):
        KerrNewman(M=1.0, a=0.8, Q=0.7)


def test_charge_shrinks_kerr_shadow():
    crits = [KerrNewman(M=1.0, a=0.6, Q=q).alpha_crit(100.0)
             for q in (0.0, 0.3, 0.6, 0.79)]
    assert all(c1 > c2 for c1, c2 in zip(crits, crits[1:]))
    assert np.isclose(crits[0], Kerr(M=1.0, a=0.6).alpha_crit(100.0),
                      rtol=1e-9)


def test_a_zero_matches_reissner_nordstrom_orbit_path():
    """KN(a=0, Q) 5-D Hamiltonian trace vs RN's reduced orbit-equation
    trace: independent formulations of the same geodesics."""
    kn = KerrNewman(M=1.0, a=0.0, Q=0.8)
    rn = ReissnerNordstrom(M=1.0, Q=0.8)
    assert np.isclose(kn.alpha_crit(100.0), rn.alpha_crit(100.0),
                      rtol=1e-10)
    a_crit = rn.alpha_crit(100.0)
    alphas = jnp.asarray(np.linspace(1.2, 3.0, 9) * a_crit,
                         jnp.float64)
    # Equatorial-plane rays (screen azimuth pi/2): the 5-D path's
    # winding counts BL phi, which only matches the orbit path's
    # in-plane |phi|/pi when the orbit plane IS the phi-plane
    # (reference-parity convention, metrics.py:363-416).
    res_kn = trace_batch(kn, 100.0, alphas,
                         jnp.full_like(alphas, np.pi / 2),
                         backend="xla")
    res_rn = trace_batch(rn, 100.0, alphas)
    ok = (np.asarray(res_kn.status) == 1) & (np.asarray(res_rn.status)
                                             == 1)
    assert ok.sum() >= 7
    d = np.abs(np.asarray(res_kn.final_alpha)[ok]
               - np.asarray(res_rn.final_alpha)[ok])
    # Two different integrators (adaptive 5-D DP45 vs fixed-step 2-D
    # orbit RK4) at their default tolerances.
    assert np.median(d) < 2e-4, d
    # Winding counts agree too.
    assert (np.asarray(res_kn.n_half_orbits)[ok]
            == np.asarray(res_rn.n_half_orbits)[ok]).all()


@pytest.mark.slow
def test_kn_trace_q0_matches_kerr():
    """Q = 0 KN traces match Kerr's XLA path closely (same dynamics,
    autodiff vs hand RHS — bitwise-identical derivatives up to op
    order)."""
    kn = KerrNewman(M=1.0, a=0.9, Q=0.0)
    k = Kerr(M=1.0, a=0.9)
    rng = np.random.default_rng(11)
    n = 64
    alphas = jnp.asarray(rng.uniform(0.02, 0.1, n), jnp.float64)
    thetas = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float64)
    r_kn = trace_batch(kn, 100.0, alphas, thetas, backend="xla")
    r_k = trace_batch(k, 100.0, alphas, thetas, backend="xla")
    same = np.asarray(r_kn.status) == np.asarray(r_k.status)
    assert same.mean() > 0.98
    esc = same & (np.asarray(r_k.status) == 1)
    d = np.abs(np.asarray(r_kn.final_alpha)[esc]
               - np.asarray(r_k.final_alpha)[esc])
    assert np.median(d) < 1e-8


@pytest.mark.slow
def test_kn_pallas_matches_xla():
    """The metric-generic Pallas tile kernel (interpret mode on CPU)
    agrees with the XLA path for Kerr-Newman."""
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_rays_kerr_pallas)
    kn = KerrNewman(M=1.0, a=0.6, Q=0.6)
    ac = kn.alpha_crit(100.0)
    rng = np.random.default_rng(3)
    n = 256
    alphas = jnp.asarray(rng.uniform(0.3 * ac, 4 * ac, n), jnp.float32)
    thetas = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float32)
    refine = jnp.zeros(n, bool)
    rp = trace_rays_kerr_pallas(kn, 100.0, alphas, thetas, np.pi / 2,
                                refine, 5000.0, 5000, block=32,
                                interpret=True)
    rx = trace_rays_kerr(kn, 100.0, alphas, thetas, np.pi / 2,
                         refine, 5000.0, 5000)
    sp, sx = np.asarray(rp.status), np.asarray(rx.status)
    assert (sp == sx).mean() > 0.99
    both = (sp == 1) & (sx == 1)
    stable = both & (np.abs(np.asarray(alphas) - ac) > 0.05 * ac)
    d = np.abs(np.asarray(rp.final_alpha)[stable]
               - np.asarray(rx.final_alpha)[stable])
    assert np.percentile(d, 99) < 1e-3


def test_extremal_corner_alpha_crit():
    """a^2 + Q^2 = M^2 (degenerate horizon): Delta has a double root
    and the expanded r^2 - 2Mr + a^2 + Q^2 loses every significant
    digit at the prograde band edge r - r_+ ~ 1e-9 — the factored
    (r - r_+)(r - r_-) form keeps eta (hence b_crit) finite and
    correct. Regression for a bug that inflated alpha_crit ~4x."""
    ac_kn = KerrNewman(M=1.0, a=0.6, Q=0.8).alpha_crit(100.0)
    ac_rn_ext = KerrNewman(M=1.0, a=0.0, Q=1.0).alpha_crit(100.0)
    ac_kerr_ext = Kerr(M=1.0, a=1.0).alpha_crit(100.0)
    # The mixed extremal corner sits between the two pure extremals.
    assert ac_rn_ext < ac_kn < ac_kerr_ext
    # And traces classify consistently around it: alpha_crit is the
    # envelope (maximum over the D-shaped rim), so capture is only
    # guaranteed well below the NARROW (prograde) side — extremal
    # prograde b = 2M -> alpha ~ 1.15 deg at r_obs = 100 — while
    # anything above the envelope escapes on every side.
    kn = KerrNewman(M=1.0, a=0.6, Q=0.8)
    alphas = jnp.asarray([0.2 * ac_kn, 0.2 * ac_kn,
                          1.5 * ac_kn, 1.5 * ac_kn], jnp.float64)
    thetas = jnp.asarray([np.pi / 2, -np.pi / 2,
                          np.pi / 2, -np.pi / 2], jnp.float64)
    res = trace_batch(kn, 100.0, alphas, thetas, backend="xla")
    st = np.asarray(res.status)
    assert (st[:2] == -1).all() and (st[2:] == 1).all()


def test_charged_isco():
    """Numeric E(r)-minimization ISCO vs independent oracles: the BPT
    closed form at Q=0, the Reissner-Nordstrom ISCO cubic
    M r^3 - 6 M^2 r^2 + 9 M Q^2 r - 4 Q^4 = 0, the known extremal-RN
    value 4M, and charge monotonicity."""
    from light_path_tracer_tpu.disk import r_isco
    # The numeric path reduces to BPT (different algorithm).
    for a in (0.0, 0.5, 0.9):
        assert np.isclose(r_isco(1.0, a, Q=1e-15), r_isco(1.0, a),
                          rtol=1e-7)
    # Independent RN cubic.
    for q in (0.3, 0.5, 0.8, 0.9):
        r = r_isco(1.0, 0.0, Q=q)
        assert abs(r**3 - 6*r**2 + 9*q*q*r - 4*q**4) < 1e-4
    assert np.isclose(r_isco(1.0, 0.0, Q=0.999999), 4.0, atol=1e-4)
    for pro in (True, False):
        vals = [r_isco(1.0, 0.6, prograde=pro, Q=q)
                for q in (0.0, 0.3, 0.6, 0.79)]
        assert all(v1 > v2 for v1, v2 in zip(vals, vals[1:]))


def test_charged_keplerian_omega_and_redshift():
    from light_path_tracer_tpu.disk import (keplerian_omega,
                                            keplerian_redshift)
    r = jnp.asarray([4.0, 6.0, 10.0, 30.0])
    # Q -> 0 continuity (static branch, so compare small-Q vs 0).
    om0 = keplerian_omega(1.0, 0.6, r)
    om_eps = keplerian_omega(1.0, 0.6, r, Q=1e-8)
    np.testing.assert_allclose(np.asarray(om0), np.asarray(om_eps),
                               rtol=1e-9)
    # Charge weakens gravity: |Omega| decreases with Q at fixed r.
    om_q = keplerian_omega(1.0, 0.6, r, Q=0.7)
    assert (np.abs(np.asarray(om_q)) < np.abs(np.asarray(om0))).all()
    # Redshift: face-on (xi = 0) distant emitter -> g -> 1.
    g_far = keplerian_redshift(1.0, 0.3, jnp.asarray([1e5]),
                               jnp.asarray([0.0]), Q=0.6)
    assert np.isclose(float(g_far[0]), 1.0, atol=1e-4)
    # Gravitational redshift stronger closer in (face-on).
    g = np.asarray(keplerian_redshift(1.0, 0.3, r, jnp.zeros(4),
                                      Q=0.6))
    assert (np.diff(g) > 0).all() and (g < 1.0).all()


@pytest.mark.slow
def test_charged_disk_render():
    """End-to-end accretion disk around a charged BH, both a=0 (RN
    geometry) and a!=0 (KN); the Q->0 limit matches the Kerr render."""
    from light_path_tracer_tpu.disk import render_disk, DiskConfig
    from light_path_tracer_tpu.utils.config import (SceneConfig,
                                                    RenderConfig)
    cfg = RenderConfig(dtype="float64", backend="xla")
    disk = DiskConfig(r_out=15.0)
    res = (32, 32)
    img_kerr, stats_kerr = render_disk(
        SceneConfig(M=1.0, a=0.6, theta_obs=np.radians(75.0)), res, cfg,
        disk)
    img_q0, _ = render_disk(
        SceneConfig(M=1.0, a=0.6, Q=0.0, theta_obs=np.radians(75.0)),
        res, cfg, disk)
    np.testing.assert_array_equal(np.asarray(img_kerr),
                                  np.asarray(img_q0))
    img_kn, stats_kn = render_disk(
        SceneConfig(M=1.0, a=0.6, Q=0.7, theta_obs=np.radians(75.0)),
        res, cfg, disk)
    assert np.isfinite(np.asarray(img_kn)).all()
    assert float(np.asarray(img_kn).max()) > 0.0
    # Charged inner edge sits closer in.
    assert stats_kn["r_isco"] < stats_kerr["r_isco"]
    img_rn, _ = render_disk(
        SceneConfig(M=1.0, a=0.0, Q=0.8, theta_obs=np.radians(75.0)),
        res, cfg, disk)
    assert np.isfinite(np.asarray(img_rn)).all()
    assert float(np.asarray(img_rn).max()) > 0.0


@pytest.mark.slow
def test_kn_plunge_early_exit_is_pure_optimization():
    """Certain-capture early exit (general-Delta photon band) must not
    change any outcome or any escaped ray's heading vs a no-plunge
    trace."""
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr

    class _NoPlunge(KerrNewman):
        def plunge_radii(self, r_obs, alphas, thetas, theta_obs):
            return jnp.zeros_like(alphas)

    kn = KerrNewman(M=1.0, a=0.6, Q=0.6)
    assert float(kn.plunge_radii(
        100.0, jnp.asarray([0.01]), jnp.asarray([0.0]),
        np.pi / 2)[0]) > 0.0
    np_kn = _NoPlunge(M=1.0, a=0.6, Q=0.6)
    ac = kn.alpha_crit(100.0)
    rng = np.random.default_rng(17)
    n = 256
    alphas = jnp.asarray(rng.uniform(0.1 * ac, 3 * ac, n), jnp.float64)
    thetas = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float64)
    refine = jnp.zeros(n, bool)
    r1 = trace_rays_kerr(kn, 100.0, alphas, thetas, np.pi / 2, refine,
                         5000.0, 20000)
    r2 = trace_rays_kerr(np_kn, 100.0, alphas, thetas, np.pi / 2,
                         refine, 5000.0, 20000)
    np.testing.assert_array_equal(np.asarray(r1.status),
                                  np.asarray(r2.status))
    esc = np.asarray(r1.status) == 1
    np.testing.assert_allclose(np.asarray(r1.final_alpha)[esc],
                               np.asarray(r2.final_alpha)[esc],
                               rtol=0, atol=1e-12)
    cap = np.asarray(r1.status) == -1
    assert cap.any()
    # And it actually fires: on an all-captured batch the lock-step
    # loop finishes in strictly fewer iterations (rays park at
    # ~0.999 r_prograde instead of grinding down to 1.01 r_plus).
    # (In the mixed batch above, escaping grazers can set the loop
    # length, hiding the win.)
    deep = jnp.asarray(np.full(64, 0.2 * ac), jnp.float64)
    th_d = jnp.asarray(np.linspace(-np.pi, np.pi, 64), jnp.float64)
    rd1 = trace_rays_kerr(kn, 100.0, deep, th_d, np.pi / 2,
                          jnp.zeros(64, bool), 5000.0, 20000)
    rd2 = trace_rays_kerr(np_kn, 100.0, deep, th_d, np.pi / 2,
                          jnp.zeros(64, bool), 5000.0, 20000)
    assert (np.asarray(rd1.status) == -1).all()
    np.testing.assert_array_equal(np.asarray(rd1.status),
                                  np.asarray(rd2.status))
    assert int(rd1.n_steps) < int(rd2.n_steps)


def test_polarization_rejects_charge():
    from light_path_tracer_tpu.polarization import render_polarization
    from light_path_tracer_tpu.utils.config import SceneConfig
    with pytest.raises(ValueError, match="Kerr"):
        render_polarization(SceneConfig(M=1.0, a=0.5, Q=0.5), (8, 8))


@pytest.mark.slow
def test_kn_shadow_end_to_end():
    """make_metric dispatch + pipeline shadow: the KN shadow sits
    between the same-spin Kerr (larger) and nothing."""
    from light_path_tracer_tpu.pipeline import render_shadow
    from light_path_tracer_tpu.utils.config import (SceneConfig,
                                                    RenderConfig)
    cfg = RenderConfig(dtype="float64", backend="xla")
    img_k, _ = render_shadow(SceneConfig(M=1.0, a=0.6), (40, 40), cfg)
    img_kn, _ = render_shadow(SceneConfig(M=1.0, a=0.6, Q=0.7),
                              (40, 40), cfg)
    dark_k = int((np.asarray(img_k) < 0.5).sum())
    dark_kn = int((np.asarray(img_kn) < 0.5).sum())
    assert 0 < dark_kn < dark_k
