"""Accretion-disk extension tests: ISCO, redshift physics, rendering."""

import pytest
import numpy as np
import jax.numpy as jnp

from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
from light_path_tracer_tpu.disk import (
    render_disk, DiskConfig, r_isco, keplerian_redshift)


def test_isco_limits():
    assert np.isclose(r_isco(1.0, 0.0), 6.0, atol=1e-12)
    assert np.isclose(r_isco(1.0, 1.0), 1.0, atol=1e-6)
    assert np.isclose(r_isco(1.0, 0.9), 2.3209, atol=1e-3)
    assert np.isclose(r_isco(2.0, 0.0), 12.0, atol=1e-12)  # scales with M
    # Retrograde ISCO is farther out.
    assert np.isclose(r_isco(1.0, 1.0, prograde=False), 9.0, atol=1e-6)


def test_redshift_static_limit():
    """xi = 0, far radius: g -> sqrt(1 - 3M/r)-ish (pure orbital time
    dilation); at large r, g -> 1."""
    g_far = float(keplerian_redshift(1.0, 0.0, jnp.asarray([1e6]),
                                     jnp.asarray([0.0]))[0])
    assert np.isclose(g_far, 1.0, atol=1e-4)
    # Schwarzschild analytic: 1/u^t = sqrt(1 - 3M/r) for circular orbit,
    # so with xi=0, g = sqrt(1 - 3M/r).
    r = 8.0
    g = float(keplerian_redshift(1.0, 0.0, jnp.asarray([r]),
                                 jnp.asarray([0.0]))[0])
    assert np.isclose(g, np.sqrt(1.0 - 3.0 / r), atol=1e-12)


def test_doppler_sign():
    """Approaching side (Omega*xi > 0) is blueshifted, receding is red."""
    r = 10.0
    g_app = float(keplerian_redshift(1.0, 0.9, jnp.asarray([r]),
                                     jnp.asarray([5.0]))[0])
    g_rec = float(keplerian_redshift(1.0, 0.9, jnp.asarray([r]),
                                     jnp.asarray([-5.0]))[0])
    assert g_app > g_rec


@pytest.mark.slow
def test_disk_render_edge_on_asymmetry():
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        vertical_fov_deg=30.0,
                        theta_obs=np.radians(80.0))
    img, stats = render_disk(scene, (48, 64),
                             RenderConfig(dtype="float64"))
    img = np.asarray(img)
    assert stats["disk_pixels"] > 50
    assert stats["captured"] > 0
    assert img.max() <= 1.0 and img.min() >= 0.0
    # Doppler beaming: the two halves differ strongly.
    left, right = img[:, :32].sum(), img[:, 32:].sum()
    hi, lo = max(left, right), min(left, right)
    assert hi / max(lo, 1e-9) > 2.0


@pytest.mark.slow
def test_disk_translucent_more_pixels():
    """Non-opaque disk shows secondary-image crossings -> never fewer
    contributing pixels than the opaque disk."""
    scene = SceneConfig(M=1.0, a=0.5, r_obs_mult=100.0,
                        vertical_fov_deg=30.0,
                        theta_obs=np.radians(75.0))
    _, s_op = render_disk(scene, (32, 48), RenderConfig(dtype="float64"),
                          DiskConfig(opaque=True))
    _, s_tr = render_disk(scene, (32, 48), RenderConfig(dtype="float64"),
                          DiskConfig(opaque=False))
    assert s_tr["disk_pixels"] >= s_op["disk_pixels"]


@pytest.mark.slow
def test_disk_pallas_matches_xla():
    """Fused disk-mode kernel vs the XLA path (interpret mode)."""
    from light_path_tracer_tpu.models import Kerr
    from light_path_tracer_tpu.disk import trace_disk_rays, DiskConfig
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_disk_rays_pallas)
    import jax.numpy as jnp

    m = Kerr(M=1.0, a=0.9)
    rng = np.random.default_rng(21)
    n = 300
    alphas = jnp.asarray(rng.uniform(0.01, 0.12, n), jnp.float32)
    thetas = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float32)
    disk = DiskConfig(opaque=True)

    res_x = trace_disk_rays(
        m, 100.0, alphas, thetas, np.radians(80.0), 5000.0, 20000, disk,
        backend="xla")
    from light_path_tracer_tpu.disk import r_isco
    plane = (float(r_isco(1.0, 0.9)), 20.0, float(np.pi / 2), True)
    res_p = trace_disk_rays_pallas(
        m, 100.0, alphas, thetas, np.radians(80.0), 5000.0, 20000, plane,
        2, block=32, interpret=True)

    n_x, n_p = res_x.n_hits, res_p.n_hits
    assert (np.asarray(n_x) == np.asarray(n_p)).mean() > 0.98
    both = (np.asarray(n_x) > 0) & (np.asarray(n_p) > 0)
    d = np.abs(np.asarray(res_x.r_hits[0])[both]
               - np.asarray(res_p.r_hits[0])[both])
    assert np.median(d) < 1e-4
    np.testing.assert_allclose(np.asarray(res_x.xi), np.asarray(res_p.xi),
                               rtol=1e-6)
    # Escape headings agree on no-hit escaped lanes (the composite
    # renderer's background input).
    fa_x, fa_p = np.asarray(res_x.final_alpha), np.asarray(res_p.final_alpha)
    free = (np.asarray(n_x) == 0) & np.isfinite(fa_x) & np.isfinite(fa_p)
    assert free.sum() > 20
    assert np.median(np.abs(fa_x[free] - fa_p[free])) < 1e-4


def test_blackbody_chromaticity_on_planckian_locus():
    """The Gaussian-fit CMF pipeline lands on the known Planckian locus."""
    from light_path_tracer_tpu.utils.color import blackbody_chromaticity
    # (T, x, y) reference points of the CIE 1931 Planckian locus.
    for T, x_ref, y_ref in [(2000.0, 0.527, 0.413),
                            (6500.0, 0.3135, 0.3237),
                            (10000.0, 0.2806, 0.2883)]:
        x, y = blackbody_chromaticity(T)
        assert abs(x - x_ref) < 0.01 and abs(y - y_ref) < 0.01


def test_blackbody_rgb_monotone_temperature():
    """Hotter blackbody -> bluer: B/R channel ratio rises with T."""
    import numpy as np
    from light_path_tracer_tpu.utils.color import blackbody_rgb
    rgb = np.asarray(blackbody_rgb(
        np.array([2000.0, 4000.0, 8000.0, 16000.0, 32000.0])))
    ratio = rgb[:, 2] / np.maximum(rgb[:, 0], 1e-9)
    assert np.all(np.diff(ratio) > 0)
    assert np.isfinite(rgb).all() and (rgb >= 0).all() and (rgb <= 1).all()


def test_disk_temperature_profile():
    import numpy as np
    import jax.numpy as jnp
    from light_path_tracer_tpu.disk import disk_temperature
    r_in = 6.0
    r = jnp.asarray(np.linspace(6.0, 40.0, 400))
    T = np.asarray(disk_temperature(r, r_in, 9000.0))
    assert abs(T.max() - 9000.0) < 2.0           # normalized peak
    i_peak = T.argmax()
    assert abs(float(r[i_peak]) - 49.0 / 36.0 * r_in) < 0.2
    assert T[0] < 1.0                            # zero-torque inner edge
    assert T[-1] < T[i_peak]                     # outer decline


@pytest.mark.slow
def test_blackbody_disk_render():
    """Color disk: (H, W, 3), finite, approaching-side (Doppler) brighter
    AND bluer than the receding side."""
    import numpy as np
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64")
    img, stats = render_disk(scene, (48, 64), cfg,
                             DiskConfig(spectrum="blackbody"))
    img = np.asarray(img)
    assert img.shape == (48, 64, 3)
    assert np.isfinite(img).all() and img.min() >= 0.0
    assert stats["disk_pixels"] > 0
    left = img[:, :32]; right = img[:, 32:]
    lum_l, lum_r = left.sum(axis=-1).sum(), right.sum(axis=-1).sum()
    bright, dim = (left, right) if lum_l > lum_r else (right, left)
    assert (bright.sum() > 1.2 * dim.sum())      # Doppler beaming
    # Blue fraction higher on the approaching side.
    bf = lambda s: s[..., 2].sum() / max(s.sum(), 1e-9)
    assert bf(bright) > bf(dim)


@pytest.mark.slow
def test_center_column_crossings_after_polar_pass():
    """Regression: the L = 0 center-column rays pass OVER the pole and
    hit the equatorial plane at theta = -pi/2 (double-cover chart); the
    cos(theta)-based detector must catch them — a theta - pi/2 detector
    left a dark one-pixel seam down every disk render."""
    import numpy as np
    import jax.numpy as jnp
    from light_path_tracer_tpu.disk import trace_disk_rays
    from light_path_tracer_tpu.models.kerr import Kerr
    from light_path_tracer_tpu import camera

    dim = (48, 49)                  # odd width: col 24 is exactly central
    m = Kerr(M=1.0, a=0.9)
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    al = camera.build_alpha_lookup(dim, fov, dtype=jnp.float64)
    th = camera.build_theta_lookup(dim, fov, dtype=jnp.float64)
    res = trace_disk_rays(
        m, 100.0, al.ravel(), th.ravel(), np.radians(80.0), 5000.0,
        200000, DiskConfig(), backend="xla")
    nh = np.asarray(res.n_hits).reshape(dim)
    hits_per_col = (nh > 0).sum(axis=0)
    # The central column must see the disk like its neighbors do.
    assert hits_per_col[24] >= 0.8 * hits_per_col[23]
    assert hits_per_col[24] >= 0.8 * hits_per_col[25]


def _starfield(h, w, seed=5):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 0.1, np.float32)
    ys = rng.integers(0, h, h * w // 20)
    xs = rng.integers(0, w, h * w // 20)
    img[ys, xs] = rng.uniform(0.5, 1.0, (len(ys), 3)).astype(np.float32)
    return img


@pytest.mark.slow
def test_composite_empty_disk_matches_plain_lens():
    """A zero-width disk degenerates the composite to the plain lensed
    render (same trace, same renderer semantics)."""
    from light_path_tracer_tpu.disk import render_scene_with_disk
    from light_path_tracer_tpu.pipeline import render_scene

    src = _starfield(40, 56)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64")
    # r_out below r_in -> no in-disk crossing can ever be recorded.
    empty = DiskConfig(r_in=8.0, r_out=7.0)
    comp, stats = render_scene_with_disk(scene, src, cfg, empty)
    assert stats["disk_pixels"] == 0
    plain = render_scene(scene, src, cfg).image
    d = np.abs(np.asarray(comp) - np.asarray(plain))
    # Same geodesics to integrator tolerance; sub-pixel texel flips at
    # strong-deflection boundaries are the only allowed difference.
    assert (d.max(axis=-1) < 1e-6).mean() > 0.98
    assert np.median(d) < 1e-9


@pytest.mark.slow
def test_composite_opaque_blocks_background():
    """Opaque composite: disk-hit pixels show the disk, everything else
    is exactly the no-disk lensed background."""
    from light_path_tracer_tpu.disk import render_scene_with_disk

    src = _starfield(40, 56)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64")
    disk = DiskConfig()
    comp, stats = render_scene_with_disk(scene, src, cfg, disk)
    comp_empty, _ = render_scene_with_disk(
        scene, src, cfg, DiskConfig(r_in=8.0, r_out=7.0))
    assert stats["disk_pixels"] > 50
    assert comp.shape == (40, 56, 3)
    assert np.isfinite(np.asarray(comp)).all()
    # Non-disk pixels are EXACTLY the no-disk lensed background (same
    # geodesics; the disk only occludes).
    from light_path_tracer_tpu.disk import (trace_disk_rays, r_isco,
                                            DiskConfig as DC)
    from light_path_tracer_tpu.models.kerr import Kerr
    from light_path_tracer_tpu import camera as cam
    fov = cam.fov_from_vertical(scene.vertical_fov, (40, 56))
    al = cam.build_alpha_lookup((40, 56), fov, dtype=jnp.float64)
    th = cam.build_theta_lookup((40, 56), fov, dtype=jnp.float64)
    res = trace_disk_rays(Kerr(M=1.0, a=0.9), scene.r_obs, al.ravel(),
                          th.ravel(), scene.theta_obs, 5000.0,
                          cfg.max_steps, disk, backend="xla")
    free = (np.asarray(res.n_hits).reshape(40, 56) == 0)
    d = np.abs(np.asarray(comp) - np.asarray(comp_empty))
    assert (d.max(axis=-1)[free] < 1e-6).mean() > 0.98


@pytest.mark.slow
def test_composite_translucent_is_additive():
    """Translucent composite >= its own background everywhere (emission
    only adds light)."""
    from light_path_tracer_tpu.disk import render_scene_with_disk

    src = _starfield(40, 56)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64")
    disk = DiskConfig(opaque=False)
    comp, stats = render_scene_with_disk(scene, src, cfg, disk)
    empty = DiskConfig(r_in=8.0, r_out=7.0, opaque=False)
    base, _ = render_scene_with_disk(scene, src, cfg, empty)
    assert stats["disk_pixels"] > 50
    assert (np.asarray(comp) >= np.asarray(base) - 1e-6).mean() > 0.99


@pytest.mark.slow
def test_crossing_phi_recorded_and_backends_agree():
    """phi_hits: finite azimuth wherever a crossing is recorded, and the
    Pallas kernel agrees with the XLA path."""
    from light_path_tracer_tpu.models import Kerr
    from light_path_tracer_tpu.disk import (trace_disk_rays, DiskConfig,
                                            r_isco)
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_disk_rays_pallas)
    import jax.numpy as jnp

    m = Kerr(M=1.0, a=0.9)
    rng = np.random.default_rng(23)
    n = 200
    alphas = jnp.asarray(rng.uniform(0.01, 0.12, n), jnp.float32)
    thetas = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float32)
    disk = DiskConfig(opaque=True)
    res_x = trace_disk_rays(m, 100.0, alphas, thetas, np.radians(80.0),
                            5000.0, 20000, disk, backend="xla")
    plane = (float(r_isco(1.0, 0.9)), 20.0, float(np.pi / 2), True)
    res_p = trace_disk_rays_pallas(m, 100.0, alphas, thetas,
                                   np.radians(80.0), 5000.0, 20000,
                                   plane, 2, block=32, interpret=True)
    hit = (np.asarray(res_x.n_hits) > 0) & (np.asarray(res_p.n_hits) > 0)
    assert hit.sum() > 30
    phi_x = np.asarray(res_x.phi_hits[0])[hit]
    phi_p = np.asarray(res_p.phi_hits[0])[hit]
    assert np.isfinite(phi_x).all()
    assert np.median(np.abs(phi_x - phi_p)) < 1e-3


def test_hotspot_orbits_and_is_periodic():
    """One trace, many frames: the hot spot moves between t=0 and T/2
    and returns exactly at t=T (pattern periodicity, shared trace)."""
    from light_path_tracer_tpu.disk import (render_disk_frames, HotSpot,
                                            keplerian_omega)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0), vertical_fov_deg=24.0)
    cfg = RenderConfig(dtype="float64")
    spot = HotSpot(r0=6.0, amplitude=8.0)
    period = 2.0 * np.pi / keplerian_omega(1.0, 0.9, 6.0)
    frames, stats = render_disk_frames(
        scene, (40, 56), [0.0, period / 2.0, period], cfg,
        DiskConfig(), spot)
    frames = np.asarray(frames)
    assert frames.shape[0] == 3 and stats["disk_pixels"] > 50
    assert np.isfinite(frames).all()
    # The spot moved: the half-orbit frame differs measurably...
    assert np.abs(frames[1] - frames[0]).max() > 0.05
    # ...and a full orbit is exactly periodic (same trace, same pattern).
    np.testing.assert_allclose(frames[2], frames[0], atol=1e-12)
    # Raw linear emission rides stats (the centroid-track input): same
    # frame axis, nonnegative, and its photocenter moves with the spot.
    from light_path_tracer_tpu import camera, observables
    emission = np.asarray(stats["emission"])
    assert emission.shape == (3, 40, 56)
    assert (emission >= 0.0).all() and emission[0].max() > 0.0
    fov = camera.fov_from_vertical(scene.vertical_fov, (40, 56))
    track = np.asarray(observables.centroid_track(emission, fov))
    assert np.linalg.norm(track[1] - track[0]) > 1e-6
    np.testing.assert_allclose(track[2], track[0], atol=1e-12)


def test_texture_pattern_differential_shear():
    """A radial stripe painted on the disk winds up: after time t the
    stripe at the inner edge has advanced further in azimuth than at
    the outer edge (Omega(r) decreasing) — sampled directly through
    texture_pattern."""
    import jax.numpy as jnp
    from light_path_tracer_tpu.disk import (texture_pattern,
                                            keplerian_omega)
    n_r, n_phi = 32, 128
    tex = np.ones((n_r, n_phi), np.float32)
    tex[:, :8] = 5.0                     # bright radial stripe at phi~0
    r_in, r_out = 6.0, 20.0
    pat = texture_pattern(tex, r_in, r_out, 1.0, 0.0, shear=True)

    t = 30.0
    phis = jnp.asarray(np.linspace(0.0, 2 * np.pi, 512, endpoint=False))

    def stripe_center(r):
        vals = np.asarray(pat(jnp.full_like(phis, r), phis, t))
        return float(phis[vals.argmax()])

    c_in = stripe_center(6.5)
    c_out = stripe_center(19.0)
    # Expected: stripe sits at Omega(r) * t (mod 2 pi).
    for r, c in [(6.5, c_in), (19.0, c_out)]:
        expect = (float(keplerian_omega(1.0, 0.0, r)) * t) % (2 * np.pi)
        diff = abs((c - expect + np.pi) % (2 * np.pi) - np.pi)
        assert diff < 0.15, (r, c, expect)
    assert c_in != c_out                 # differential, not rigid

    # shear=False rotates rigidly at Omega(r_in): same center everywhere.
    rigid = texture_pattern(tex, r_in, r_out, 1.0, 0.0, shear=False)

    def rigid_center(r):
        vals = np.asarray(rigid(jnp.full_like(phis, r), phis, t))
        return float(phis[vals.argmax()])

    assert abs(rigid_center(6.5) - rigid_center(19.0)) < 0.05


def test_textured_disk_frames_render():
    """render_disk_frames with an image texture: frames differ over time
    (the spiral winds) and stay finite."""
    from light_path_tracer_tpu.disk import (render_disk_frames,
                                            texture_pattern, DiskConfig,
                                            r_isco)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0), vertical_fov_deg=24.0)
    cfg = RenderConfig(dtype="float64")
    rng = np.random.default_rng(9)
    tex = 0.5 + rng.random((16, 64)).astype(np.float32)
    pat = texture_pattern(tex, r_isco(1.0, 0.9), 20.0, 1.0, 0.9)
    frames, stats = render_disk_frames(scene, (40, 56), [0.0, 40.0], cfg,
                                       DiskConfig(), pattern=pat)
    frames = np.asarray(frames)
    assert np.isfinite(frames).all() and stats["disk_pixels"] > 50
    assert np.abs(frames[1] - frames[0]).max() > 0.02


@pytest.mark.slow
def test_retrograde_disk_swaps_doppler_side():
    """Retrograde orbits approach on the opposite limb: the bright
    (beamed) half of the image swaps sides, and r_isco moves out
    (9M at |a|=M vs 1M prograde)."""
    from light_path_tracer_tpu.disk import keplerian_redshift
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        vertical_fov_deg=30.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64")
    img_p, st_p = render_disk(scene, (32, 48), cfg,
                              DiskConfig(prograde=True))
    img_r, st_r = render_disk(scene, (32, 48), cfg,
                              DiskConfig(prograde=False))
    assert st_r["r_isco"] > st_p["r_isco"]
    assert st_r["disk_pixels"] > 0

    def bright_side(im):
        im = np.asarray(im)
        return "L" if im[:, :24].sum() > im[:, 24:].sum() else "R"

    assert bright_side(img_p) != bright_side(img_r)
    # Scalar check: same xi flips its shift sense between the senses.
    g_p = float(keplerian_redshift(1.0, 0.9, jnp.asarray([10.0]),
                                   jnp.asarray([4.0]), True)[0])
    g_r = float(keplerian_redshift(1.0, 0.9, jnp.asarray([10.0]),
                                   jnp.asarray([4.0]), False)[0])
    assert (g_p > 1.0) != (g_r > 1.0) or abs(g_p - g_r) > 0.1


def test_center_column_phi_is_physical_azimuth():
    """Regression (review finding): over-the-pole rays cross the plane
    on the sin(theta) < 0 chart branch where chart-phi is off by pi
    from the physical azimuth. The recorder must store the PHYSICAL
    azimuth, so phi varies continuously across the central column
    instead of jumping by ~pi."""
    import jax.numpy as jnp
    from light_path_tracer_tpu.disk import trace_disk_rays, DiskConfig
    from light_path_tracer_tpu.models.kerr import Kerr
    from light_path_tracer_tpu import camera

    dim = (48, 49)                  # odd width: col 24 is exactly central
    m = Kerr(M=1.0, a=0.9)
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    al = camera.build_alpha_lookup(dim, fov, dtype=jnp.float64)
    th = camera.build_theta_lookup(dim, fov, dtype=jnp.float64)
    res = trace_disk_rays(m, 100.0, al.ravel(), th.ravel(),
                          np.radians(80.0), 5000.0, 200000, DiskConfig(),
                          backend="xla")
    nh = np.asarray(res.n_hits).reshape(dim)
    phi = np.asarray(res.phi_hits[0]).reshape(dim)

    def wrapped(a, b):
        return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)

    rows = np.where((nh[:, 23] > 0) & (nh[:, 24] > 0) & (nh[:, 25] > 0))[0]
    assert len(rows) > 5
    jump_l = wrapped(phi[rows, 24], phi[rows, 23])
    jump_r = wrapped(phi[rows, 24], phi[rows, 25])
    # Continuous to within a few pixel-widths of azimuth; a chart-branch
    # bug makes these ~pi.
    assert np.median(jump_l) < 0.3 and np.median(jump_r) < 0.3
    assert jump_l.max() < 1.0 and jump_r.max() < 1.0


@pytest.mark.slow
def test_tilted_disk_schwarzschild_rotation_equivalence():
    """a=0 oracle: by spherical symmetry, a disk tilted by iota with
    line of nodes at lam=pi/2 (the rotation axis lies in the observer's
    x-z plane) viewed from theta_obs equals the EQUATORIAL disk viewed
    from theta_obs - iota (sign fixed by the R_z(lam) R_x(iota) basis
    convention, disk.disk_basis)."""
    iota = np.radians(12.0)
    theta_obs = np.radians(75.0)
    cfg = RenderConfig(dtype="float64")
    base = dict(M=1.0, a=0.0, r_obs_mult=100.0, vertical_fov_deg=30.0)
    img_tilt, st_t = render_disk(
        SceneConfig(**base, theta_obs=theta_obs), (36, 48), cfg,
        DiskConfig(tilt=iota, tilt_azimuth=np.pi / 2))
    img_rot, st_r = render_disk(
        SceneConfig(**base, theta_obs=theta_obs - iota), (36, 48), cfg,
        DiskConfig())
    assert st_t["disk_pixels"] > 50
    # Same hit geometry up to integrator tolerance: images agree on
    # nearly every pixel (boundary pixels may flip).
    d = np.abs(np.asarray(img_tilt) - np.asarray(img_rot))
    assert (d < 1e-3).mean() > 0.97
    assert np.median(d) < 1e-6
    assert d.max() < 0.05      # residual = boundary pixels, not physics


def test_tilted_kerr_disk_renders():
    """Tilted Kerr disk: finite, nonempty, differs from the equatorial
    render, and tilt=0 reproduces the equatorial path exactly."""
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        vertical_fov_deg=30.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64")
    img_eq, _ = render_disk(scene, (32, 48), cfg, DiskConfig())
    img_eq0, _ = render_disk(scene, (32, 48), cfg, DiskConfig(tilt=0.0))
    np.testing.assert_array_equal(np.asarray(img_eq), np.asarray(img_eq0))
    img_t, st = render_disk(scene, (32, 48), cfg,
                            DiskConfig(tilt=np.radians(20.0)))
    assert st["disk_pixels"] > 50
    assert np.isfinite(np.asarray(img_t)).all()
    assert np.abs(np.asarray(img_t) - np.asarray(img_eq)).max() > 0.05


@pytest.mark.slow
def test_warped_disk_limits_and_renders():
    """Warped disk: warp_radius -> 0 reproduces the flat tilted plane,
    a huge warp_radius reproduces the equatorial disk, and an
    intermediate warp differs from both (the Bardeen-Petterson shape)."""
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        vertical_fov_deg=30.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64")
    tilt = np.radians(25.0)

    img_flat_tilt, _ = render_disk(scene, (32, 48), cfg,
                                   DiskConfig(tilt=tilt))
    img_w0, _ = render_disk(scene, (32, 48), cfg,
                            DiskConfig(tilt=tilt, warp_radius=1e-6))
    d = np.abs(np.asarray(img_w0) - np.asarray(img_flat_tilt))
    assert (d < 1e-3).mean() > 0.99

    img_eq, _ = render_disk(scene, (32, 48), cfg, DiskConfig())
    img_winf, _ = render_disk(scene, (32, 48), cfg,
                              DiskConfig(tilt=tilt, warp_radius=1e5))
    d = np.abs(np.asarray(img_winf) - np.asarray(img_eq))
    assert (d < 1e-2).mean() > 0.95

    img_mid, st = render_disk(scene, (32, 48), cfg,
                              DiskConfig(tilt=tilt, warp_radius=10.0))
    assert st["disk_pixels"] > 50
    assert np.isfinite(np.asarray(img_mid)).all()
    assert np.abs(np.asarray(img_mid) - np.asarray(img_flat_tilt)).max() > 0.03
    assert np.abs(np.asarray(img_mid) - np.asarray(img_eq)).max() > 0.03


@pytest.mark.slow
def test_composite_aa_stacked_matches_loop():
    """The stacked-pass composite AA (one compiled trace kernel, all
    offsets) must reproduce the per-offset loop path exactly — same
    per-pass tone-map peaks, display-space average, mask union."""
    from light_path_tracer_tpu.disk import render_scene_with_disk_aa

    src = _starfield(32, 40)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64", backend="xla")
    disk = DiskConfig(r_out=15.0)
    img_s, st_s = render_scene_with_disk_aa(
        scene, src, cfg, disk, aa_samples=2, stacked=True)
    img_l, st_l = render_scene_with_disk_aa(
        scene, src, cfg, disk, aa_samples=2, stacked=False)
    assert np.allclose(np.asarray(img_s), np.asarray(img_l), atol=1e-6)
    assert np.array_equal(st_s["disk_mask"], st_l["disk_mask"])
    assert st_s["captured"] == st_l["captured"]
    # The stacked path traces all offsets in ONE dispatch when they fit
    # (disk.py), so its lock-step iteration count is at most the sum of
    # the loop path's per-offset dispatches.
    assert st_s["integrator_steps"] <= st_l["integrator_steps"]
    assert st_s["total_rays"] == st_l["total_rays"]


@pytest.mark.slow
def test_composite_aa_stacked_blackbody_encode_matches_loop():
    """Stacked == loop with the blackbody spectrum + per-pass display
    encoding (the CLI quality path) and a translucent disk."""
    from light_path_tracer_tpu.disk import render_scene_with_disk_aa

    src = _starfield(24, 32)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64", backend="xla")
    disk = DiskConfig(r_out=12.0, spectrum="blackbody", opaque=False)
    img_s, st_s = render_scene_with_disk_aa(
        scene, src, cfg, disk, aa_samples=2, display_encode=True,
        stacked=True)
    img_l, st_l = render_scene_with_disk_aa(
        scene, src, cfg, disk, aa_samples=2, display_encode=True,
        stacked=False)
    assert np.allclose(np.asarray(img_s), np.asarray(img_l), atol=1e-6)
    assert st_s["display_encoded"] and st_l["display_encoded"]
    assert np.array_equal(st_s["disk_mask"], st_l["disk_mask"])


@pytest.mark.slow
def test_disk_integrator_config_plumbed():
    """RenderConfig.integrator reaches the disk tracer: dop853 runs and
    agrees with dp45; the fixed-step rk4 comparison path (no crossing
    recorder) raises instead of being silently ignored."""
    import pytest
    from light_path_tracer_tpu.disk import render_disk

    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    img45, st45 = render_disk(
        scene, (24, 32), RenderConfig(dtype="float64", backend="xla"))
    img853, st853 = render_disk(
        scene, (24, 32), RenderConfig(dtype="float64", backend="xla",
                                      integrator="dop853"))
    assert st853["disk_pixels"] == st45["disk_pixels"]
    d = np.abs(np.asarray(img853) - np.asarray(img45))
    # Same physics at each integrator's own tolerance; the asinh tone
    # map normalizes to each frame's own peak, so allow small global
    # drift and a few crossing-radius-sensitive pixels.
    assert np.median(d) < 1e-3
    assert (d < 1e-2).mean() > 0.97, d.max()
    # Different integrator actually ran: the step counts differ.
    assert st853["integrator_steps"] != st45["integrator_steps"]
    with pytest.raises(ValueError, match="dp45.*dop853|integrator"):
        render_disk(scene, (24, 32),
                    RenderConfig(dtype="float64", backend="xla",
                                 integrator="rk4"))


def test_disk_frames_accepts_generator_times():
    """A generator `times` argument is materialized once — frames AND
    stats see all of it (regression: stats used to re-iterate it)."""
    from light_path_tracer_tpu.disk import render_disk_frames

    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    frames, stats = render_disk_frames(
        scene, (16, 24), (t for t in [0.0, 25.0, 50.0]),
        RenderConfig(dtype="float64", backend="xla"))
    assert frames.shape[0] == 3
    assert stats["n_frames"] == 3


def test_multi_disk_single_plane_limit():
    """render_multi_disk([d]) reproduces render_disk(d) exactly (same
    trace, same emission path)."""
    from light_path_tracer_tpu.disk import render_multi_disk

    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64", backend="xla")
    img1, st1 = render_disk(scene, (32, 48), cfg, DiskConfig())
    imgM, stM = render_multi_disk(scene, (32, 48), cfg, [DiskConfig()])
    assert np.array_equal(np.asarray(img1), np.asarray(imgM))
    assert stM["disk_pixels"] == st1["disk_pixels"]
    assert stM["n_disks"] == 1


@pytest.mark.slow
def test_multi_disk_two_planes_equatorial_plus_tilted():
    """Equatorial inner disk + tilted translucent outer ring in ONE
    trace: both planes record pixels; the second plane's empty limit
    (r_out < r_in) degenerates to the single-disk image."""
    from light_path_tracer_tpu.disk import render_multi_disk

    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64", backend="xla")
    inner = DiskConfig(r_out=10.0)
    ring = DiskConfig(r_in=12.0, r_out=20.0, tilt=np.radians(25.0),
                      opaque=False)
    img2, st2 = render_multi_disk(scene, (32, 48), cfg, [inner, ring])
    assert st2["n_disks"] == 2
    n_inner, n_ring = st2["disk_pixels_per_plane"]
    assert n_inner > 10 and n_ring > 10
    assert st2["disk_pixels"] <= n_inner + n_ring
    assert np.isfinite(np.asarray(img2)).all()

    # Empty second plane -> the two-plane path equals the single-plane
    # image (the extra sign track records nothing).
    empty = DiskConfig(r_in=8.0, r_out=7.0, opaque=False)
    img_e, st_e = render_multi_disk(scene, (32, 48), cfg,
                                    [inner, empty])
    img_1, _ = render_multi_disk(scene, (32, 48), cfg, [inner])
    assert st_e["disk_pixels_per_plane"][1] == 0
    assert np.allclose(np.asarray(img_e), np.asarray(img_1), atol=1e-12)


@pytest.mark.slow
def test_multi_disk_opaque_occludes_second_plane():
    """An opaque near disk terminates rays, so a translucent far plane
    records FEWER crossings than when traced alone (occlusion via the
    shared trace)."""
    from light_path_tracer_tpu.disk import render_multi_disk

    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64", backend="xla")
    near = DiskConfig(r_out=15.0, opaque=True)
    far = DiskConfig(r_in=3.0, r_out=15.0, tilt=np.radians(40.0),
                     opaque=False)
    _img, st_both = render_multi_disk(scene, (32, 48), cfg, [near, far])
    _img2, st_alone = render_multi_disk(scene, (32, 48), cfg, [far])
    blocked = st_both["disk_pixels_per_plane"][1]
    alone = st_alone["disk_pixels_per_plane"][0]
    assert blocked < alone, (blocked, alone)


def test_multi_disk_validates_mixed_spectra():
    import pytest
    from light_path_tracer_tpu.disk import render_multi_disk

    scene = SceneConfig(M=1.0, a=0.9)
    with pytest.raises(ValueError, match="spectrum"):
        render_multi_disk(scene, (8, 8), RenderConfig(dtype="float64"),
                          [DiskConfig(), DiskConfig(spectrum="blackbody")])


@pytest.mark.slow
def test_disk_pallas_accepts_precision_and_method():
    """Regression: precision/method reach the Pallas disk kernel as
    STATIC jit args (a plain string arg raised TypeError in r3)."""
    from light_path_tracer_tpu.models import Kerr
    from light_path_tracer_tpu.disk import r_isco
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_disk_rays_pallas)

    m = Kerr(M=1.0, a=0.9)
    alphas = jnp.asarray(np.linspace(0.02, 0.1, 16), jnp.float32)
    thetas = jnp.asarray(np.linspace(-2.0, 2.0, 16), jnp.float32)
    plane = (float(r_isco(1.0, 0.9)), 20.0, float(np.pi / 2), True)
    res = trace_disk_rays_pallas(
        m, 100.0, alphas, thetas, np.radians(80.0), 5000.0, 5000, plane,
        2, block=32, interpret=True, precision="precise",
        method="dp45")
    assert int(np.asarray(res.n_steps)) > 0


@pytest.mark.slow
def test_crossing_momentum_null_condition_and_backends_agree():
    """pr_hits/pth_hits: the recorded crossing momentum, with the
    conserved (p_t=-1, p_phi), satisfies the null condition
    g^{munu} p_mu p_nu = 0 at the equatorial crossing point — a strong
    check that the Hermite-localized state is a consistent photon
    state, not just a radius. Pallas agrees with XLA."""
    from light_path_tracer_tpu.models import Kerr
    from light_path_tracer_tpu.disk import (trace_disk_rays, DiskConfig,
                                            r_isco)
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_disk_rays_pallas)

    M, a = 1.0, 0.9
    m = Kerr(M=M, a=a)
    rng = np.random.default_rng(31)
    n = 200
    alphas = jnp.asarray(rng.uniform(0.01, 0.12, n), jnp.float64)
    thetas = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float64)
    disk = DiskConfig(opaque=True)
    res = trace_disk_rays(m, 100.0, alphas, thetas, np.radians(80.0),
                          5000.0, 20000, disk, backend="xla",
                          record_momentum=True)
    hit = np.asarray(res.n_hits) > 0
    assert hit.sum() > 30
    r_c = np.asarray(res.r_hits[0])[hit]
    p_r = np.asarray(res.pr_hits[0])[hit]
    p_th = np.asarray(res.pth_hits[0])[hit]
    L = np.asarray(res.xi)[hit]          # p_phi (E = 1)

    # Kerr inverse metric at theta = pi/2 (Sigma = r^2).
    delta = r_c ** 2 - 2 * M * r_c + a ** 2
    big_a = (r_c ** 2 + a ** 2) ** 2 - a ** 2 * delta
    g_tt = -big_a / (r_c ** 2 * delta)
    g_tphi = -2 * M * a * r_c / (r_c ** 2 * delta)
    g_phiphi = (delta - a ** 2) / (r_c ** 2 * delta)
    g_rr = delta / r_c ** 2
    g_thth = 1.0 / r_c ** 2
    null = (g_tt * 1.0 - 2 * g_tphi * L + g_phiphi * L ** 2
            + g_rr * p_r ** 2 + g_thth * p_th ** 2)
    # Normalize by the energy-scale term to make it a relative error.
    # The crossing state is Hermite-interpolated WITHIN an accepted
    # step, so the null violation is bounded by the interpolation
    # error at "fast" tolerances (~1e-5 relative), not roundoff.
    rel = np.abs(null) / np.abs(g_tt)
    assert np.median(rel) < 5e-5
    assert np.quantile(rel, 0.95) < 5e-3

    # Backends agree on the recorded momenta.
    plane = (float(r_isco(M, a)), 20.0, float(np.pi / 2), True)
    res_p = trace_disk_rays_pallas(
        m, 100.0, alphas.astype(jnp.float32),
        thetas.astype(jnp.float32), np.radians(80.0), 5000.0, 20000,
        plane, 2, block=32, interpret=True, record_momentum=True)
    both = hit & (np.asarray(res_p.n_hits) > 0)
    d_pr = np.abs(np.asarray(res_p.pr_hits[0])[both]
                  - np.asarray(res.pr_hits[0])[both])
    d_pth = np.abs(np.asarray(res_p.pth_hits[0])[both]
                   - np.asarray(res.pth_hits[0])[both])
    # f32 Pallas vs f64 XLA: agreement is bounded by the f32
    # integration error on p (O(1) quantities), not by the recorder.
    assert np.median(d_pr) < 2e-2
    assert np.median(d_pth) < 2e-2
