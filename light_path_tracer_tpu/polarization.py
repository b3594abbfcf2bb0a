"""Polarized disk images via the Walker-Penrose constant.

Kerr admits a conserved complex quantity along null geodesics
(Walker & Penrose 1970; Chandrasekhar MTBH section 60): for a photon
with tangent k^mu and any vector f^mu that is orthogonal to k and
parallel-transported,

    kappa = (A - iB) (r - i a cos theta),
    A = (k^t f^r - k^r f^t) + a sin^2(theta) (k^r f^phi - k^phi f^r)
    B = sin(theta) [ (r^2 + a^2)(k^phi f^theta - k^theta f^phi)
                     - a (k^t f^theta - k^theta f^t) ]

is constant. This turns polarization transport into ALGEBRA at the two
endpoints — no extra integration: the disk trace already records each
crossing's full photon state (DiskTraceResult.pr_hits/pth_hits + the
conserved E, L), so the emitted polarization's kappa is evaluated at
the emission radius, and the observed polarization direction follows
by inverting kappa at the camera.

Emission model (the standard synchrotron construction, cf. the EHT
equatorial-model papers): the fluid is a Keplerian circular orbiter at
the crossing radius carrying a magnetic field of configurable
geometry (vertical / toroidal / radial unit field); the emitted
polarization 4-vector is the Levi-Civita contraction

    f^mu ~ eps^{mu nu rho sigma} u_nu k_rho b_sigma,

which is automatically orthogonal to k and u (antisymmetry), and whose
norm carries the synchrotron pitch-angle factor: |f| = omega_fluid *
|b_perp| * sin(xi), with xi the angle between k and b in the fluid
frame — so the polarized intensity weight sin^2(xi) falls out of the
same contraction.

Observer side: kappa is LINEAR in f and kappa(k) = 0, so the gauge
freedom f -> f + lambda k is invisible to it. The arriving photon's
momentum at the camera is known analytically (the trace's own initial
conditions); building the two screen-transverse unit vectors e1 (the
theta-hat direction projected perpendicular to the arrival direction)
and e2 (phi-hat likewise), the observed components (x, y) solve the
real 2x2 system  x kappa(e1) + y kappa(e2) = kappa_emitted.  EVPA is
then atan2(-x, y) measured from the image +x axis: e2 (phi-hat) maps
to image -x for an equatorial observer of our camera convention
(+x right, +y down, verified by the weak-field limit test: a toroidal
field must give image-radial ticks far from the hole, where E = k x B
is coordinate-radial).

The reference has no polarization surface; this is new physics on top
of SURVEY section 7's disk extension, enabled by the crossing-state
recorder.
"""

from __future__ import annotations

import itertools

import numpy as np
import jax.numpy as jnp

from light_path_tracer_tpu import camera
from light_path_tracer_tpu.disk import (
    DiskConfig, trace_disk_rays, disk_emission, r_isco)
from light_path_tracer_tpu.models import Kerr
from light_path_tracer_tpu.models.kerr import _inverse_metric_terms
from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
from light_path_tracer_tpu.utils.timing import StageTimer

_FIELDS = ("vertical", "toroidal", "radial")

# Signature table of the 24 permutations of (0,1,2,3) for the
# Levi-Civita contraction (built once at import).
_PERMS = [(p, _sig) for p in itertools.permutations(range(4))
          for _sig in [int(np.linalg.det(np.eye(4)[list(p)]))]]


def covariant_metric(M, a, r, th):
    """Covariant BL Kerr components (g_tt, g_tphi, g_rr, g_thth,
    g_phiphi), batched."""
    sin2 = jnp.sin(th) ** 2
    Sigma = r * r + a * a * jnp.cos(th) ** 2
    Delta = r * r - 2.0 * M * r + a * a
    g_tt = -(1.0 - 2.0 * M * r / Sigma)
    g_tphi = -2.0 * M * a * r * sin2 / Sigma
    g_rr = Sigma / Delta
    g_thth = Sigma
    g_phiphi = (r * r + a * a
                + 2.0 * M * a * a * r * sin2 / Sigma) * sin2
    return g_tt, g_tphi, g_rr, g_thth, g_phiphi


def _lower(g, v):
    """Covariant components of contravariant v under the BL metric g =
    (g_tt, g_tphi, g_rr, g_thth, g_phiphi)."""
    g_tt, g_tphi, g_rr, g_thth, g_phiphi = g
    return (g_tt * v[0] + g_tphi * v[3],
            g_rr * v[1],
            g_thth * v[2],
            g_tphi * v[0] + g_phiphi * v[3])


def _dot(g, u, v):
    ul = _lower(g, u)
    return sum(ul[i] * v[i] for i in range(4))


def k_contravariant(M, a, r, th, p_r, p_th, L, E=1.0):
    """Photon k^mu = (k^t, k^r, k^th, k^phi) from the canonical
    momentum (p_t = -E, p_r, p_th, p_phi = L)."""
    (gi_tt, gi_tphi, gi_rr, gi_thth, gi_phiphi,
     *_rest) = _inverse_metric_terms(M, a, r, th)
    p_t = -E
    return (gi_tt * p_t + gi_tphi * L,
            gi_rr * p_r,
            gi_thth * p_th,
            gi_tphi * p_t + gi_phiphi * L)


def walker_penrose(a, r, th, k, f):
    """(kappa1, kappa2) = Re/Im of the Walker-Penrose constant for
    tangent k and polarization f (both contravariant, batched)."""
    sin_th = jnp.sin(th)
    A = ((k[0] * f[1] - k[1] * f[0])
         + a * sin_th ** 2 * (k[1] * f[3] - k[3] * f[1]))
    B = sin_th * ((r * r + a * a) * (k[3] * f[2] - k[2] * f[3])
                  - a * (k[0] * f[2] - k[2] * f[0]))
    # (A - iB)(r - i a cos th)
    ac = a * jnp.cos(th)
    kappa1 = A * r - B * ac
    kappa2 = -(B * r + A * ac)
    return kappa1, kappa2


def keplerian_u(M, a, r, prograde=True):
    """Keplerian circular-orbit 4-velocity u^mu at equatorial radius r."""
    sqrtM = jnp.sqrt(M)
    omega = (sqrtM / (r ** 1.5 + a * sqrtM) if prograde
             else -sqrtM / (r ** 1.5 - a * sqrtM))
    th = jnp.full_like(r, np.pi / 2)
    g = covariant_metric(M, a, r, th)
    g_tt, g_tphi, _g_rr, _g_thth, g_phiphi = g
    norm = -(g_tt + 2.0 * omega * g_tphi + omega * omega * g_phiphi)
    u_t = 1.0 / jnp.sqrt(jnp.maximum(norm, 1e-12))
    zero = jnp.zeros_like(r)
    return (u_t, zero, zero, u_t * omega)


def field_vector(field, r, prograde=True):
    """Unit-magnitude COORDINATE-frame magnetic-field direction b^mu at
    the equator (normalized after projection into the fluid frame by the
    Levi-Civita contraction itself, so only the direction matters).
    vertical = -theta-hat (+z), toroidal = phi-hat, radial = r-hat."""
    zero = jnp.zeros_like(r)
    one = jnp.ones_like(r)
    if field == "vertical":
        return (zero, zero, -one, zero)
    if field == "toroidal":
        sign = 1.0 if prograde else -1.0
        return (zero, zero, zero, sign * one)
    if field == "radial":
        return (zero, one, zero, zero)
    raise ValueError(f"b-field must be one of {_FIELDS}, got {field!r}")


def emission_polarization(M, a, r_c, p_r, p_th, L, field="toroidal",
                          prograde=True):
    """Emitted polarization f^mu and the pitch-angle factor at the
    equatorial crossing.

    Returns (f (4-tuple, unnormalized), sin_xi): f ~ eps(u, k, b);
    sin_xi = |f| / (omega_fluid |b_perp_u|) in [0, 1] — the sine of the
    angle between photon and field in the fluid frame (synchrotron
    polarized emissivity ~ sin^2 xi).
    """
    th = jnp.full_like(r_c, np.pi / 2)
    k = k_contravariant(M, a, r_c, th, p_r, p_th, L)
    u = keplerian_u(M, a, r_c, prograde)
    b = field_vector(field, r_c, prograde)
    g = covariant_metric(M, a, r_c, th)

    u_l, k_l, b_l = _lower(g, u), _lower(g, k), _lower(g, b)
    # sqrt(-det g) = Sigma sin(theta) = r^2 at the equator.
    sqrtg = r_c * r_c
    f = [jnp.zeros_like(r_c) for _ in range(4)]
    for (mu, nu, rho, sig), sgn in _PERMS:
        f[mu] = f[mu] + sgn * u_l[nu] * k_l[rho] * b_l[sig] / sqrtg
    f = tuple(f)

    omega_fluid = -_dot(g, k, u)                    # photon energy in fluid
    b_perp = tuple(b[i] + _dot(g, b, u) * u[i] for i in range(4))
    b_norm = jnp.sqrt(jnp.maximum(_dot(g, b_perp, b_perp), 1e-30))
    f_norm = jnp.sqrt(jnp.maximum(_dot(g, f, f), 0.0))
    sin_xi = jnp.clip(
        f_norm / jnp.maximum(omega_fluid * b_norm, 1e-30), 0.0, 1.0)
    return f, sin_xi


def observer_basis(M, a, r_obs, theta_obs, k_cam):
    """Static-observer screen-transverse unit vectors (e1 ~ theta-hat,
    e2 ~ phi-hat, both orthogonal to u_obs AND to k) at the camera.

    Exact at any radius: u_obs is the normalized timelike Killing
    direction; each basis vector is Gram-Schmidt-projected orthogonal
    to u_obs and to the photon's spatial arrival direction.
    """
    r = jnp.asarray(r_obs, k_cam[0].dtype) * jnp.ones_like(k_cam[0])
    th = jnp.asarray(theta_obs, k_cam[0].dtype) * jnp.ones_like(k_cam[0])
    g = covariant_metric(M, a, r, th)
    g_tt = g[0]
    zero = jnp.zeros_like(r)
    u = (1.0 / jnp.sqrt(-g_tt), zero, zero, zero)

    def proj_perp_u(v):
        return tuple(v[i] + _dot(g, v, u) * u[i] for i in range(4))

    def normalize(v):
        n = jnp.sqrt(jnp.maximum(_dot(g, v, v), 1e-30))
        return tuple(v[i] / n for i in range(4))

    # Spatial direction of arrival.
    n_hat = normalize(proj_perp_u(k_cam))

    def perp(v, *others):
        v = proj_perp_u(v)
        for o in others:
            v = tuple(v[i] - _dot(g, v, o) * o[i] for i in range(4))
        return normalize(v)

    th_hat = (zero, zero, jnp.ones_like(r), zero)
    ph_hat = (zero, zero, zero, jnp.ones_like(r))
    e1 = perp(th_hat, n_hat)
    e2 = perp(ph_hat, n_hat, e1)
    return e1, e2


def observed_polarization(metric, r_obs, theta_obs, alphas, thetas,
                          kappa1, kappa2):
    """Invert the Walker-Penrose constant at the camera: returns
    (x, y, ok) with f_obs = x e1 + y e2 (screen-transverse basis) and
    ok = False where the 2x2 solve is degenerate."""
    y0, _p_t, p_phi, _inv = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    M = jnp.asarray(metric.M, alphas.dtype)
    a = jnp.asarray(metric.a, alphas.dtype)
    r = y0[0]
    th = y0[1]
    k_cam = k_contravariant(M, a, r, th, y0[3], y0[4], p_phi)
    e1, e2 = observer_basis(M, a, r_obs, theta_obs, k_cam)
    k1_1, k2_1 = walker_penrose(a, r, th, k_cam, e1)
    k1_2, k2_2 = walker_penrose(a, r, th, k_cam, e2)
    det = k1_1 * k2_2 - k1_2 * k2_1
    ok = jnp.abs(det) > 1e-20
    det_safe = jnp.where(ok, det, 1.0)
    x = (kappa1 * k2_2 - kappa2 * k1_2) / det_safe
    y = (kappa2 * k1_1 - kappa1 * k2_1) / det_safe
    return x, y, ok


def _trace_disk_momentum(metric, scene, cfg, disk, alpha, theta,
                         mesh=None):
    """The polarized paths' disk trace (crossing momenta recorded),
    single-device or tile-DP over `mesh`; returns a DiskTraceResult of
    FLAT ray arrays either way (the polarization algebra is written
    over flat arrays). Shared by render_polarization and
    hotspot_qu_loop."""
    if mesh is not None:
        from light_path_tracer_tpu.parallel.tiles import (
            trace_disk_grid_sharded)
        g = trace_disk_grid_sharded(
            metric, scene.r_obs, alpha, theta, scene.theta_obs,
            disk, mesh=mesh,
            lambda_max=max(5000.0, 6.0 * scene.r_obs),
            max_steps=cfg.max_steps, backend=cfg.backend,
            record_momentum=True)
        return type(g)(
            g.status.ravel(), g.n_hits.ravel(),
            tuple(r.ravel() for r in g.r_hits),
            g.xi.ravel(), g.n_steps,
            g.final_alpha.ravel(), g.n_half.ravel(),
            tuple(p.ravel() for p in g.phi_hits),
            tuple(x.ravel() for x in g.xi_hits),
            tuple(p.ravel() for p in g.pr_hits),
            tuple(p.ravel() for p in g.pth_hits))
    return trace_disk_rays(
        metric, scene.r_obs, alpha.ravel(), theta.ravel(),
        scene.theta_obs, max(5000.0, 6.0 * scene.r_obs),
        cfg.max_steps, disk, backend=cfg.backend,
        precision=cfg.precision, method=cfg.integrator,
        record_momentum=True)


def render_polarization(scene: SceneConfig, resolution,
                        cfg: RenderConfig = RenderConfig(),
                        disk: DiskConfig = DiskConfig(),
                        field: str = "toroidal", mesh=None):
    """Polarized accretion-disk image; returns (evpa, pol_frac,
    intensity, stats) as (H, W) float32 arrays.

    evpa: electric-vector position angle in radians, measured from the
    image +x axis, in (-pi/2, pi/2] (NaN where no disk emission);
    pol_frac: sin^2(xi) synchrotron pitch-angle weight in [0, 1];
    intensity: the imaging path's (unpolarized) emission for the same
    trace. First (opaque) crossing only; the camera must be BH-centered
    (psi = 0 — the screen-basis mapping assumes it).

    mesh: optional jax.sharding.Mesh — shard the disk trace row-wise
    over its devices (parallel/tiles.trace_disk_grid_sharded with
    record_momentum); the polarization epilogue is O(pixels)
    elementwise. Single-device equality is pinned in
    tests/test_sharding.py.
    """
    if any(abs(p) > 1e-12 for p in scene.psi):
        raise ValueError("render_polarization requires psi = (0, 0) "
                         "(BH-centered camera)")
    if getattr(scene, "Q", 0.0):
        # The Walker-Penrose constant implemented here is the Kerr
        # form; Kerr-Newman is also Petrov D but its kappa picks up
        # charge terms that the transport algebra below does not carry.
        raise ValueError("polarized rendering supports uncharged (Kerr)"
                         " scenes only; got Q != 0")
    metric = Kerr(M=scene.M, a=scene.a)
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(resolution, fov, dtype=dtype)
        theta = camera.build_theta_lookup(resolution, fov, dtype=dtype)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        res = _trace_disk_momentum(metric, scene, cfg, disk, alpha,
                                   theta, mesh=mesh)
        out.append(res.status)

    with timer.stage("render") as out:
        M = jnp.asarray(scene.M, dtype)
        a = jnp.asarray(scene.a, dtype)
        hit = res.n_hits > 0
        r_in = disk.r_in if disk.r_in is not None else r_isco(
            scene.M, scene.a, disk.prograde)
        r_c = jnp.maximum(res.r_hits[0], r_in)
        f_em, sin_xi = emission_polarization(
            M, a, r_c, res.pr_hits[0], res.pth_hits[0], res.xi,
            field=field, prograde=disk.prograde)
        th_eq = jnp.full_like(r_c, np.pi / 2)
        k_em = k_contravariant(M, a, r_c, th_eq, res.pr_hits[0],
                               res.pth_hits[0], res.xi)
        kappa1, kappa2 = walker_penrose(a, r_c, th_eq, k_em, f_em)
        x, y, ok = observed_polarization(
            metric, scene.r_obs, scene.theta_obs,
            alpha.ravel(), theta.ravel(), kappa1, kappa2)
        # Screen mapping (module docstring): e2 (phi-hat) -> image -x,
        # e1 (theta-hat) -> image +y (down). EVPA from image +x axis.
        fx = -y
        fy = x
        evpa = jnp.arctan2(fy, fx)
        evpa = jnp.mod(evpa + np.pi / 2, np.pi) - np.pi / 2  # mod pi
        good = hit & ok & (sin_xi > 0.0)
        evpa = jnp.where(good, evpa, jnp.nan)
        pol = jnp.where(good, sin_xi ** 2, 0.0)
        intensity, _rgb = disk_emission(scene, disk, r_in, res.n_hits,
                                        res.r_hits, res.xi,
                                        xi_hits=res.xi_hits)
        out.append(evpa)

    stats = dict(
        r_isco=r_isco(scene.M, scene.a, disk.prograde),
        field=field,
        disk_pixels=int(np.asarray(hit).sum()),
        polarized_pixels=int(np.asarray(good).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return (np.asarray(evpa, np.float32).reshape(resolution),
            np.asarray(pol, np.float32).reshape(resolution),
            np.asarray(intensity, np.float32).reshape(resolution),
            stats)


def save_polarization_figure(path, evpa, pol_frac, intensity,
                             tick_step: int = 16, title: str = ""):
    """EHT-style polarization-tick figure: the (tone-mapped) disk image
    with EVPA line segments overlaid, tick length ~ polarized
    intensity. Saves to `path`; headless (Agg)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h, w = intensity.shape
    img = intensity / max(float(np.nanmax(intensity)), 1e-30)
    img = np.power(np.clip(img, 0.0, 1.0), 1 / 2.2)

    fig, ax = plt.subplots(figsize=(7, 7 * h / w))
    ax.imshow(img, cmap="afmhot", origin="upper",
              vmin=0.0, vmax=1.0)
    ys, xs, us, vs, cs = [], [], [], [], []
    pol_i = pol_frac * img
    pmax = max(float(np.nanmax(pol_i)), 1e-30)
    for py in range(tick_step // 2, h, tick_step):
        for px in range(tick_step // 2, w, tick_step):
            chi = evpa[py, px]
            if not np.isfinite(chi) or pol_i[py, px] <= 0:
                continue
            length = tick_step * 0.9 * np.sqrt(pol_i[py, px] / pmax)
            # Image convention: +x right, +y down; imshow's display y
            # axis points down too, so components map directly.
            dx, dy = np.cos(chi) * length / 2, np.sin(chi) * length / 2
            ys.append(py); xs.append(px); us.append(dx); vs.append(dy)
            cs.append(pol_frac[py, px])
    for x0, y0, dx, dy in zip(xs, ys, us, vs):
        ax.plot([x0 - dx, x0 + dx], [y0 - dy, y0 + dy],
                color="cyan", lw=1.4, solid_capstyle="round")
    ax.set_xticks([]), ax.set_yticks([])
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def hotspot_qu_loop(scene: SceneConfig, resolution, times,
                    cfg: RenderConfig = RenderConfig(),
                    disk: DiskConfig = DiskConfig(),
                    spot=None, field: str = "toroidal", mesh=None):
    """Integrated Stokes (Q, U) vs time for an orbiting hot spot — the
    polarization "loop" observable (GRAVITY / EHT Sgr A* flares): as
    the spot circles the hole, the net EVPA of the integrated emission
    rotates and (Q, U) traces a closed loop once per orbit.

    ONE geodesic trace: per-pixel EVPA and pitch-angle weight are
    time-independent (the lensing map is static); only the spot's
    surface-brightness pattern advects. Returns (times, I, Q, U,
    stats) with I/Q/U (T,) arrays (flux units of the imaging path;
    Q + iU = sum_px I_px p_px exp(2 i chi_px)).

    mesh: optional jax.sharding.Mesh — the single disk trace shards
    row-wise like render_polarization's (the per-time reductions are
    O(pixels) host-side epilogues).
    """
    import jax

    from light_path_tracer_tpu.disk import (
        HotSpot, hotspot_pattern, keplerian_omega)

    if any(abs(p) > 1e-12 for p in scene.psi):
        raise ValueError("hotspot_qu_loop requires psi = (0, 0)")
    if getattr(scene, "Q", 0.0):
        raise ValueError("polarized rendering supports uncharged (Kerr)"
                         " scenes only; got Q != 0")
    if spot is None:
        spot = HotSpot()
    metric = Kerr(M=scene.M, a=scene.a)
    timer = StageTimer()
    times = list(times)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(resolution, fov, dtype=dtype)
        theta = camera.build_theta_lookup(resolution, fov, dtype=dtype)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        res = _trace_disk_momentum(metric, scene, cfg, disk, alpha,
                                   theta, mesh=mesh)
        out.append(res.status)

    with timer.stage("render") as out:
        M = jnp.asarray(scene.M, dtype)
        a = jnp.asarray(scene.a, dtype)
        hit = res.n_hits > 0
        r_in = disk.r_in if disk.r_in is not None else r_isco(
            scene.M, scene.a, disk.prograde)
        r_c = jnp.maximum(res.r_hits[0], r_in)
        f_em, sin_xi = emission_polarization(
            M, a, r_c, res.pr_hits[0], res.pth_hits[0], res.xi,
            field=field, prograde=disk.prograde)
        th_eq = jnp.full_like(r_c, np.pi / 2)
        k_em = k_contravariant(M, a, r_c, th_eq, res.pr_hits[0],
                               res.pth_hits[0], res.xi)
        kappa1, kappa2 = walker_penrose(a, r_c, th_eq, k_em, f_em)
        x, y, ok = observed_polarization(
            metric, scene.r_obs, scene.theta_obs,
            alpha.ravel(), theta.ravel(), kappa1, kappa2)
        evpa = jnp.arctan2(x, -y)          # fy = x, fx = -y
        good = hit & ok
        p_cos = jnp.where(good, sin_xi ** 2 * jnp.cos(2.0 * evpa), 0.0)
        p_sin = jnp.where(good, sin_xi ** 2 * jnp.sin(2.0 * evpa), 0.0)

        pattern = hotspot_pattern(spot, scene.M, scene.a, disk.prograde)
        ts = jnp.asarray(times, dtype)

        @jax.jit
        def curves(ts, n_hits, r_hits, xi, phi_hits, xi_hits,
                   p_cos, p_sin):
            def at(t):
                intensity, _rgb = disk_emission(
                    scene, disk, r_in, n_hits, r_hits, xi,
                    pattern=pattern, phi_hits=phi_hits, t=t,
                    xi_hits=xi_hits)
                return (intensity.sum(),
                        (intensity * p_cos).sum(),
                        (intensity * p_sin).sum())
            return jax.vmap(at)(ts)

        I, Q, U = curves(ts, res.n_hits, res.r_hits, res.xi,
                         res.phi_hits, res.xi_hits, p_cos, p_sin)
        out.append(I)

    stats = dict(
        r_isco=r_isco(scene.M, scene.a, disk.prograde),
        field=field,
        orbit_period=abs(2.0 * np.pi / keplerian_omega(
            scene.M, scene.a, spot.r0, disk.prograde)),
        disk_pixels=int(np.asarray(hit).sum()),
        n_samples=len(times),
        total_rays=resolution[0] * resolution[1],
        traced_rays=resolution[0] * resolution[1],
        timings=timer.finish())
    return (np.asarray(times, np.float64), np.asarray(I, np.float64),
            np.asarray(Q, np.float64), np.asarray(U, np.float64),
            stats)


# ---------------------------------------------------------------------
# Polarized VOLUMETRIC transfer: Stokes (I, Q, U) path integrals.
# ---------------------------------------------------------------------

def _field_vector_offplane(field, r, th, prograde=True):
    """Coordinate-frame field direction at general (r, theta) — the
    off-plane generalization of field_vector (which it reduces to at
    the equator): vertical = +z = cos(th) d_r - sin(th)/r d_th,
    toroidal = phi-hat, radial = r-hat. Only the direction matters
    (the Levi-Civita contraction normalizes via sin_xi)."""
    zero = jnp.zeros_like(r)
    one = jnp.ones_like(r)
    if field == "vertical":
        return (zero, jnp.cos(th),
                -jnp.sin(th) / jnp.maximum(r, 1e-6), zero)
    if field == "toroidal":
        sign = 1.0 if prograde else -1.0
        return (zero, zero, zero, sign * one)
    if field == "radial":
        return (zero, one, zero, zero)
    raise ValueError(f"b-field must be one of {_FIELDS}, got {field!r}")


def _flow_u_offplane(M, a, r, th, prograde=True):
    """Keplerian-where-timelike / ZAMO-inside circular 4-velocity at
    general (r, theta) — the same flow field volumetric emission uses
    (volumetric._profile_fns), rebuilt here in 4-vector form for the
    Levi-Civita contraction."""
    g_tt, g_tphi, _g_rr, _g_thth, g_phiphi = covariant_metric(
        M, a, r, th)
    sqrtM = jnp.sqrt(M)
    om_k = (sqrtM / (r ** 1.5 + a * sqrtM) if prograde
            else -sqrtM / (r ** 1.5 - a * sqrtM))
    om_z = -g_tphi / jnp.maximum(g_phiphi, 1e-30)

    def timelike(om):
        return -(g_tt + 2.0 * om * g_tphi + om * om * g_phiphi)

    om = jnp.where(timelike(om_k) > 1e-3, om_k, om_z)
    u_t = 1.0 / jnp.sqrt(jnp.maximum(timelike(om), 1e-12))
    zero = jnp.zeros_like(r)
    return (u_t, zero, zero, u_t * om)


def _local_polarization(M, a, r, th, p_r, p_th, L, field, prograde):
    """(kappa1, kappa2, sin_xi) of the synchrotron emission element at
    general (r, theta) — emission_polarization generalized off the
    equatorial plane (sqrt(-det g) = Sigma |sin th|; an overall sign
    of f flips kappa, which the quadratic Stokes construction cannot
    see, so the |.| is safe on the double-cover chart)."""
    k = k_contravariant(M, a, r, th, p_r, p_th, L)
    u = _flow_u_offplane(M, a, r, th, prograde)
    b = _field_vector_offplane(field, r, th, prograde)
    g = covariant_metric(M, a, r, th)

    u_l, k_l, b_l = _lower(g, u), _lower(g, k), _lower(g, b)
    Sigma = r * r + a * a * jnp.cos(th) ** 2
    sqrtg = jnp.maximum(Sigma * jnp.abs(jnp.sin(th)), 1e-12)
    f = [jnp.zeros_like(r) for _ in range(4)]
    for (mu, nu, rho, sig), sgn in _PERMS:
        f[mu] = f[mu] + sgn * u_l[nu] * k_l[rho] * b_l[sig] / sqrtg
    f = tuple(f)

    omega_fluid = -_dot(g, k, u)
    b_perp = tuple(b[i] + _dot(g, b, u) * u[i] for i in range(4))
    b_norm = jnp.sqrt(jnp.maximum(_dot(g, b_perp, b_perp), 1e-30))
    f_norm = jnp.sqrt(jnp.maximum(_dot(g, f, f), 0.0))
    sin_xi = jnp.clip(
        f_norm / jnp.maximum(omega_fluid * b_norm, 1e-30), 0.0, 1.0)
    kappa1, kappa2 = walker_penrose(a, r, th, k, f)
    return kappa1, kappa2, sin_xi


import functools as _functools


@_functools.lru_cache(maxsize=32)
def make_polarized_volumetric_transfer(metric, riaf, field: str,
                                       p0: float):
    """transfer_fn for trace_rays_aux: Stokes (I, Q, U) volumetric
    path integrals via per-element Walker-Penrose endpoint algebra.

    Each emission element's polarization 4-vector f ~ eps(u, k, b) is
    evaluated from the CURRENT integrator state; its Walker-Penrose
    constant kappa is conserved to the camera, where the per-ray basis
    constants (aux = kappa(e1), kappa(e2) computed once per ray by
    render_polarized_volumetric) invert it into screen components —
    so the element's camera-frame EVPA chi is available INSIDE the
    integrand and the Stokes sums

        dI = g^p j,   dQ = p0 sin^2(xi) g^p j cos 2chi,
                      dU = p0 sin^2(xi) g^p j sin 2chi

    ride the adaptive loop like any other path integral. This is the
    volumetric counterpart of render_polarization's per-crossing
    algebra: depolarization along the line of sight (crossed EVPAs
    cancelling in Q/U) emerges from the integral itself — the EHT
    polarized-ring phenomenology. Kerr-only (WP is the Kerr form);
    optically thin (absorption would need per-element transport of
    the attenuated Stokes vector).
    """
    from light_path_tracer_tpu.volumetric import _profile_fns
    if getattr(metric, "Q", 0.0) or getattr(metric, "eps3", 0.0):
        raise ValueError("polarized volumetric rendering supports "
                         "uncharged Kerr scenes only")
    if field not in _FIELDS:
        raise ValueError(f"b-field must be one of {_FIELDS}, "
                         f"got {field!r}")
    if riaf.alpha0:
        raise ValueError("polarized volumetric mode is optically thin "
                         "(alpha0 must be 0): absorption would need "
                         "the full polarized transfer equation")
    _j_rest, _g_clipped = _profile_fns(metric, riaf)
    M = float(metric.M)
    a = float(metric.a)

    def transfer_fn(y, p_t, p_phi, aux):
        k11, k21, k12, k22 = aux          # camera kappa(e1), kappa(e2)
        r, th = y[0], y[1]
        j = _j_rest(r, jnp.cos(th))
        w = (1.0 if riaf.g_power == 0.0
             else _g_clipped(y[:5], p_t, p_phi) ** riaf.g_power)
        L = p_phi                          # E = 1 convention (p_t = -1)
        kappa1, kappa2, sin_xi = _local_polarization(
            M, a, r, th, y[3], y[4], L, field, riaf.prograde)
        det = k11 * k22 - k12 * k21
        ok = jnp.abs(det) > 1e-20
        det_s = jnp.where(ok, det, 1.0)
        x = (kappa1 * k22 - kappa2 * k12) / det_s
        yv = (kappa2 * k11 - kappa1 * k21) / det_s
        n2 = x * x + yv * yv
        good = ok & (n2 > 1e-24)
        n2_s = jnp.where(good, n2, 1.0)
        # chi = atan2(-x, yv) (render_polarization's convention);
        # Stokes needs only (cos 2chi, sin 2chi) — pure algebra.
        cos2 = (yv * yv - x * x) / n2_s
        sin2 = -2.0 * x * yv / n2_s
        A = jnp.where(good, p0 * sin_xi ** 2 * w * j, 0.0)
        return (w * j, A * cos2, A * sin2)

    return transfer_fn


def render_polarized_volumetric(scene: SceneConfig, resolution,
                                cfg: RenderConfig = RenderConfig(),
                                riaf=None, field: str = "toroidal",
                                p0: float = 0.7, mesh=None):
    """Polarized hot-flow image: Stokes (I, Q, U) integrated along
    every geodesic in ONE trace. Returns (evpa, pol_frac, intensity,
    stats) — same contract as render_polarization: evpa in radians
    from the image +x axis (NaN where unpolarized/no emission),
    pol_frac = sqrt(Q^2 + U^2) / I in [0, p0] (beam depolarization
    shows up as pol_frac < p0 even though every ELEMENT emits at p0).
    stats carries the raw Stokes maps (stats['I'/'Q'/'U']).

    Camera must be BH-centered and static (psi = 0, boost = 0): the
    screen-basis mapping assumes it.
    """
    from light_path_tracer_tpu.volumetric import RIAFConfig
    from light_path_tracer_tpu.ops.kerr_trace import (CAPTURED, INVALID,
                                                      trace_rays_aux)
    riaf = riaf if riaf is not None else RIAFConfig()
    if any(abs(p) > 1e-12 for p in scene.psi):
        raise ValueError("render_polarized_volumetric requires "
                         "psi = (0, 0) (BH-centered camera)")
    if any(abs(b) > 1e-12 for b in scene.boost):
        raise ValueError("render_polarized_volumetric requires a "
                         "static camera (boost = 0)")
    if getattr(scene, "Q", 0.0) or getattr(scene, "eps3", 0.0):
        raise ValueError("polarized volumetric rendering supports "
                         "uncharged Kerr scenes only")
    metric = Kerr(M=scene.M, a=scene.a)
    transfer_fn = make_polarized_volumetric_transfer(metric, riaf,
                                                     field, float(p0))
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    with timer.stage("build_lookup") as out:
        alpha = camera.build_alpha_lookup(resolution, fov, dtype=dtype)
        theta = camera.build_theta_lookup(resolution, fov, dtype=dtype)
        alpha, theta = alpha.ravel(), theta.ravel()
        # Per-ray camera-side Walker-Penrose basis constants.
        y0, _p_t, p_phi, _inv = metric.initial_conditions_5d(
            scene.r_obs, alpha, theta, scene.theta_obs)
        Mj = jnp.asarray(scene.M, dtype)
        aj = jnp.asarray(scene.a, dtype)
        k_cam = k_contravariant(Mj, aj, y0[0], y0[1], y0[3], y0[4],
                                p_phi)
        e1, e2 = observer_basis(Mj, aj, scene.r_obs, scene.theta_obs,
                                k_cam)
        k11, k21 = walker_penrose(aj, y0[0], y0[1], k_cam, e1)
        k12, k22 = walker_penrose(aj, y0[0], y0[1], k_cam, e2)
        out.append((alpha, theta))

    with timer.stage("precompute") as out:
        if mesh is not None:
            from light_path_tracer_tpu.parallel.tiles import (
                trace_aux_grid_sharded)
            res = trace_aux_grid_sharded(
                metric, scene.r_obs, alpha.reshape(resolution),
                theta.reshape(resolution), scene.theta_obs,
                transfer_fn, 3,
                tuple(k.reshape(resolution)
                      for k in (k11, k21, k12, k22)),
                mesh=mesh, max_steps=cfg.max_steps,
                precision=cfg.precision, method=cfg.integrator,
                sat_window=cfg.sat_window, sat_monitor=(0, 1, 2))
        else:
            # Saturation monitor: all three Stokes path integrals
            # (I, Q, U) — Q/U oscillate in sign along a whirl, but the
            # exit requires EVERY component bitwise-frozen, so a lane
            # still depolarizing cannot exit.
            res = trace_rays_aux(
                metric, scene.r_obs, alpha, theta, scene.theta_obs,
                transfer_fn, 3, (k11, k21, k12, k22),
                max(5000.0, 6.0 * scene.r_obs), cfg.max_steps,
                precision=cfg.precision, method=cfg.integrator,
                sat_window=cfg.sat_window, sat_monitor=(0, 1, 2))
        out.append(res.status)

    I_map, Q_map, U_map = (np.asarray(e).reshape(resolution)
                           for e in res.extras)
    pol_int = np.hypot(Q_map, U_map)
    pol_frac = pol_int / np.maximum(I_map, 1e-30)
    evpa = np.where(pol_int > 1e-12 * max(I_map.max(), 1e-30),
                    0.5 * np.arctan2(U_map, Q_map), np.nan)
    status = np.asarray(res.status)
    stats = dict(
        I=I_map, Q=Q_map, U=U_map,
        captured=int((status == CAPTURED).sum()),
        invalid=int((status == INVALID).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        timings=timer.finish())
    return (evpa.astype(np.float64), pol_frac.astype(np.float64),
            I_map, stats)
