"""Lensed-image renderer: lookup tables -> output image, fully vectorized.

Semantic parity with /root/reference/image_lens.py:287-397, including the
edge cases:
  * NaN final_alpha (captured/invalid rays) stays black — the shadow.
  * Escaped rays with final_alpha > pi/2 get a winding-number color from
    the 5-entry palette (WINDING_COLORS, image_lens.py:287-293), clipped to
    the palette range; grayscale sources use the luma projection
    (image_lens.py:330-331).
  * Escaped rays with final_alpha <= pi/2 reconstruct the source direction
    in the (d, e_x, e_y) frame and project back through the pinhole:
    out-of-bounds / behind-camera pixels become the magenta sentinel
    (image_lens.py:367-395), or wrap modulo the image when
    render_loop_around is set (image_lens.py:354-365 — including the legacy
    quirk that behind-camera rays sample from the image-center pixel).

Array design: a single jitted gather program — boolean masks +
`jnp.where` select between shadow / winding color / texture gather /
sentinel; the texture fetch is one flat `take` on clamped indices.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu.camera import psi_frame, focal_lengths

WINDING_COLORS = np.array([
    [0.0, 0.2, 1.0],   # blue
    [0.0, 0.7, 1.0],   # sky blue
    [0.0, 1.0, 0.4],   # green
    [1.0, 1.0, 0.0],   # yellow
    [1.0, 0.4, 0.0],   # orange
], dtype=np.float32)

_LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)


@functools.partial(
    jax.jit,
    static_argnames=("image_dimension", "fov", "psi", "render_loop_around",
                     "sampling"))
def _render_kernel(source_image, theta_lookup, final_alpha_lookup,
                   winding_lookup, image_dimension, fov, psi,
                   render_loop_around, sampling="nearest"):
    frame = psi_frame(psi)
    return _render_core(source_image, theta_lookup, final_alpha_lookup,
                        winding_lookup, frame.d, frame.e_x, frame.e_y,
                        image_dimension, fov, render_loop_around,
                        sampling)


def _bilinear_gather(src_flat, px, py, height, width, channels, wrap):
    """Bilinear texture fetch at continuous source coordinates.

    Texel i's center sits at coordinate i (the nearest rule is rint), so
    the unit cell is [i, i+1) with weight px - floor(px). wrap=True
    (loop-around mode) wraps corners modulo the image; otherwise corners
    clamp to the edge (the out-of-bounds CLASSIFICATION stays the
    nearest-rule sentinel in the caller, so only in-bounds smoothing
    changes vs nearest sampling). `wrap` may also be a (wrap_y, wrap_x)
    pair for per-axis control — the equirect panorama chart wraps in
    longitude (x) but clamps at the poles (y).
    """
    wrap_y, wrap_x = wrap if isinstance(wrap, tuple) else (wrap, wrap)
    x0 = jnp.floor(px)
    y0 = jnp.floor(py)
    tx = (px - x0)[..., None]
    ty = (py - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)

    def at(yy, xx):
        yy = jnp.mod(yy, height) if wrap_y else jnp.clip(yy, 0, height - 1)
        xx = jnp.mod(xx, width) if wrap_x else jnp.clip(xx, 0, width - 1)
        return src_flat[yy * width + xx]

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    top = v00 * (1.0 - tx) + v01 * tx
    bot = v10 * (1.0 - tx) + v11 * tx
    return (top * (1.0 - ty) + bot * ty).astype(src_flat.dtype)


def _render_core(source_image, theta_lookup, final_alpha_lookup,
                 winding_lookup, d, e_x, e_y, image_dimension, fov,
                 render_loop_around, sampling="nearest"):
    """Renderer body with the camera frame vectors as (possibly traced)
    values — shared by the static-psi kernel and the animation path."""
    height, width = image_dimension
    fx, fy = focal_lengths(image_dimension, fov)

    grayscale = source_image.ndim == 2
    channels = 1 if grayscale else source_image.shape[2]
    src = source_image if not grayscale else source_image[..., None]
    compute_dtype = final_alpha_lookup.dtype

    valid = jnp.isfinite(final_alpha_lookup)
    fa = jnp.where(valid, final_alpha_lookup, 0.0).astype(compute_dtype)
    th = theta_lookup.astype(compute_dtype)

    winding_mask = valid & (final_alpha_lookup > np.pi / 2)
    escaped_mask = valid & (final_alpha_lookup <= np.pi / 2)

    # -- winding color layer --
    palette = jnp.asarray(WINDING_COLORS)
    if grayscale:
        palette = jnp.matmul(palette, jnp.asarray(_LUMA),
                                 precision=jax.lax.Precision.HIGHEST)[:, None]
    elif channels < 3:
        palette = palette[:, :channels]
    elif channels > 3:
        palette = jnp.concatenate(
            [palette, jnp.ones((palette.shape[0], channels - 3),
                               palette.dtype)], axis=1)
    w_idx = jnp.clip(winding_lookup.astype(jnp.int32), 0,
                     len(WINDING_COLORS) - 1)
    winding_rgb = palette[w_idx]  # (H, W, C)

    # -- escaped layer: source-direction reconstruction + pinhole gather --
    sin_fa, cos_fa = jnp.sin(fa), jnp.cos(fa)
    sin_th, cos_th = jnp.sin(th), jnp.cos(th)
    sx = sin_th * e_x[0] + cos_th * e_y[0]
    sy = sin_th * e_x[1] + cos_th * e_y[1]
    sz = sin_th * e_x[2] + cos_th * e_y[2]
    src_vx = cos_fa * d[0] + sin_fa * sx
    src_vy = cos_fa * d[1] + sin_fa * sy
    src_vz = cos_fa * d[2] + sin_fa * sz

    front = src_vz > 1e-12
    vz_safe = jnp.where(front, src_vz, 1.0)

    if render_loop_around:
        # Legacy wrap: behind-camera rays project with x_cam = y_cam = 0,
        # i.e. sample the image-center pixel (image_lens.py:354-365).
        x_cam = jnp.where(front, src_vx / vz_safe, 0.0)
        y_cam = jnp.where(front, src_vy / vz_safe, 0.0)
        px = x_cam * fx + width / 2
        py = y_cam * fy + height / 2
        src_x = jnp.mod(jnp.rint(px).astype(jnp.int32), width)
        src_y = jnp.mod(jnp.rint(py).astype(jnp.int32), height)
        in_bounds = jnp.ones_like(front)
    else:
        x_cam = src_vx / vz_safe
        y_cam = src_vy / vz_safe
        px = x_cam * fx + width / 2
        py = y_cam * fy + height / 2
        src_x = jnp.rint(px).astype(jnp.int32)
        src_y = jnp.rint(py).astype(jnp.int32)
        in_bounds = (front
                     & (src_y >= 0) & (src_y < height)
                     & (src_x >= 0) & (src_x < width))

    src_flat = src.reshape(height * width, channels)
    if sampling == "bilinear":
        # Continuous gather: image error then tracks angle error instead
        # of plateauing at the nearest-texel flip floor (BASELINE.md,
        # accuracy targets). The in_bounds/sentinel CLASSIFICATION above
        # stays the nearest rule for parity.
        texture = _bilinear_gather(src_flat, px, py, height, width,
                                   channels, wrap=render_loop_around)
    else:
        if sampling != "nearest":
            raise ValueError(f"sampling must be 'nearest' or "
                             f"'bilinear', got {sampling!r}")
        flat_idx = (jnp.clip(src_y, 0, height - 1) * width
                    + jnp.clip(src_x, 0, width - 1))
        texture = src_flat[flat_idx]  # (H, W, C)

    # Magenta sentinel (image_lens.py:381-393): R=1 (plus B=1 when the
    # source has >= 3 channels); scalar 1.0 for grayscale.
    magenta = np.zeros((channels,), dtype=np.float32)
    magenta[0] = 1.0
    if channels > 2:
        magenta[2] = 1.0
    magenta_px = jnp.asarray(magenta, src.dtype)

    escaped_rgb = jnp.where(in_bounds[..., None], texture, magenta_px)

    # Output follows the LOOKUP grid's shape, not the source image's —
    # they coincide for whole-frame renders, but the adaptive-AA refine
    # pass renders scattered (S-1, K) sample sets against the full
    # source (adaptive.py).
    out = jnp.zeros(escaped_rgb.shape, src.dtype)
    out = jnp.where(winding_mask[..., None],
                    winding_rgb.astype(src.dtype), out)
    out = jnp.where(escaped_mask[..., None], escaped_rgb, out)
    return out[..., 0] if grayscale else out


def render_lensed_image(source_image, alpha_lookup, final_alpha_lookup,
                        winding_lookup, alpha_crit, fov,
                        render_loop_around=False, psi=(0.0, 0.0),
                        theta_lookup=None, sampling="nearest"):
    """Render the lensed output image from precomputed lookup tables.

    Signature parity: image_lens.py:296-298 (alpha_lookup and alpha_crit
    are accepted for compatibility; the renderer needs theta, which it
    derives from the camera grids unless `theta_lookup` is supplied).
    sampling: "nearest" (reference parity, image_lens.py:119-120) or
    "bilinear" (continuous texture gather — smoother images, and image
    error tracks ray-angle accuracy instead of the texel-flip floor).
    """
    height, width = source_image.shape[:2]
    if theta_lookup is None:
        from light_path_tracer_tpu.camera import build_theta_lookup
        theta_lookup = build_theta_lookup(
            (height, width), fov, psi=psi,
            dtype=final_alpha_lookup.dtype)
    if winding_lookup is None:
        winding_lookup = jnp.zeros((height, width), jnp.int32)
    return _render_kernel(
        jnp.asarray(source_image), theta_lookup,
        jnp.asarray(final_alpha_lookup), jnp.asarray(winding_lookup),
        (height, width), tuple(fov), tuple(psi), bool(render_loop_around),
        str(sampling))


def ring_labels(max_order: int):
    """Canonical layer labels for ring_decomposition's output order —
    the ONE source for every consumer (pipeline stats, CLI filenames);
    zip() against mismatched ad-hoc lists silently mislabels layers."""
    return ([f"order_{k}" for k in range(max_order)]
            + [f"order_ge_{max_order}", "shadow"])


def ring_decomposition(final_alpha, winding, max_order: int = 3):
    """Separate an image by photon-ring order (winding half-orbits).

    A pixel's ray winds `winding` half-orbits around the hole before
    escaping: order 0 is the direct image, order 1 the first lensed
    (secondary) image, order n the exponentially thinner n-th photon
    ring (each order ~e^-pi the width of the previous — the structure
    EHT-style observations target). The per-pixel winding data already
    exists in every render; this just splits it.

    New capability beyond the reference (which folds all orders into one
    image). Returns (masks, composite):
      * masks: (max_order + 2, H, W) bool — orders 0..max_order-1, then
        ">= max_order", then the shadow (captured/invalid).
      * composite: (H, W, 3) float32 — shadow black, each order tinted
        with the winding palette (WINDING_COLORS), direct image light
        gray.
    """
    fa = jnp.asarray(final_alpha)
    w = jnp.asarray(winding).astype(jnp.int32)
    escaped = ~jnp.isnan(fa)

    masks = []
    for k in range(max_order):
        masks.append(escaped & (w == k))
    masks.append(escaped & (w >= max_order))
    masks.append(~escaped)
    masks = jnp.stack(masks)

    h, wd = fa.shape
    composite = jnp.zeros((h, wd, 3), jnp.float32)
    direct = jnp.asarray([0.85, 0.85, 0.85], jnp.float32)
    composite = jnp.where(masks[0][..., None], direct, composite)
    palette = jnp.asarray(WINDING_COLORS)
    for k in range(1, max_order + 1):
        color = palette[min(k - 1, len(WINDING_COLORS) - 1)]
        composite = jnp.where(masks[k][..., None], color, composite)
    return masks, composite


def escape_directions(final_alpha_lookup, theta_lookup, frame):
    """Per-pixel escape unit vectors v (camera coords) from the
    (final_alpha, theta) chart in the (d, e_x, e_y) frame — ALL escaped
    rays, any winding (v is continuous across winding folds: the
    render's pi/2 winding-color split is a display rule, not a property
    of the map). NaN where captured/invalid."""
    fa = final_alpha_lookup
    th = theta_lookup.astype(fa.dtype)
    d, e_x, e_y = frame.d, frame.e_x, frame.e_y
    sin_fa, cos_fa = jnp.sin(fa), jnp.cos(fa)
    sin_th, cos_th = jnp.sin(th), jnp.cos(th)
    sx = sin_th * e_x[0] + cos_th * e_y[0]
    sy = sin_th * e_x[1] + cos_th * e_y[1]
    sz = sin_th * e_x[2] + cos_th * e_y[2]
    return (cos_fa * d[0] + sin_fa * sx,
            cos_fa * d[1] + sin_fa * sy,
            cos_fa * d[2] + sin_fa * sz)


def _solid_angle_element(vx, vy, vz):
    """Signed celestial solid-angle element |dv/di x dv/dj| . v per
    pixel of a unit-vector field, by central differences (one-sided at
    the grid edges, jnp.gradient convention)."""
    dvx_i, dvx_j = jnp.gradient(vx)
    dvy_i, dvy_j = jnp.gradient(vy)
    dvz_i, dvz_j = jnp.gradient(vz)
    cx = dvy_i * dvz_j - dvz_i * dvy_j
    cy = dvz_i * dvx_j - dvx_i * dvz_j
    cz = dvx_i * dvy_j - dvy_i * dvx_j
    return cx * vx + cy * vy + cz * vz


def magnification_map(final_alpha_lookup, theta_lookup, frame,
                      image_dimension, fov):
    """Signed per-pixel lensing magnification of the celestial lens map.

    The trace defines a map from image directions u(i, j) (pinhole unit
    view rays) to escape directions v(i, j) on the celestial sphere;
    magnification is the solid-angle ratio
        mu = (du_i x du_j).u / (dv_i x dv_j).v
    (both elements signed, so mu < 0 marks parity-flipped — odd —
    images; |mu| -> inf on the critical curves: the Einstein ring of a
    source exactly behind the hole, and the exponentially stacked
    higher-order photon-ring curves). Without the hole v = u and
    mu = 1 identically; far from the hole mu -> 1 (weak field). New
    capability beyond the reference (no magnification product there);
    derivative estimates are central differences on the traced grid,
    so curves thinner than ~2 px alias.

    Returns (H, W) float32: signed mu, NaN where the ray was captured
    (shadow interior; the 1-px rim around it inherits NaN from the
    stencil).
    """
    from light_path_tracer_tpu.camera import _view_grids

    vx, vy, vz = escape_directions(final_alpha_lookup, theta_lookup,
                                   frame)
    ux, uy, uz = _view_grids(image_dimension, fov,
                             final_alpha_lookup.dtype)
    uy = jnp.broadcast_to(uy, image_dimension)
    ux = jnp.broadcast_to(ux, image_dimension)
    uz = jnp.broadcast_to(uz, image_dimension)
    a_img = _solid_angle_element(ux, uy, uz)
    a_src = _solid_angle_element(vx, vy, vz)
    tiny = jnp.asarray(1e-30, a_src.dtype)
    safe = jnp.where(jnp.abs(a_src) < tiny,
                     jnp.where(a_src < 0, -tiny, tiny), a_src)
    mu = (a_img / safe).astype(jnp.float32)
    return jnp.where(jnp.isfinite(final_alpha_lookup), mu, jnp.nan)


def _source_plane_coords(final_alpha_lookup, theta_lookup, frame):
    """Per-pixel gnomonic (tangent-plane) source coordinates about the
    BH direction d: beta_x = (v.e_x)/(v.d), beta_y = (v.e_y)/(v.d) for
    the escape direction v — the angular position on the background
    sky that pixel's ray came from. NaN where captured/invalid or the
    ray escaped into the back hemisphere (v.d <= 0, outside the
    tangent chart)."""
    vx, vy, vz = escape_directions(final_alpha_lookup, theta_lookup,
                                   frame)
    d, e_x, e_y = frame.d, frame.e_x, frame.e_y
    vd = vx * d[0] + vy * d[1] + vz * d[2]
    nan = jnp.asarray(jnp.nan, vx.dtype)
    vd_safe = jnp.where(vd > 1e-12, vd, 1.0)
    bx = jnp.where(vd > 1e-12,
                   (vx * e_x[0] + vy * e_x[1] + vz * e_x[2]) / vd_safe,
                   nan)
    by = jnp.where(vd > 1e-12,
                   (vx * e_y[0] + vy * e_y[1] + vz * e_y[2]) / vd_safe,
                   nan)
    return bx, by


def world_escape_beta(metric, r_e, theta_f, phi_f, p_r_f, p_th_f, xi,
                      escaped, theta_obs):
    """Side-EXACT gnomonic source coordinates from the raw escape
    state, bypassing the (final_alpha, theta) chart.

    The reference's angle chart (metrics.py:363-416, arccos of one
    component) collapses which azimuthal side of the BH direction the
    ray escaped on — harmless for rendering parity (and invisible for
    symmetric metrics), but source-plane products that PAIR images
    (time delays) or resolve asymmetric caustics (Kerr) need the true
    side. Here the full escape vector is rebuilt from the localized
    state at the escape sphere r_e through the metric's own
    contravariant components, and projected on the observer's
    BH-centered screen basis: d = -r_hat(theta_obs), e_x = +phi_hat,
    e_y = -theta_hat (the sign convention is pinned against the
    collapsed chart on non-crossing rays in tests/test_timedelay_map.py).
    Exact at any observer inclination. Returns (bx, by), NaN where not
    escaped or outside the front-hemisphere tangent chart.
    """
    dtype = theta_f.dtype
    r_b = jnp.full_like(theta_f, r_e)
    (g_tt_i, g_tphi_i, g_rr_i, g_thth_i, g_phiphi_i,
     *_rest) = metric._inv_terms(r_b, theta_f)
    p_t = jnp.asarray(-1.0, dtype)
    dr = g_rr_i * p_r_f
    dth = g_thth_i * p_th_f
    dphi = g_tphi_i * p_t + g_phiphi_i * xi
    sin_th, cos_th = jnp.sin(theta_f), jnp.cos(theta_f)
    sin_ph, cos_ph = jnp.sin(phi_f), jnp.cos(phi_f)
    vx = (sin_th * cos_ph * dr + r_e * cos_th * cos_ph * dth
          - r_e * sin_th * sin_ph * dphi)
    vy = (sin_th * sin_ph * dr + r_e * cos_th * sin_ph * dth
          + r_e * sin_th * cos_ph * dphi)
    vz = cos_th * dr - r_e * sin_th * dth
    so = jnp.sin(jnp.asarray(theta_obs, dtype))
    co = jnp.cos(jnp.asarray(theta_obs, dtype))
    # d = -r_hat = (-so, 0, -co); e_x = phi_hat = (0, 1, 0);
    # e_y = -theta_hat = (-co, 0, so).
    vd = -(so * vx + co * vz)
    vex = vy
    vey = -co * vx + so * vz
    ok = escaped & (vd > 1e-12) & jnp.isfinite(vd)
    nan = jnp.asarray(jnp.nan, dtype)
    vd_safe = jnp.where(ok, vd, 1.0)
    return (jnp.where(ok, vex / vd_safe, nan),
            jnp.where(ok, vey / vd_safe, nan))


def image_gnomonic_grids(image_dimension, fov, psi=(0.0, 0.0),
                         dtype=jnp.float32, boost=None):
    """Per-pixel IMAGE-plane gnomonic coordinates about the BH
    direction: xb = (u.e_x)/(u.d), yb = (u.e_y)/(u.d) for the pinhole
    view direction u — the unlensed counterpart of the source chart
    (world_escape_beta / _source_plane_coords), so the identity map
    reads beta = (xb, yb) exactly. At psi = 0 this is just
    (x_cam, y_cam). NaN behind the tangent chart (u.d <= 0)."""
    from light_path_tracer_tpu.camera import _view_grids, aberrate_view

    vx, vy, vz = _view_grids(image_dimension, fov, dtype)
    vy = jnp.broadcast_to(vy, image_dimension)
    vx = jnp.broadcast_to(vx, image_dimension)
    vz = jnp.broadcast_to(vz, image_dimension)
    if boost is not None and any(float(b) != 0.0 for b in boost):
        vx, vy, vz = aberrate_view(vx, vy, vz, boost)
    frame = psi_frame(psi)
    d, e_x, e_y = frame.d, frame.e_x, frame.e_y
    vd = vx * d[0] + vy * d[1] + vz * d[2]
    nan = jnp.asarray(jnp.nan, vx.dtype)
    vd_safe = jnp.where(vd > 1e-12, vd, 1.0)
    xb = jnp.where(vd > 1e-12,
                   (vx * e_x[0] + vy * e_x[1] + vz * e_x[2]) / vd_safe,
                   nan)
    yb = jnp.where(vd > 1e-12,
                   (vx * e_y[0] + vy * e_y[1] + vz * e_y[2]) / vd_safe,
                   nan)
    return xb, yb


def lens_jacobian_decomposition(bx, by, xb, yb):
    """Convergence / shear / rotation maps of the traced lens map —
    the weak-lensing decomposition, computed exactly in the strong
    field (no reference counterpart; no thin-lens approximation).

    The lens map takes image-plane gnomonic coordinates (xb, yb)
    (image_gnomonic_grids — the pinhole chart reprojected about the
    BH direction, so it works at any psi/FOV) to source-plane
    gnomonic coordinates (bx, by) (world_escape_beta's side-exact
    chart; the two charts coincide for the identity map, pinned in
    tests/test_timedelay_map.py). Its Jacobian decomposes as

        A = dbeta/dx = [[1-kappa-gamma1,  -gamma2+omega],
                        [-gamma2-omega,   1-kappa+gamma1]]

    kappa: isotropic (de)focusing — 0 for vacuum rays of a point mass
    in the weak field (all distortion is tidal);
    gamma = (gamma1, gamma2): tidal shear, the point-lens oracle
    gamma = theta_E^2/theta^2 tangentially oriented;
    omega: image-plane ROTATION — zero in any static spacetime, and a
    direct frame-dragging observable for Kerr (the light bundle
    twists about the line of sight). Signed magnification
    mu = 1/det A, consistent with magnification_map up to the
    finite-difference stencil.

    A = (dbeta/dpixel) (dx/dpixel)^{-1} with both pixel Jacobians by
    central differences on the same grid (jnp.gradient; one-sided at
    edges, NaN within one pixel of the shadow). Returns
    (kappa, gamma1, gamma2, omega), each (H, W).
    """
    dbx_dpy, dbx_dpx = jnp.gradient(bx)
    dby_dpy, dby_dpx = jnp.gradient(by)
    dxb_dpy, dxb_dpx = jnp.gradient(xb)
    dyb_dpy, dyb_dpx = jnp.gradient(yb)
    det_x = dxb_dpx * dyb_dpy - dxb_dpy * dyb_dpx
    tiny = jnp.asarray(1e-30, bx.dtype)
    safe = jnp.where(jnp.abs(det_x) < tiny,
                     jnp.where(det_x < 0, -tiny, tiny), det_x)
    # A = B X^{-1}, X^{-1} = adj(X)/det(X).
    a11 = (dbx_dpx * dyb_dpy - dbx_dpy * dyb_dpx) / safe
    a12 = (dbx_dpy * dxb_dpx - dbx_dpx * dxb_dpy) / safe
    a21 = (dby_dpx * dyb_dpy - dby_dpy * dyb_dpx) / safe
    a22 = (dby_dpy * dxb_dpx - dby_dpx * dxb_dpy) / safe
    kappa = 1.0 - (a11 + a22) / 2.0
    gamma1 = -(a11 - a22) / 2.0
    gamma2 = -(a12 + a21) / 2.0
    omega = (a21 - a12) / 2.0
    return kappa, gamma1, gamma2, omega


def fermat_tau(metric, r_e, theta_f, phi_f, p_r_f, p_th_f, xi,
               t_hit, escaped):
    """Plane-wave-referenced (Fermat) arrival time per ray.

    The raw coordinate time t at the escape sphere r_e is dominated by
    geometry; referencing each ray to the plane wave of its own escape
    direction, tau = t - X.v_hat (X = escape position, v = escape
    coordinate velocity, both BH-centered Cartesian), leaves the Fermat
    arrival time up to a global constant — differences of tau between
    rays imaging the SAME source position are the physical delays
    (pipeline.render_time_delay builds the full-grid map from this; the
    weak-field Refsdal oracle is pinned in tests/test_timedelay_map.py).
    NaN where not escaped.
    """
    dtype = theta_f.dtype
    r_b = jnp.full_like(theta_f, r_e)
    (g_tt_i, g_tphi_i, g_rr_i, g_thth_i, g_phiphi_i,
     *_rest) = metric._inv_terms(r_b, theta_f)
    p_t = jnp.asarray(-1.0, dtype)
    dr = g_rr_i * p_r_f
    dth = g_thth_i * p_th_f
    dphi = g_tphi_i * p_t + g_phiphi_i * xi
    sin_th, cos_th = jnp.sin(theta_f), jnp.cos(theta_f)
    sin_ph, cos_ph = jnp.sin(phi_f), jnp.cos(phi_f)
    vx = (sin_th * cos_ph * dr + r_e * cos_th * cos_ph * dth
          - r_e * sin_th * sin_ph * dphi)
    vy = (sin_th * sin_ph * dr + r_e * cos_th * sin_ph * dth
          + r_e * sin_th * cos_ph * dphi)
    vz = cos_th * dr - r_e * sin_th * dth
    v_mag = jnp.sqrt(vx * vx + vy * vy + vz * vz)
    v_safe = jnp.maximum(v_mag, 1e-30)
    xdotv = r_e * (sin_th * cos_ph * vx + sin_th * sin_ph * vy
                   + cos_th * vz) / v_safe
    return jnp.where(escaped, t_hit - xdotv, jnp.nan)


def _image_solid_angle(image_dimension, fov, dtype):
    """|image-plane solid angle| per pixel of the pinhole view grid."""
    from light_path_tracer_tpu.camera import _view_grids

    ux, uy, uz = _view_grids(image_dimension, fov, dtype)
    uy = jnp.broadcast_to(uy, image_dimension)
    ux = jnp.broadcast_to(ux, image_dimension)
    uz = jnp.broadcast_to(uz, image_dimension)
    return jnp.abs(_solid_angle_element(ux, uy, uz))


def source_plane_map(bx, by, image_dimension, fov, beta_max,
                     bins: int = 256):
    """Source-plane magnification (caustic) map by inverse ray
    shooting — the standard microlensing construction (Kayser,
    Refsdal & Stabell 1986) on the strong-field traced rays.

    Every escaped image-plane pixel carries its solid angle
    |dOmega_img| to its source position (beta_x, beta_y) (gnomonic
    chart about the BH direction); binning the arrivals and dividing
    by the source-plane solid angle of each bin gives the TOTAL
    magnification A(beta) summed over all images (primary, secondary,
    higher winding orders). Caustics appear as the ridges where A
    diverges: a point caustic at beta = 0 for Schwarzschild, the
    displaced/deformed structure for Kerr. Far field: A -> 1 where the
    camera FOV covers all images of the bin (bins mapping partly
    outside the FOV read low — use beta_max well inside the FOV
    half-angle).

    Takes the per-pixel gnomonic source coordinates (bx, by) — from
    `world_escape_beta` (side-exact, the production path) or
    `_source_plane_coords` (the reference-parity collapsed chart;
    identical for symmetric metrics).

    Returns (A, extent): A (bins, bins) float32, row i = beta_y,
    col j = beta_x; extent = (-beta_max, beta_max) in radians both
    axes (matplotlib imshow convention: extent=(left, right, bottom,
    top) = (-b, b, b, -b) for origin="upper").
    """
    dtype = bx.dtype
    a_img = _image_solid_angle(image_dimension, fov, dtype)

    # Cloud-in-cell (bilinear) deposition — the standard smoothing of
    # inverse-ray-shooting codes: each ray's weight is split over the
    # four bins around its landing point, which suppresses the moire
    # pattern a nearest-bin histogram shows when the trace grid is
    # only a few rays per bin.
    width = 2.0 * beta_max / bins
    fx = (bx + beta_max) / width - 0.5
    fy = (by + beta_max) / width - 0.5
    ix0 = jnp.floor(fx)
    iy0 = jnp.floor(fy)
    tx = fx - ix0
    ty = fy - iy0
    finite = jnp.isfinite(bx) & jnp.isfinite(by)
    acc = jnp.zeros(bins * bins, dtype)
    for dy_, dx_ in ((0, 0), (0, 1), (1, 0), (1, 1)):
        gx = ix0 + dx_
        gy = iy0 + dy_
        wgt = (tx if dx_ else 1.0 - tx) * (ty if dy_ else 1.0 - ty)
        valid = (finite & (gx >= 0) & (gx < bins)
                 & (gy >= 0) & (gy < bins))
        flat = jnp.where(valid, gy * bins + gx, 0.0).astype(jnp.int32)
        w = jnp.where(valid, a_img * wgt, 0.0).ravel()
        acc = acc.at[flat.ravel()].add(w)
    acc = acc.reshape(bins, bins)

    # Exact gnomonic solid-angle measure of each bin, at bin centers:
    # dOmega = dbx dby / (1 + bx^2 + by^2)^(3/2).
    centers = (jnp.arange(bins, dtype=dtype) + 0.5) * width - beta_max
    cx = centers[None, :]
    cy = centers[:, None]
    d_omega = width * width / (1.0 + cx * cx + cy * cy) ** 1.5
    return (acc / d_omega).astype(jnp.float32), (-beta_max, beta_max)


def microlens_light_curve(bx, by, image_dimension, fov, track,
                          source_radius):
    """Total magnification A(t) of a finite circular source moving
    along `track` ((T, 2) source positions (beta_x, beta_y), radians)
    — the microlensing light curve, by direct inverse-ray-shooting
    reduction (no source-plane binning: each frame sums the
    image-plane solid angle landing within the source disk and
    divides by the disk's solid angle).

    A Gaussian-tapered disk window (sigma = source_radius / 2,
    truncated at 2 sigma = the radius) suppresses pixel-boundary
    aliasing; the window is normalized on the source plane so an
    unlensed field reads A = 1 exactly in the continuum limit. For a
    point lens the curve matches the classic
    A(u) = (u^2 + 2) / (u sqrt(u^2 + 4)) (Paczynski 1986) — pinned in
    tests/test_microlens.py.

    Takes per-pixel (bx, by) as source_plane_map does. Returns (T,)
    float32.
    """
    dtype = bx.dtype
    a_img = _image_solid_angle(image_dimension, fov, dtype)
    valid = jnp.isfinite(bx) & jnp.isfinite(by)
    bx = jnp.where(valid, bx, 1e6)
    by = jnp.where(valid, by, 1e6)
    # Per-ray gnomonic Jacobian (1 + beta^2)^(3/2): converts arriving
    # SOLID ANGLE to tangent-plane area, so the flat-plane window
    # normalization below is exact at any track position (without it
    # the curve reads (1 + beta^2)^(-3/2) low — ~10% at 15 degrees).
    jac = (1.0 + bx * bx + by * by) ** 1.5
    w_img = jnp.where(valid, a_img * jac, 0.0).ravel()
    bx = bx.ravel()
    by = by.ravel()

    track = jnp.asarray(track, dtype)
    r = jnp.asarray(source_radius, dtype)
    sigma = r / 2.0

    # Window normalization: integral of the truncated Gaussian over
    # the source plane = 2 pi sigma^2 (1 - e^{-r^2/(2 sigma^2)}).
    norm = 2.0 * jnp.pi * sigma * sigma * (
        1.0 - jnp.exp(-(r * r) / (2.0 * sigma * sigma)))

    def one(pos):
        dx = bx - pos[0]
        dy = by - pos[1]
        d2 = dx * dx + dy * dy
        win = jnp.where(d2 <= r * r,
                        jnp.exp(-d2 / (2.0 * sigma * sigma)), 0.0)
        return jnp.sum(w_img * win) / norm

    return jax.vmap(one)(track).astype(jnp.float32)


def magnification_display(mu, clip_percentile: float = 99.5):
    """Display encoding for a signed magnification map: symmetric
    log-compression sign(mu) * log10(1 + |mu|) on a diverging RdBu_r
    colormap (critical curves deep red, odd-parity images blue),
    percentile-clipped so the divergence doesn't wash out the far
    field; shadow (NaN) black. Returns (H, W, 4) float RGBA — the one
    recipe shared by the CLI and the showcase."""
    import numpy as np_
    import matplotlib.cm as cm

    mu_np = np_.asarray(mu)
    disp = np_.sign(mu_np) * np_.log10(1.0 + np_.abs(mu_np))
    finite = np_.isfinite(disp)
    lim = (np_.percentile(np_.abs(disp[finite]), clip_percentile)
           if finite.any() else 1.0)
    if not np_.isfinite(lim) or lim <= 0.0:
        lim = 1.0
    scaled = np_.where(finite, disp, 0.0)
    rgba = cm.RdBu_r(0.5 * (np_.clip(scaled / lim, -1.0, 1.0) + 1.0))
    rgba[~finite] = (0.0, 0.0, 0.0, 1.0)
    return rgba
