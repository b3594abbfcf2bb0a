"""360-degree equirectangular panorama renders (VR skyboxes / domes).

New capability beyond the reference (whose only camera is the pinhole
model, /root/reference/image_lens.py:72-126): the ENTIRE celestial sphere
around the observer, lensed through the black hole, rendered to one
equirectangular (longitude x latitude) frame — the chart VR viewers,
planetarium pipelines, and environment-map tooling consume directly.

Chart convention (camera coords +x right, +y down, +z forward, matching
camera.py / image_lens.py:29-35):

  * pixel centers sit at (px + 0.5, py + 0.5) of an (H, W) grid
    (W should be 2H for the standard 2:1 equirect aspect, but any
    aspect is accepted — the chart just samples lon/lat uniformly);
  * longitude  lon = (px + 0.5) / W * 2*pi - pi, wrapping in x,
    lon = 0 on the camera's +z (forward) axis, lon = +pi/2 on +x;
  * latitude   lat = pi/2 - (py + 0.5) / H * pi, clamped in y,
    row 0 = the zenith (-y, "up"), the middle row = the horizon.

The view direction of a pixel is therefore

    v = (cos(lat) sin(lon), -sin(lat), cos(lat) cos(lon)).

Everything downstream of the chart is the existing machinery: per-pixel
(alpha, theta) about the BH direction feed the SAME batched tracers as
the pinhole pipeline (ops/batch.trace_batch), the top/bottom mirror fold
applies row-for-row (lat -> -lat is exactly the pinhole fold's
y_cam -> -y_cam equatorial mirror), and escaped rays gather from an
equirectangular SOURCE sky by the inverse chart.

One deliberate semantic divergence from the pinhole renderer
(render.py / image_lens.py:322-336): the `final_alpha > pi/2 -> winding
palette` rule does not apply. That rule exists because the pinhole
background is a forward-hemisphere image — rays returning at > 90 degrees
have nowhere to sample. The full-sphere chart has a texel for EVERY
escape direction, so every escaped ray gathers; the palette is available
as an opt-in overlay (`winding_overlay=True`) for photon-ring
visualization.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu import camera
from light_path_tracer_tpu.ops.batch import trace_batch
from light_path_tracer_tpu.render import (WINDING_COLORS, _LUMA,
                                          _bilinear_gather)
from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
from light_path_tracer_tpu.utils.timing import StageTimer


# ---- the equirect chart ----

def pano_directions(image_dimension, dtype=jnp.float32):
    """Unit view-direction component grids (vx, vy, vz), each (H, W)."""
    height, width = image_dimension
    lon = ((jnp.arange(width, dtype=dtype) + 0.5) / width * (2 * np.pi)
           - np.pi)
    # Bottom rows built as exact negations of the top rows, so the
    # equatorial mirror (the tb-symmetry fold) is bitwise on the CHART;
    # in real numbers lat(H-1-i) = -lat(i) already, this just removes
    # the last-ulp asymmetry of evaluating pi/2 - x twice.
    half = (height + 1) // 2
    lat_top = (np.pi / 2
               - (jnp.arange(half, dtype=dtype) + 0.5) / height * np.pi)
    lat = jnp.concatenate([lat_top, -lat_top[:height // 2][::-1]])
    cos_lat = jnp.cos(lat)[:, None]
    vx = cos_lat * jnp.sin(lon)[None, :]
    vy = jnp.broadcast_to((-jnp.sin(lat))[:, None], (height, width))
    vz = cos_lat * jnp.cos(lon)[None, :]
    return vx, vy, vz


def pano_pixel_coords(vx, vy, vz, image_dimension):
    """Inverse chart: directions -> continuous (px, py) source coords.

    Exact inverse of pano_directions at pixel centers (rint lands back on
    the same integer index). Longitude wraps; latitude clamps.
    """
    height, width = image_dimension
    lon = jnp.arctan2(vx, vz)
    lat = jnp.arcsin(jnp.clip(-vy, -1.0, 1.0))
    px = (lon + np.pi) / (2 * np.pi) * width - 0.5
    py = (np.pi / 2 - lat) / np.pi * height - 0.5
    return px, py


def build_pano_lookups(image_dimension, psi=(0.0, 0.0), dtype=jnp.float32,
                       boost=None):
    """Per-pixel (alpha, theta) about the BH direction for the equirect
    chart — the pano analogue of camera.build_alpha_lookup /
    build_theta_lookup, same (alpha, theta) convention as the tracers.

    `boost` aberrates each pixel's view direction into the static frame
    first (camera.aberrate_view), exactly like the pinhole builders.
    """
    frame = camera.psi_frame(psi)
    vx, vy, vz = pano_directions(image_dimension, dtype)
    if boost is not None and any(float(b) != 0.0 for b in boost):
        vx, vy, vz = camera.aberrate_view(vx, vy, vz, boost)
    d, e_x, e_y = frame.d, frame.e_x, frame.e_y
    cos_alpha = vx * d[0] + vy * d[1] + vz * d[2]
    alpha = jnp.arccos(jnp.clip(cos_alpha, -1.0, 1.0))
    theta = jnp.arctan2(vx * e_x[0] + vy * e_x[1] + vz * e_x[2],
                        vx * e_y[0] + vy * e_y[1] + vz * e_y[2])
    return alpha.astype(dtype), theta.astype(dtype)


def pano_refine_mask(alpha, theta, refine_frac=0.07):
    """Boolean pole-risk band for the equirect chart.

    The pinhole band (camera.axis_refine_columns, image_lens.py:210-216)
    marks pixels whose view direction lies near the VERTICAL plane
    through the BH — where conserved L -> 0 rays cross the polar axis.
    The angular distance from that plane is asin(sin(alpha) |sin(theta)|);
    a 2*pi-FOV chart can't use the column rule directly (0.07 of 2*pi
    would be a quarter of the sky), so the band is defined in angle:
    refine_frac * pi half-width — what the column rule gives a pinhole
    at FOV ~ pi, and strictly wider than any typical pinhole band, so
    the pano is never looser than the pinhole render of the same scene.
    """
    band = np.sin(min(refine_frac * np.pi, np.pi / 2))
    return jnp.sin(alpha) * jnp.abs(jnp.sin(theta)) < band


def grid_sky(image_dimension, n_lat=18, n_lon=36):
    """Procedural equirect test sky: a lat/lon graticule over a two-tone
    gradient, so lensing distortion is visible without an image asset
    (the CLI's --grid-sky). Returns (H, W, 3) float32 in [0, 1]."""
    height, width = image_dimension
    py, px = np.mgrid[0:height, 0:width]
    lat_t = (py + 0.5) / height          # 0 at zenith, 1 at nadir
    lon_t = (px + 0.5) / width
    # gradient: deep blue at the poles, warm near the horizon
    horizon = 1.0 - np.abs(lat_t - 0.5) * 2.0
    sky = np.stack([0.15 + 0.55 * horizon,
                    0.20 + 0.35 * horizon,
                    0.45 + 0.25 * (1.0 - horizon)], axis=-1)
    # graticule lines (1 px): white meridians, light parallels
    on_lon = (px * n_lon) // width != ((px + 1) * n_lon) // width
    on_lat = (py * n_lat) // height != ((py + 1) * n_lat) // height
    sky[on_lat] = (0.8, 0.8, 0.8)
    sky[on_lon] = (1.0, 1.0, 1.0)
    # mark the forward (+z) axis with a red patch for orientation
    fy, fx = height // 2, width // 2
    r = max(1, height // 64)
    sky[max(0, fy - r):fy + r, max(0, fx - r):fx + r] = (1.0, 0.1, 0.1)
    return sky.astype(np.float32)


# ---- renderer ----

def _pano_render_core(source_pano, theta_lookup, final_alpha_lookup,
                      winding_lookup, d, e_x, e_y, sampling="nearest",
                      winding_overlay=False):
    """Equirect renderer body: shadow stays black, every escaped ray
    gathers from the source sky by the inverse chart (no sentinel — the
    full sphere is in bounds)."""
    height, width = source_pano.shape[:2]
    grayscale = source_pano.ndim == 2
    channels = 1 if grayscale else source_pano.shape[2]
    src = source_pano if not grayscale else source_pano[..., None]
    compute_dtype = final_alpha_lookup.dtype

    valid = jnp.isfinite(final_alpha_lookup)
    fa = jnp.where(valid, final_alpha_lookup, 0.0).astype(compute_dtype)
    th = theta_lookup.astype(compute_dtype)

    # Escape direction in the static camera frame (same reconstruction
    # as render._render_core / image_lens.py:338-352).
    sin_fa, cos_fa = jnp.sin(fa), jnp.cos(fa)
    sin_th, cos_th = jnp.sin(th), jnp.cos(th)
    sx = sin_th * e_x[0] + cos_th * e_y[0]
    sy = sin_th * e_x[1] + cos_th * e_y[1]
    sz = sin_th * e_x[2] + cos_th * e_y[2]
    src_vx = cos_fa * d[0] + sin_fa * sx
    src_vy = cos_fa * d[1] + sin_fa * sy
    src_vz = cos_fa * d[2] + sin_fa * sz

    px, py = pano_pixel_coords(src_vx, src_vy, src_vz, (height, width))
    src_flat = src.reshape(height * width, channels)
    if sampling == "bilinear":
        texture = _bilinear_gather(src_flat, px, py, height, width,
                                   channels, wrap=(False, True))
    else:
        if sampling != "nearest":
            raise ValueError(f"sampling must be 'nearest' or "
                             f"'bilinear', got {sampling!r}")
        src_x = jnp.mod(jnp.rint(px).astype(jnp.int32), width)
        src_y = jnp.clip(jnp.rint(py).astype(jnp.int32), 0, height - 1)
        texture = src_flat[src_y * width + src_x]

    out = jnp.where(valid[..., None], texture,
                    jnp.zeros((), src.dtype))
    if winding_overlay:
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
        ring = valid & (winding_lookup.astype(jnp.int32) >= 1)
        out = jnp.where(ring[..., None],
                        palette[w_idx].astype(src.dtype), out)
    return out[..., 0] if grayscale else out


def render_pano_image(source_pano, final_alpha_lookup, winding_lookup,
                      psi=(0.0, 0.0), theta_lookup=None,
                      sampling="nearest", winding_overlay=False):
    """Render an equirect output frame from traced lookup tables.

    `source_pano` is the equirect sky (H, W[, C]); the output chart has
    the same shape as `final_alpha_lookup` (which need not match the
    source resolution).
    """
    if theta_lookup is None:
        _, theta_lookup = build_pano_lookups(
            final_alpha_lookup.shape, psi=psi,
            dtype=final_alpha_lookup.dtype)
    if winding_lookup is None:
        winding_lookup = jnp.zeros(final_alpha_lookup.shape, jnp.int32)
    return _render_pano_kernel(
        jnp.asarray(source_pano), jnp.asarray(theta_lookup),
        jnp.asarray(final_alpha_lookup), jnp.asarray(winding_lookup),
        tuple(psi), str(sampling), bool(winding_overlay))


@functools.partial(
    jax.jit, static_argnames=("psi", "sampling", "winding_overlay"))
def _render_pano_kernel(source_pano, theta_lookup, final_alpha_lookup,
                        winding_lookup, psi, sampling, winding_overlay):
    frame = camera.psi_frame(psi)
    return _pano_render_core(source_pano, theta_lookup,
                             final_alpha_lookup, winding_lookup,
                             frame.d, frame.e_x, frame.e_y,
                             sampling, winding_overlay)


# ---- pipeline driver ----

@dataclasses.dataclass
class PanoOutput:
    image: object                 # (H, W[, C]) lensed equirect frame
    final_alpha: object           # (H, W) float32, NaN = shadow
    winding: object               # (H, W) uint16
    alpha_crit: float
    total_rays: int
    traced_rays: int
    integrator_steps: object
    timings: dict
    scene: SceneConfig
    render_cfg: RenderConfig


def _use_tb(scene: SceneConfig, cfg: RenderConfig) -> bool:
    # Same conditions as the pinhole fold (pipeline._use_tb): the
    # equirect rows mirror exactly under lat -> -lat for an equatorial
    # observer with no vertical BH offset and no vertical boost.
    return (cfg.use_tb_symmetry
            and bool(np.isclose(scene.theta_obs, np.pi / 2))
            and bool(np.isclose(scene.psi[0], 0.0))
            and float(scene.boost[1]) == 0.0)


def _pano_precompute(scene, cfg, image_dimension, mesh=None):
    """Trace one ray per chart pixel -> (final_alpha, winding, steps).

    jit-safe for the whole-grid path (no mesh, no chunking/progress);
    the mesh path shards rows over devices via parallel/tiles.
    """
    metric = scene.metric()
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    height, width = image_dimension
    alpha, theta = build_pano_lookups(image_dimension, psi=scene.psi,
                                      dtype=dtype, boost=scene.boost)
    use_tb = _use_tb(scene, cfg)
    trace_rows = (height + 1) // 2 if use_tb else height

    if mesh is not None:
        from light_path_tracer_tpu.parallel.tiles import trace_grid_sharded
        fa_rows, orb_rows, _status = trace_grid_sharded(
            metric, scene.r_obs, alpha[:trace_rows],
            None if metric.is_spherically_symmetric
            else theta[:trace_rows],
            scene.theta_obs,
            None if metric.is_spherically_symmetric
            else pano_refine_mask(alpha[:trace_rows], theta[:trace_rows],
                                  cfg.axis_refine_frac),
            mesh=mesh, max_steps=cfg.max_steps, phi_max=cfg.phi_max,
            h_max=cfg.h_max, backend=cfg.backend)
        fa_rows = fa_rows.astype(jnp.float32)
        w_rows = jnp.clip(orb_rows, 0, cfg.winding_max).astype(jnp.uint16)
        steps = jnp.asarray(0, jnp.int32)
    elif metric.is_spherically_symmetric:
        res = trace_batch(
            metric, scene.r_obs, alpha[:trace_rows].ravel(),
            chunk_size=cfg.chunk_size, phi_max=cfg.phi_max,
            h_max=cfg.h_max, backend=cfg.backend, progress=cfg.progress)
        fa_rows = res.final_alpha.reshape(
            (trace_rows, width)).astype(jnp.float32)
        w_rows = jnp.clip(res.n_half_orbits, 0, cfg.winding_max).astype(
            jnp.uint16).reshape((trace_rows, width))
        steps = res.n_steps
    else:
        refine = pano_refine_mask(alpha[:trace_rows], theta[:trace_rows],
                                  cfg.axis_refine_frac)
        res = trace_batch(
            metric, scene.r_obs, alpha[:trace_rows].ravel(),
            theta[:trace_rows].ravel(), scene.theta_obs, refine.ravel(),
            chunk_size=cfg.chunk_size,
            sort_by_difficulty=cfg.sort_by_difficulty,
            max_steps=cfg.max_steps, backend=cfg.backend,
            integrator=cfg.integrator, event_interp=cfg.event_interp,
            formulation=cfg.formulation, precision=cfg.precision,
            progress=cfg.progress)
        fa_rows = res.final_alpha.reshape(
            (trace_rows, width)).astype(jnp.float32)
        w_rows = jnp.clip(res.n_half_orbits, 0, cfg.winding_max).astype(
            jnp.uint16).reshape((trace_rows, width))
        steps = res.n_steps

    if use_tb:
        bottom = height - trace_rows   # rows mirrored from the top
        fa = jnp.full((height, width), jnp.nan, jnp.float32)
        wind = jnp.zeros((height, width), jnp.uint16)
        fa = fa.at[:trace_rows].set(fa_rows)
        wind = wind.at[:trace_rows].set(w_rows)
        if bottom > 0:
            fa = fa.at[trace_rows:].set(fa[:bottom][::-1])
            wind = wind.at[trace_rows:].set(wind[:bottom][::-1])
    else:
        fa, wind = fa_rows, w_rows
    return fa, wind, steps, trace_rows * width


@functools.partial(
    jax.jit, static_argnames=("scene", "cfg", "image_dimension",
                              "winding_overlay"))
def _render_pano_fused(scene, cfg, image_dimension, img, winding_overlay):
    """Chart build + trace + symmetry fold + gather render as ONE jitted
    program — the pano analogue of pipeline._render_scene_fused."""
    fa, wind, steps, _traced = _pano_precompute(scene, cfg,
                                                image_dimension)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    _, theta_r = build_pano_lookups(
        image_dimension, psi=scene.psi,
        dtype=dtype if scene.boosted else fa.dtype,
        boost=scene.boost if scene.boosted else None)
    frame = camera.psi_frame(scene.psi)
    pano = _pano_render_core(img, theta_r, fa, wind, frame.d, frame.e_x,
                             frame.e_y, cfg.sampling, winding_overlay)
    return pano, fa, wind, steps


def render_panorama(scene: SceneConfig, source_pano,
                    resolution=None, cfg: RenderConfig = RenderConfig(),
                    winding_overlay=False, mesh=None) -> PanoOutput:
    """Full 360-degree lensed panorama of an equirect source sky.

    `resolution` defaults to the source sky's (H, W) (use 2:1 aspect for
    a standard equirect frame). `mesh` shards the trace row-wise over a
    device mesh (parallel/tiles layout rules apply); the default
    single-device path runs the whole pipeline as ONE fused XLA program.
    """
    metric = scene.metric()
    timer = StageTimer()
    src_shape = np.asarray(source_pano).shape
    if resolution is None:
        resolution = (int(src_shape[0]), int(src_shape[1]))
    resolution = (int(resolution[0]), int(resolution[1]))
    height, width = resolution
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs)

    with timer.stage("load_image") as out:
        img = jnp.asarray(source_pano)
        if img.dtype == jnp.uint8:
            img = img.astype(jnp.float32) / 255.0
        out.append(img)

    whole_grid = cfg.chunk_size is None or (
        cfg.chunk_size >= height * width)
    if mesh is None and whole_grid and not cfg.progress:
        with timer.stage("precompute") as out:
            pano, fa, wind, steps = _render_pano_fused(
                scene, cfg, resolution, img, bool(winding_overlay))
            out.append(pano)
        use_tb = _use_tb(scene, cfg)
        traced = ((height + 1) // 2 if use_tb else height) * width
        timings = timer.finish()
        timings.setdefault("build_lookup", 0.0)
        timings.setdefault("render", 0.0)
        return PanoOutput(pano, fa, wind, alpha_crit, height * width,
                          traced, steps, timings, scene, cfg)

    with timer.stage("precompute") as out:
        fa, wind, steps, traced = _pano_precompute(scene, cfg, resolution,
                                                   mesh=mesh)
        out.append((fa, wind))
    with timer.stage("render") as out:
        dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        _, theta_r = build_pano_lookups(
            resolution, psi=scene.psi,
            dtype=dtype if scene.boosted else fa.dtype,
            boost=scene.boost if scene.boosted else None)
        pano = render_pano_image(img, fa, wind, psi=scene.psi,
                                 theta_lookup=theta_r,
                                 sampling=cfg.sampling,
                                 winding_overlay=winding_overlay)
        out.append(pano)
    timings = timer.finish()
    timings.setdefault("build_lookup", 0.0)
    return PanoOutput(pano, fa, wind, alpha_crit, height * width, traced,
                      steps, timings, scene, cfg)
