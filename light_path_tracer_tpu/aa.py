"""Supersampled (jittered-AA) rendering, tiled across a device mesh.

BASELINE.json config 5: a 4k supersampled render (4x jittered AA) tiled
across a device mesh with shard_map. Each AA pass shifts the pinhole grid by
a subpixel offset (rotated-grid pattern for 4x, golden-ratio sequence
beyond). ALL passes are traced as ONE batch (the offset grids are
stacked along the row axis), so the whole supersampled render is a
single compile + a single trace dispatch instead of one dispatch per
offset. Row-sharded over the mesh when
one is given; averaging happens on device in float32; only the final
image leaves the device.

Top/bottom mirror symmetry (the reference's work-halving trick for its
non-AA path, image_lens.py:218-229) extends to supersampling: when the
scene is equatorially symmetric (theta_obs = pi/2, psi_y = 0 — the Kerr
metric is invariant under theta -> pi - theta), only rows 0..H//2 of
every AA pass are traced and the remaining rows are mirror-filled. A
bottom pixel's reconstructed sample sits at the *flipped* subpixel
offset (-dy, dx) — a sample pattern of identical quality (the mirror
image of the top pattern), and its value is exact by the scene
symmetry, so the averaged image is a true n-sample AA render at about
half the traced rays.

Pairing note: the camera convention maps row r to screen coordinate
y = r - H/2 (reference parity, camera.py), so the optical axis y = 0
sits ON row H/2 and the physical mirror pairs rows r <-> H - r with
row 0 unpaired — hence rows 0..H//2 (H//2 + 1 rows) are traced. The
reference's own non-AA fold instead mirrors about the grid center
y = -1/2 (rows r <-> H-1-r, image_lens.py:272-276), a one-row
approximation that pipeline.py reproduces for parity; the AA path uses
the exact pairing.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from light_path_tracer_tpu import camera
from light_path_tracer_tpu.ops.batch import trace_batch
from light_path_tracer_tpu.parallel.tiles import trace_grid_sharded
from light_path_tracer_tpu.render import render_lensed_image
from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
from light_path_tracer_tpu.utils.timing import StageTimer

# Rotated-grid 4x pattern (pixels); further samples from a golden-ratio
# low-discrepancy sequence.
_RG4 = np.array([(-0.125, -0.375), (0.375, -0.125),
                 (-0.375, 0.125), (0.125, 0.375)])


def aa_offsets(n_samples: int):
    """(n, 2) array of (dy, dx) subpixel offsets."""
    if n_samples == 1:
        return np.zeros((1, 2))
    if n_samples <= 4:
        return _RG4[:n_samples]
    g = 0.6180339887498949
    extra = np.stack([
        (np.arange(n_samples - 4) * g) % 1.0 - 0.5,
        (np.arange(n_samples - 4) * g * g) % 1.0 - 0.5], axis=1)
    return np.concatenate([_RG4, extra])


def _use_tb(metric, scene, cfg) -> bool:
    """Equatorial mirror symmetry applies (single source of truth:
    pipeline._use_tb — a condition added to one copy but not the other
    would silently mirror-fill rows whose true values differ)."""
    from light_path_tracer_tpu.pipeline import _use_tb as _pipe_use_tb
    return _pipe_use_tb(scene, cfg)


def _stacked_grids(metric, scene, cfg, resolution, fov, offsets,
                   trace_rows=None):
    """Per-offset camera grids stacked on the row axis: (S*T, W).

    trace_rows=T limits each pass to its top T rows (the mirror-symmetry
    path); None means full passes (T = H).
    """
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    alphas, thetas = [], []
    for offset in offsets:
        al = camera.build_alpha_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost,
            pixel_offset=tuple(offset))
        alphas.append(al if trace_rows is None else al[:trace_rows])
        if not metric.is_spherically_symmetric:
            th = camera.build_theta_lookup(
                resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost,
                pixel_offset=tuple(offset))
            thetas.append(th if trace_rows is None else th[:trace_rows])
    alpha = jnp.concatenate(alphas, axis=0)
    theta = (jnp.concatenate(thetas, axis=0)
             if thetas else None)
    return alpha, theta


def _mirror_fill(top, height):
    """(S, R, W) traced rows 0..R-1 -> (S, H, W) via the equatorial mirror.

    R = H//2 + 1. Bottom row r (r >= R) holds the value traced at row
    H - r of the SAME pass — physically the sample at subpixel offset
    (-dy, dx) of this pixel (module docstring pairing note), whose traced
    value equals it exactly by the scene symmetry.
    """
    n_bottom = height - top.shape[1]
    bottom = top[:, 1:n_bottom + 1][:, ::-1]
    return jnp.concatenate([top, bottom], axis=1)


def _trace_all_passes(metric, scene, cfg, resolution, fov, offsets, mesh):
    """Trace every AA pass in one batch; returns per-pass (S, H, W)
    alpha / theta / final_alpha / winding / status stacks plus the traced
    ray count. theta is None for spherically-symmetric metrics.

    Under equatorial mirror symmetry (_use_tb) only rows 0..H//2 of each
    pass are traced; bottom rows are mirror-filled (module docstring).
    The returned alpha/theta stacks are rebuilt for the *actual* sample
    each pixel carries — the flipped-offset (-dy, dx) sample in the
    bottom rows — so renderers see consistent (position, angle) pairs.
    """
    n_s = len(offsets)
    height, width = resolution
    use_tb = _use_tb(metric, scene, cfg)
    trace_rows = height // 2 + 1 if use_tb else height
    alpha, theta = _stacked_grids(metric, scene, cfg, resolution, fov,
                                  offsets, trace_rows=trace_rows)

    if mesh is not None:
        import jax
        if jax.process_count() > 1:
            # Global (multi-process) mesh: every process passes the same
            # full grids; devices trace their own rows; one allgather
            # assembles identical results on every host
            # (parallel/multihost.py — config 5 multi-host).
            from light_path_tracer_tpu.parallel.multihost import (
                trace_grid_multihost)
            fa, nh, st = trace_grid_multihost(
                metric, scene.r_obs, np.asarray(alpha),
                None if theta is None else np.asarray(theta),
                theta_obs=scene.theta_obs, mesh=mesh,
                max_steps=cfg.max_steps, backend=cfg.backend)
            fa, nh, st = (jnp.asarray(x) for x in (fa, nh, st))
        else:
            fa, nh, st = trace_grid_sharded(
                metric, scene.r_obs, alpha, theta,
                theta_obs=scene.theta_obs, mesh=mesh,
                max_steps=cfg.max_steps)
    else:
        # All passes in ONE dispatch up to ~8M rays (whole-batch
        # amortization); larger batches fall back to one pass-sized
        # chunk per dispatch, bounding device memory: all
        # chunks share one compiled kernel (identical shapes — the
        # round-1 per-offset loop recompiled per offset).
        chunk = cfg.chunk_size
        if chunk is None and n_s > 1 and alpha.size > 8_000_000:
            chunk = trace_rows * width
        res = trace_batch(
            metric, scene.r_obs, alpha.ravel(),
            None if theta is None else theta.ravel(),
            scene.theta_obs, chunk_size=chunk, sort_by_difficulty=False,
            max_steps=cfg.max_steps, backend=cfg.backend,
            precision=cfg.precision)
        fa = res.final_alpha.reshape(alpha.shape)
        nh = res.n_half_orbits.reshape(alpha.shape)
        st = res.status.reshape(alpha.shape)

    shape = (n_s, trace_rows, width)
    alpha = alpha.reshape(shape)
    theta = None if theta is None else theta.reshape(shape)
    fa, nh, st = (x.reshape(shape) for x in (fa, nh, st))
    if use_tb:
        fa = _mirror_fill(fa, height)
        nh = _mirror_fill(nh, height)
        st = _mirror_fill(st, height)
        # Angle grids for the renderer: rebuild so bottom rows carry the
        # angles of the actual (-dy, dx) sample they hold.
        dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        alphas, thetas = [], []
        for offset in offsets:
            flipped = (-offset[0], offset[1])
            al_t = camera.build_alpha_lookup(
                resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost,
                pixel_offset=tuple(offset))
            al_b = camera.build_alpha_lookup(
                resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost,
                pixel_offset=flipped)
            alphas.append(jnp.concatenate(
                [al_t[:trace_rows], al_b[trace_rows:]], axis=0))
            if theta is not None:
                th_t = camera.build_theta_lookup(
                    resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost,
                    pixel_offset=tuple(offset))
                th_b = camera.build_theta_lookup(
                    resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost,
                    pixel_offset=flipped)
                thetas.append(jnp.concatenate(
                    [th_t[:trace_rows], th_b[trace_rows:]], axis=0))
        alpha = jnp.stack(alphas)
        theta = jnp.stack(thetas) if thetas else None
    return alpha, theta, fa, nh, st, n_s * trace_rows * width


def render_shadow_aa(scene: SceneConfig, resolution,
                     cfg: RenderConfig = RenderConfig(),
                     aa_samples: int = 4, mesh=None):
    """Anti-aliased integrated shadow; returns (image float32, stats).

    The shadow boundary (the only high-frequency feature) gets smooth
    coverage values in [0, 1] instead of binary aliasing.
    """
    metric = scene.metric()
    timer = StageTimer()
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    offsets = aa_offsets(aa_samples)

    with timer.stage("precompute") as out:
        _alpha, _theta, fa, _nh, _st, traced = _trace_all_passes(
            metric, scene, cfg, resolution, fov, offsets, mesh)
        acc = jnp.where(jnp.isnan(fa), 0.0, 1.0).sum(axis=0)
        out.append(acc)
    with timer.stage("render") as out:
        img = (acc / aa_samples).astype(jnp.float32)
        out.append(img)

    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs),
        total_rays=resolution[0] * resolution[1] * aa_samples,
        traced_rays=traced,
        aa_samples=aa_samples,
        n_devices=1 if mesh is None else int(mesh.devices.size),
        timings=timer.finish())
    return img, stats


def render_scene_aa(scene: SceneConfig, source_image,
                    cfg: RenderConfig = RenderConfig(),
                    aa_samples: int = 4, mesh=None):
    """Anti-aliased lensed render; returns (image, stats)."""
    metric = scene.metric()
    timer = StageTimer()
    src = jnp.asarray(source_image)
    if src.dtype == jnp.uint8:
        src = src.astype(jnp.float32) / 255.0
    resolution = src.shape[:2]
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    offsets = aa_offsets(aa_samples)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

    acc = jnp.zeros(src.shape, src.dtype)
    with timer.stage("precompute+render") as out:
        alpha_s, theta_s, fa_s, nh_s, _st, traced = _trace_all_passes(
            metric, scene, cfg, resolution, fov, offsets, mesh)
        use_tb = _use_tb(metric, scene, cfg)
        for i, offset in enumerate(offsets):
            # Per-pass theta: spliced by _trace_all_passes so bottom rows
            # carry the azimuth of the actual (mirrored-offset) sample.
            if theta_s is not None:
                theta = theta_s[i]
            else:
                theta = camera.build_theta_lookup(
                    resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost,
                    pixel_offset=tuple(offset))
                if use_tb:
                    # Match the mirrored fa: bottom rows hold the
                    # (-dy, dx) sample — use that sample's azimuth.
                    rows = resolution[0] // 2 + 1
                    theta_b = camera.build_theta_lookup(
                        resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost,
                        pixel_offset=(-offset[0], offset[1]))
                    theta = jnp.concatenate(
                        [theta[:rows], theta_b[rows:]], axis=0)
            lensed = render_lensed_image(
                src, alpha_s[i], fa_s[i], nh_s[i].astype(jnp.uint16),
                metric.alpha_crit(scene.r_obs), fov,
                cfg.render_loop_around, psi=scene.psi,
                theta_lookup=theta, sampling=cfg.sampling)
            acc = acc + lensed
        out.append(acc)

    img = (acc / aa_samples).astype(src.dtype)
    stats = dict(
        total_rays=resolution[0] * resolution[1] * aa_samples,
        traced_rays=traced,
        aa_samples=aa_samples,
        n_devices=1 if mesh is None else int(mesh.devices.size),
        timings=timer.finish())
    return img, stats
