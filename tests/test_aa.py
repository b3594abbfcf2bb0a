"""Supersampled-AA tests: offsets, boundary smoothing, mesh tiling."""

import pytest
import numpy as np
import jax.numpy as jnp

from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
from light_path_tracer_tpu.aa import (
    aa_offsets, render_shadow_aa, render_scene_aa)
from light_path_tracer_tpu.parallel.mesh import make_mesh


def test_aa_offsets():
    assert aa_offsets(1).shape == (1, 2)
    assert np.all(aa_offsets(1) == 0)
    o4 = aa_offsets(4)
    assert o4.shape == (4, 2)
    assert np.all(np.abs(o4) <= 0.5)
    o8 = aa_offsets(8)
    assert o8.shape == (8, 2)
    assert len({tuple(r) for r in np.round(o8, 6)}) == 8  # distinct


def test_shadow_aa_smooths_boundary():
    scene = SceneConfig(M=1.0, a=0.0, r_obs_mult=100.0)
    img1, _ = render_shadow_aa(scene, (48, 48),
                               RenderConfig(dtype="float64"), aa_samples=1)
    img4, s4 = render_shadow_aa(scene, (48, 48),
                                RenderConfig(dtype="float64"), aa_samples=4)
    img1, img4 = np.asarray(img1), np.asarray(img4)
    # 1-sample image is binary; 4-sample must have fractional coverage
    # pixels on the shadow boundary.
    assert set(np.unique(img1)).issubset({0.0, 1.0})
    frac = (img4 > 0.01) & (img4 < 0.99)
    assert frac.sum() > 0
    # Interiors agree.
    assert abs(float(img1.mean()) - float(img4.mean())) < 0.02
    assert s4["aa_samples"] == 4
    assert s4["total_rays"] == 48 * 48 * 4


@pytest.mark.slow
def test_shadow_aa_on_mesh_matches_single_device():
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0)
    cfg = RenderConfig(dtype="float64")
    mesh = make_mesh()
    img_m, s_m = render_shadow_aa(scene, (24, 32), cfg, aa_samples=2,
                                  mesh=mesh)
    img_1, _ = render_shadow_aa(scene, (24, 32), cfg, aa_samples=2,
                                mesh=None)
    assert s_m["n_devices"] == 8
    np.testing.assert_array_equal(np.asarray(img_m), np.asarray(img_1))


@pytest.mark.slow
def test_aa_tb_symmetry_exact_single_sample():
    """aa_samples=1 has offset (0,0) — flip-closed — so the symmetric
    (half-trace) render must match the full-trace render: the mirrored
    rows evaluate the physically identical ray, so at most razor-edge
    critical-curve pixels may flip by integration roundoff."""
    for height in (24, 25):          # even + odd row counts
        scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0)
        img_tb, s_tb = render_shadow_aa(
            scene, (height, 32), RenderConfig(dtype="float64"),
            aa_samples=1)
        img_full, s_full = render_shadow_aa(
            scene, (height, 32),
            RenderConfig(dtype="float64", use_tb_symmetry=False),
            aa_samples=1)
        img_tb, img_full = np.asarray(img_tb), np.asarray(img_full)
        assert (img_tb != img_full).mean() <= 1.0 / 256.0
        assert s_tb["traced_rays"] == (height // 2 + 1) * 32
        assert s_full["traced_rays"] == height * 32
        # Mirror-filled rows are exact copies: rows r and H-r identical.
        rows = height // 2 + 1
        np.testing.assert_array_equal(
            img_tb[rows:], img_tb[1:height - rows + 1][::-1])


@pytest.mark.slow
def test_aa_tb_symmetry_close_multi_sample():
    """With a non-flip-closed pattern (RG4) the bottom half samples at
    mirrored offsets — an equally-valid 4x pattern: images agree except
    possibly sub-level coverage differences on boundary pixels."""
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0)
    img_tb, s_tb = render_shadow_aa(
        scene, (32, 32), RenderConfig(dtype="float64"), aa_samples=4)
    img_full, _ = render_shadow_aa(
        scene, (32, 32),
        RenderConfig(dtype="float64", use_tb_symmetry=False),
        aa_samples=4)
    img_tb, img_full = np.asarray(img_tb), np.asarray(img_full)
    assert s_tb["traced_rays"] == 17 * 32 * 4
    # Traced rows are identical.
    np.testing.assert_allclose(img_tb[:17], img_full[:17], atol=1e-12)
    # Mirror-filled rows: identical coverage except boundary pixels,
    # where the two (equally valid) sample patterns may disagree by
    # coverage quanta; never by a full pixel.
    diff = np.abs(img_tb[17:] - img_full[17:])
    assert diff.max() <= 0.5 + 1e-12
    assert (diff > 1e-12).mean() < 0.05


def test_aa_tb_symmetry_skipped_off_equator():
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    _img, stats = render_shadow_aa(
        scene, (16, 16), RenderConfig(dtype="float64"), aa_samples=2)
    assert stats["traced_rays"] == 16 * 16 * 2   # no halving


@pytest.mark.slow
def test_scene_aa_tb_symmetry_close():
    """Lensed AA render with mirror symmetry stays close to the full
    trace on a smooth texture (boundary pixels sample mirrored offsets)."""
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    src = np.stack([np.sin(2 * np.pi * yy), np.cos(2 * np.pi * xx),
                    yy * xx], axis=-1).astype(np.float32) * 0.5 + 0.5
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0)
    img_tb, s_tb = render_scene_aa(
        scene, src, RenderConfig(dtype="float64"), aa_samples=2)
    img_full, _ = render_scene_aa(
        scene, src, RenderConfig(dtype="float64", use_tb_symmetry=False),
        aa_samples=2)
    img_tb, img_full = np.asarray(img_tb), np.asarray(img_full)
    assert s_tb["traced_rays"] == 17 * 32 * 2
    # Identical away from sub-pixel pattern differences; the winding
    # palette / sentinel pixels can flip whole colors at the photon ring,
    # so gate the bulk, not the max.
    close = np.isclose(img_tb, img_full, atol=0.05)
    assert close.mean() > 0.97


def test_scene_aa_render():
    rng = np.random.default_rng(0)
    src = rng.random((32, 48, 3)).astype(np.float32)
    scene = SceneConfig(M=1.0, a=0.0, r_obs_mult=100.0)
    img, stats = render_scene_aa(scene, src, RenderConfig(dtype="float64"),
                                 aa_samples=2)
    img = np.asarray(img)
    assert img.shape == src.shape
    assert np.isfinite(img).all()
    assert stats["aa_samples"] == 2


@pytest.mark.slow
def test_disk_aa_smooths_inner_edge():
    """AA disk render: same gross structure as the 1-sample render but
    with strictly more intermediate (partial-coverage) pixel values on
    the sharp disk boundary."""
    import numpy as np
    from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
    from light_path_tracer_tpu.disk import (render_disk, render_disk_aa,
                                            DiskConfig)

    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        vertical_fov_deg=24.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64")
    img1, st1 = render_disk(scene, (40, 56), cfg, DiskConfig())
    img4, st4 = render_disk_aa(scene, (40, 56), cfg, DiskConfig(),
                               aa_samples=4)
    img1, img4 = np.asarray(img1), np.asarray(img4)
    assert st4["aa_samples"] == 4 and st4["traced_rays"] == 4 * 40 * 56
    assert np.isfinite(img4).all()
    # Bulk agrees (same scene)...
    assert np.abs(img4 - img1).mean() < 0.05
    # ...but the boundary gains partial-coverage values: count pixels
    # that are neither near-zero nor near the local max.
    def partial(im):
        return ((im > 0.02) & (im < 0.35)).sum()
    assert partial(img4) > partial(img1)


@pytest.mark.slow
def test_composite_aa_smooths_and_matches_bulk():
    import numpy as np
    from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
    from light_path_tracer_tpu.disk import (render_scene_with_disk,
                                            render_scene_with_disk_aa,
                                            DiskConfig)
    # Smooth background: a noise texture would make the comparison
    # meaningless (any subpixel shift resamples a random texel —
    # BASELINE.md accuracy targets, note 1).
    yy, xx = np.mgrid[0:36, 0:48].astype(np.float32)
    src = np.stack([0.5 + 0.4 * np.sin(yy / 8.0),
                    0.5 + 0.4 * np.cos(xx / 9.0),
                    0.5 + 0.2 * np.sin((xx + yy) / 11.0)],
                   axis=-1).astype(np.float32)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype="float64")
    img1, st1 = render_scene_with_disk(scene, src, cfg, DiskConfig())
    img4, st4 = render_scene_with_disk_aa(scene, src, cfg, DiskConfig(),
                                          aa_samples=4)
    img1, img4 = np.asarray(img1), np.asarray(img4)
    assert st4["aa_samples"] == 4
    assert st4["disk_pixels"] >= st1["disk_pixels"]
    assert np.isfinite(img4).all()
    assert np.abs(img4 - img1).mean() < 0.08   # same scene in bulk
    assert np.abs(img4 - img1).max() > 0.05    # boundaries smoothed
