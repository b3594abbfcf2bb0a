"""Lookup-table checkpoint cache tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
from light_path_tracer_tpu.checkpoint import (
    cache_key, cached_precompute, save_lookup, load_lookup, cache_path)
from light_path_tracer_tpu import camera


def test_cache_key_sensitivity():
    scene = SceneConfig(M=1.0, a=0.5)
    cfg = RenderConfig()
    dim, fov = (32, 32), (0.7, 0.7)
    k0 = cache_key(scene, cfg, dim, fov)
    assert k0 == cache_key(scene, cfg, dim, fov)
    # Any physics/numerics change must change the key...
    assert k0 != cache_key(SceneConfig(M=1.0, a=0.6), cfg, dim, fov)
    assert k0 != cache_key(scene, RenderConfig(dtype="float64"), dim, fov)
    assert k0 != cache_key(scene, cfg, (64, 64), fov)
    assert k0 != cache_key(scene, cfg, dim, (0.8, 0.7))
    # ...but a render-only knob must NOT (tables are reusable).
    assert k0 == cache_key(scene, RenderConfig(render_loop_around=True),
                           dim, fov)


def test_save_load_roundtrip(tmp_path):
    fa = np.random.default_rng(0).random((8, 8)).astype(np.float32)
    fa[0, 0] = np.nan
    w = np.arange(64, dtype=np.uint16).reshape(8, 8)
    path = str(tmp_path / "x.npz")
    save_lookup(path, fa, w, {"traced_rays": 64})
    fa2, w2, meta = load_lookup(path)
    np.testing.assert_array_equal(np.asarray(fa2), fa)
    np.testing.assert_array_equal(np.asarray(w2), w)
    assert meta["traced_rays"] == 64
    assert load_lookup(str(tmp_path / "missing.npz")) is None
    # Corrupt file -> None, not a crash.
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    assert load_lookup(str(bad)) is None


@pytest.mark.slow
def test_cached_precompute_hit_matches_miss(tmp_path):
    scene = SceneConfig(M=1.0, a=0.7, r_obs_mult=100.0)
    cfg = RenderConfig(dtype="float64", chunk_size=None)
    dim = (16, 20)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    pre1, hit1 = cached_precompute(scene, cfg, dim, fov,
                                   cache_dir=str(tmp_path))
    pre2, hit2 = cached_precompute(scene, cfg, dim, fov,
                                   cache_dir=str(tmp_path))
    assert not hit1 and hit2
    np.testing.assert_array_equal(np.asarray(pre1.final_alpha),
                                  np.asarray(pre2.final_alpha))
    np.testing.assert_array_equal(np.asarray(pre1.winding),
                                  np.asarray(pre2.winding))
    assert pre2.traced_rays == pre1.traced_rays
    # A different spin misses.
    scene3 = SceneConfig(M=1.0, a=0.71, r_obs_mult=100.0)
    _pre3, hit3 = cached_precompute(scene3, cfg, dim, fov,
                                    cache_dir=str(tmp_path))
    assert not hit3


@pytest.mark.slow
def test_chunk_resume_after_crash(tmp_path, monkeypatch):
    """Kill a chunked precompute after 2 completed chunks; resuming
    loads those chunks from disk, re-traces only the rest, and matches a
    fresh run exactly."""
    import light_path_tracer_tpu.checkpoint as ckpt

    scene = SceneConfig(M=1.0, a=0.7, r_obs_mult=100.0)
    cfg = RenderConfig(dtype="float64", chunk_size=128, max_steps=20000)
    # 24x32 grid; tb-mirror symmetry traces 12 rows -> 384
    # rays -> 3 chunks of 128.
    dim = (24, 32)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)

    class CrashingStore(ckpt.ChunkStore):
        puts = 0

        def put(self, start, res):
            super().put(start, res)
            CrashingStore.puts += 1
            if CrashingStore.puts >= 2:
                raise KeyboardInterrupt("simulated crash")

    monkeypatch.setattr(ckpt, "ChunkStore", CrashingStore)
    with pytest.raises(KeyboardInterrupt):
        cached_precompute(scene, cfg, dim, fov, cache_dir=str(tmp_path),
                          resume=True)
    monkeypatch.undo()

    import os
    persisted = [f for f in os.listdir(tmp_path)
                 if f.startswith("chunks_")]
    assert len(persisted) == 2

    class CountingStore(ckpt.ChunkStore):
        puts = 0
        gets_hit = 0

        def put(self, start, res):
            CountingStore.puts += 1
            super().put(start, res)

        def get(self, start):
            res = super().get(start)
            if res is not None:
                CountingStore.gets_hit += 1
            return res

    monkeypatch.setattr(ckpt, "ChunkStore", CountingStore)
    pre_resumed, hit = cached_precompute(
        scene, cfg, dim, fov, cache_dir=str(tmp_path), resume=True)
    monkeypatch.undo()
    assert not hit
    assert CountingStore.gets_hit == 2      # resumed from disk
    assert CountingStore.puts == 1          # only the rest re-traced

    pre_fresh, _ = cached_precompute(
        scene, cfg, dim, fov, cache_dir=str(tmp_path / "fresh"),
        resume=True)
    np.testing.assert_array_equal(np.asarray(pre_resumed.final_alpha),
                                  np.asarray(pre_fresh.final_alpha))
    np.testing.assert_array_equal(np.asarray(pre_resumed.winding),
                                  np.asarray(pre_fresh.winding))
    # Per-chunk files are cleaned up once the whole table lands.
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith("chunks_")]


def test_resume_requires_chunking():
    scene = SceneConfig()
    cfg = RenderConfig(chunk_size=None)
    with pytest.raises(ValueError, match="chunk_size"):
        cached_precompute(scene, cfg, (8, 8), (0.1, 0.1), resume=True)


@pytest.mark.slow
def test_orbax_session_roundtrip(tmp_path):
    """Orbax render-session save/restore: tables round-trip exactly and
    a mismatched configuration is refused."""
    import numpy as np
    from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
    from light_path_tracer_tpu import camera
    from light_path_tracer_tpu.pipeline import precompute_final_alpha
    from light_path_tracer_tpu.checkpoint import save_session, load_session

    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0)
    cfg = RenderConfig(dtype="float64")
    dim = (16, 20)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    pre = precompute_final_alpha(scene, cfg, dim, fov)

    sess = tmp_path / "session"
    key = save_session(str(sess), scene, cfg, pre, dim, fov)
    assert (sess / "session.json").exists()

    pre2, meta = load_session(str(sess), scene, cfg, dim, fov)
    assert meta["key"] == key
    np.testing.assert_array_equal(np.asarray(pre2.final_alpha),
                                  np.asarray(pre.final_alpha,
                                             np.float32))
    np.testing.assert_array_equal(np.asarray(pre2.winding),
                                  np.asarray(pre.winding))
    assert pre2.total_rays == pre.total_rays

    # A different scene must be refused.
    other = SceneConfig(M=1.0, a=0.5, r_obs_mult=100.0)
    import pytest
    with pytest.raises(ValueError, match="mismatch"):
        load_session(str(sess), other, cfg, dim, fov)

    # Restore without verification still works.
    pre3, _ = load_session(str(sess))
    assert np.asarray(pre3.final_alpha).shape == dim
