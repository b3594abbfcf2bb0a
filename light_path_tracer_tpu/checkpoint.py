"""Lookup-table checkpointing: save/resume traced-ray tables.

The reference *planned* this (`lookup_cache.npz` in its .gitignore:23) but
never implemented it (SURVEY.md §5). Two layers are real here:

  * Whole-table cache: the per-pixel (final_alpha float32, winding uint16)
    tables — the expensive integration product — are cached keyed by every
    input that affects them, so re-renders with a new background image
    skip integration entirely (`cached_precompute`).
  * Chunk-level resume: with `resume=True` (requires cfg.chunk_size), each
    completed trace chunk is persisted as it finishes (`ChunkStore`), so
    an interrupted precompute resumes from the last completed chunk
    instead of starting over (tests/test_checkpoint.py proves
    resumed == fresh).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import jax.numpy as jnp

from light_path_tracer_tpu.ops.types import TraceResult
from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig

CACHE_VERSION = 2

# RenderConfig knobs that cannot change the traced tables — pure
# scheduling/verbosity (chunk_size also fixes chunk *boundaries* for the
# resume store, but boundaries do not change the assembled result) and
# render-stage-only knobs. Everything else (dtype, integrator, backend,
# tolerances via max_steps, ...) stays
# in the key.
_RESULT_IRRELEVANT_KNOBS = frozenset({
    "render_loop_around",   # renderer-only
    "progress",             # verbosity
    "chunk_size",           # scheduling
    "sort_by_difficulty",   # scheduling (inverse-permutation restores order)
})


def cache_key(scene: SceneConfig, cfg: RenderConfig, image_dimension,
              fov) -> str:
    """Deterministic key over everything that affects the traced tables."""
    payload = {
        "v": CACHE_VERSION,
        "scene": dataclasses.asdict(scene),
        "render": {k: v for k, v in dataclasses.asdict(cfg).items()
                   if k not in _RESULT_IRRELEVANT_KNOBS},
        "dim": list(image_dimension),
        "fov": [float(f) for f in fov],
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def cache_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"lookup_{key}.npz")


def save_lookup(path: str, final_alpha, winding, meta: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        final_alpha=np.asarray(final_alpha, np.float32),
        winding=np.asarray(winding, np.uint16),
        meta=json.dumps(meta or {}))


def load_lookup(path: str):
    """Returns (final_alpha, winding, meta) or None if absent/corrupt."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            fa = jnp.asarray(z["final_alpha"])
            w = jnp.asarray(z["winding"])
            meta = json.loads(str(z["meta"]))
        return fa, w, meta
    except Exception:
        return None


class ChunkStore:
    """On-disk store of completed trace chunks, keyed by chunk start index.

    ops/batch.trace_batch checks the store before tracing each chunk and
    persists each result as it completes (one small .npz per chunk —
    atomic-rename writes, so a kill mid-write never corrupts the store).
    Chunk identity is (trace-parameter key, start index); the difficulty
    sort inside trace_batch is deterministic, so a resumed run re-derives
    identical chunk contents.
    """

    def __init__(self, directory: str, key: str):
        self.directory = directory
        self.key = key
        os.makedirs(directory, exist_ok=True)

    def _path(self, start: int) -> str:
        return os.path.join(self.directory,
                            f"chunks_{self.key}_{start}.npz")

    def get(self, start: int):
        path = self._path(start)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                return TraceResult(
                    jnp.asarray(z["final_alpha"]),
                    jnp.asarray(z["n_half_orbits"]),
                    jnp.asarray(z["status"]),
                    jnp.asarray(int(z["n_steps"]), jnp.int32))
        except Exception:
            return None

    def put(self, start: int, res: TraceResult):
        path = self._path(start)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:   # file object: savez keeps the name
            np.savez(f,
                     final_alpha=np.asarray(res.final_alpha),
                     n_half_orbits=np.asarray(res.n_half_orbits),
                     status=np.asarray(res.status),
                     n_steps=np.asarray(res.n_steps, np.int64))
        os.replace(tmp, path)

    def chunk_starts(self):
        """Start indices of all completed chunks on disk."""
        prefix = f"chunks_{self.key}_"
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(prefix) and name.endswith(".npz"):
                try:
                    out.append(int(name[len(prefix):-4]))
                except ValueError:
                    pass
        return sorted(out)

    def clear(self):
        for start in self.chunk_starts():
            try:
                os.remove(self._path(start))
            except OSError:
                pass


def cached_precompute(scene: SceneConfig, cfg: RenderConfig,
                      image_dimension, fov, cache_dir: str = "lookup_cache",
                      resume: bool = False):
    """precompute_final_alpha with transparent on-disk caching.

    resume=True (requires cfg.chunk_size) additionally persists every
    completed chunk, so an interrupted run restarts from the last
    completed chunk; the per-chunk files are cleaned up once the whole
    table lands.

    Returns (PrecomputeResult, hit: bool).
    """
    from light_path_tracer_tpu.pipeline import (
        precompute_final_alpha, PrecomputeResult)

    key = cache_key(scene, cfg, image_dimension, fov)
    path = cache_path(cache_dir, key)
    hit = load_lookup(path)
    if hit is not None:
        fa, w, meta = hit
        if fa.shape == tuple(image_dimension):
            return PrecomputeResult(
                fa, w, int(meta.get("total_rays", fa.size)),
                int(meta.get("traced_rays", fa.size)),
                int(meta.get("integrator_steps", 0))), True

    store = None
    if resume:
        if cfg.chunk_size is None:
            raise ValueError("resume=True requires cfg.chunk_size")
        store = ChunkStore(cache_dir, key)

    pre = precompute_final_alpha(scene, cfg, image_dimension, fov,
                                 chunk_store=store)
    save_lookup(path, pre.final_alpha, pre.winding,
                dict(total_rays=pre.total_rays,
                     traced_rays=pre.traced_rays,
                     integrator_steps=pre.steps))
    if store is not None:
        store.clear()
    return pre, False


# ---- Orbax-backed render-session checkpoints ----

def save_session(directory: str, scene: SceneConfig, cfg: RenderConfig,
                 pre, image_dimension, fov) -> str:
    """Persist a full render session with Orbax.

    The traced tables go through orbax-checkpoint's StandardCheckpointer
    (atomic directory commit, versioned on-disk format, async-capable —
    the production checkpointing stack for JAX workloads); the scene /
    render configuration and the cache key ride alongside as JSON, so a
    restore can verify it matches the requesting configuration.

    Complements the npz whole-table cache (`cached_precompute`): use
    sessions when the artifact should be a durable, self-describing
    directory rather than an opportunistic cache entry.
    """
    import orbax.checkpoint as ocp

    directory = os.path.abspath(directory)
    key = cache_key(scene, cfg, image_dimension, fov)
    arrays = {
        "final_alpha": np.asarray(pre.final_alpha, np.float32),
        "winding": np.asarray(pre.winding, np.uint16),
    }
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.join(directory, "tables"), arrays, force=True)
    meta = {
        "key": key,
        "scene": dataclasses.asdict(scene),
        "render": dataclasses.asdict(cfg),
        "dim": list(image_dimension),
        "fov": [float(f) for f in fov],
        "total_rays": int(pre.total_rays),
        "traced_rays": int(pre.traced_rays),
        "integrator_steps": int(pre.steps),
    }
    with open(os.path.join(directory, "session.json"), "w") as fh:
        json.dump(meta, fh, indent=2, sort_keys=True)
    return key


def load_session(directory: str, scene: SceneConfig | None = None,
                 cfg: RenderConfig | None = None,
                 image_dimension=None, fov=None):
    """Restore an Orbax render session; returns (PrecomputeResult, meta).

    When scene/cfg/dim/fov are given, the stored cache key must match —
    a mismatch raises instead of silently serving stale physics.
    """
    import orbax.checkpoint as ocp
    from light_path_tracer_tpu.pipeline import PrecomputeResult

    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "session.json")) as fh:
        meta = json.load(fh)
    if scene is not None:
        if cfg is None or image_dimension is None or fov is None:
            raise ValueError(
                "key verification needs scene, cfg, image_dimension "
                "AND fov (or none of them for an unverified restore)")
        expect = cache_key(scene, cfg, image_dimension, fov)
        if expect != meta["key"]:
            raise ValueError(
                f"session key mismatch: stored {meta['key']}, "
                f"requested {expect} — the session was produced by a "
                f"different scene/render configuration")
    with ocp.StandardCheckpointer() as ckptr:
        arrays = ckptr.restore(os.path.join(directory, "tables"))
    pre = PrecomputeResult(
        jnp.asarray(arrays["final_alpha"]),
        jnp.asarray(np.asarray(arrays["winding"]).astype(np.uint16)),
        meta["total_rays"], meta["traced_rays"],
        meta["integrator_steps"])
    return pre, meta
