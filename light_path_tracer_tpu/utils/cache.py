"""Persistent XLA compilation cache.

First compiles of the big tracer programs take seconds to minutes;
caching them on disk makes every later process (CLI runs, bench, the
smoke test) start faster. Safe to call multiple times.

Where the cache lives:
  * JAX_COMPILATION_CACHE_DIR, when set. JAX reads that variable itself,
    so nothing here sets a directory or touches that one.
  * Otherwise DEFAULT_CACHE_DIR: ``.jax_cache`` at the root of the
    checkout, resolved from this file's location (not the working
    directory), so every process of one checkout shares one cache.

Host guard (own directory only): CPU-backend cache entries embed
AOT-compiled machine code for the EXACT host CPU — deserializing an
entry written on a different machine segfaults the process inside
jax.compilation_cache.get_executable_and_time. enable_compilation_cache
therefore fingerprints the machine (CPU model + flags + jax/jaxlib
versions) into a marker file and wipes DEFAULT_CACHE_DIR when the
fingerprint changes; a cold cache costs recompiles, a stale one costs
the process.
"""

from __future__ import annotations

import hashlib
import os
import shutil

_FINGERPRINT_FILE = "host_fingerprint"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def _machine_fingerprint() -> str:
    import platform

    parts = [platform.machine(), platform.system()]
    try:
        import jax
        import jaxlib
        parts += [jax.__version__, jaxlib.__version__]
    except Exception:
        pass
    try:
        with open("/proc/cpuinfo") as f:
            info = f.read()
        for key in ("model name", "flags"):
            for line in info.splitlines():
                if line.startswith(key):
                    parts.append(line)
                    break
    except OSError:
        pass
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _guard_host_change(path: str) -> None:
    marker = os.path.join(path, _FINGERPRINT_FILE)
    fp = _machine_fingerprint()
    try:
        with open(marker) as f:
            stale = f.read().strip() != fp
    except OSError:
        # No marker: a pre-guard cache may hold foreign entries — treat
        # as unknown provenance and start clean once.
        stale = len(os.listdir(path)) > 0
    if stale:
        for entry in os.listdir(path):
            if entry == _FINGERPRINT_FILE:
                continue
            full = os.path.join(path, entry)
            try:
                if os.path.isdir(full):
                    shutil.rmtree(full, ignore_errors=True)
                else:
                    os.unlink(full)
            except OSError:
                pass
    try:
        with open(marker, "w") as f:
            f.write(fp)
    except OSError:
        pass


def enable_compilation_cache() -> None:
    import jax

    if os.environ.get("LPT_COMPILE_CACHE_OFF"):
        # Hard opt-out (tests/conftest.py sets it): the persistent-cache
        # writer has segfaulted mid-suite under pytest, and test
        # processes should not write compiled programs at all.
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return   # JAX already caches there; that directory is not ours
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    _guard_host_change(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
