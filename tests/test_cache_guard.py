"""The persistent XLA compilation cache (utils/cache.py): where it lives
with JAX_COMPILATION_CACHE_DIR set and unset, and the host-change guard
on its own directory — CPU-backend entries embed machine code for the
exact host CPU, and deserializing a foreign entry segfaults the process,
so the guard must wipe on fingerprint mismatch (or unknown provenance)
and keep entries on a matching host."""

import os
import subprocess
import sys

import pytest

from light_path_tracer_tpu.utils import cache
from light_path_tracer_tpu.utils.cache import (
    enable_compilation_cache, _machine_fingerprint, _FINGERPRINT_FILE)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_jax_cache_config():
    """enable_compilation_cache flips PROCESS-WIDE jax config (cache
    dir + min-compile-time threshold). Without restoring it, every
    later test in the suite serializes its >2s CPU executables into
    this module's pytest tmp dir — XLA:CPU executable serialization
    has been observed to SEGFAULT the suite (put_executable_and_time)
    under full-suite load, and CI must not depend on that fragile AOT
    export path at all."""
    import jax
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", old_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      old_min)


@pytest.fixture(autouse=True)
def _own_cache_dir(monkeypatch):
    """conftest.py hard-disables the persistent cache for the whole
    suite (LPT_COMPILE_CACHE_OFF); these tests exercise the enable path
    itself, so lift the opt-out locally — with the program's own
    directory, not the variable."""
    monkeypatch.delenv("LPT_COMPILE_CACHE_OFF", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)


def _point_at(monkeypatch, path):
    monkeypatch.setattr(cache, "DEFAULT_CACHE_DIR", str(path))
    return str(path)


def _populate(path, name="jit_foo-cache"):
    os.makedirs(os.path.join(path, name), exist_ok=True)
    with open(os.path.join(path, name, "blob"), "wb") as f:
        f.write(b"\x00" * 16)


def test_optout_env_is_a_noop(tmp_path, monkeypatch):
    """With LPT_COMPILE_CACHE_OFF set (as conftest does for the whole
    suite), enable_compilation_cache must neither touch the directory
    nor flip jax config — this is what keeps cli/serve entry points
    cache-free under pytest."""
    import jax
    c = _point_at(monkeypatch, tmp_path / "c0")
    monkeypatch.setenv("LPT_COMPILE_CACHE_OFF", "1")
    before = jax.config.jax_compilation_cache_dir
    enable_compilation_cache()
    assert not os.path.exists(c)
    assert jax.config.jax_compilation_cache_dir == before


def test_wipes_on_fingerprint_mismatch(tmp_path, monkeypatch):
    c = _point_at(monkeypatch, tmp_path / "c1")
    os.makedirs(c)
    _populate(c)
    with open(os.path.join(c, _FINGERPRINT_FILE), "w") as f:
        f.write("not-this-machine")
    enable_compilation_cache()
    assert not os.path.exists(os.path.join(c, "jit_foo-cache"))
    with open(os.path.join(c, _FINGERPRINT_FILE)) as f:
        assert f.read().strip() == _machine_fingerprint()


def test_wipes_unknown_provenance(tmp_path, monkeypatch):
    # Pre-guard cache: entries but no marker -> start clean once.
    c = _point_at(monkeypatch, tmp_path / "c2")
    os.makedirs(c)
    _populate(c)
    enable_compilation_cache()
    assert not os.path.exists(os.path.join(c, "jit_foo-cache"))


def test_keeps_entries_on_matching_host(tmp_path, monkeypatch):
    import jax
    c = _point_at(monkeypatch, tmp_path / "c3")
    enable_compilation_cache()          # writes the marker
    assert jax.config.jax_compilation_cache_dir == c
    _populate(c)
    enable_compilation_cache()          # same host: must keep entries
    assert os.path.exists(os.path.join(c, "jit_foo-cache", "blob"))


def test_fingerprint_is_stable():
    assert _machine_fingerprint() == _machine_fingerprint()


def test_env_dir_is_left_to_jax_and_never_wiped(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: no directory is set in code and the
    variable's directory is never wiped, even with a foreign marker."""
    import jax
    env_dir = str(tmp_path / "env")
    os.makedirs(env_dir)
    _populate(env_dir)
    with open(os.path.join(env_dir, _FINGERPRINT_FILE), "w") as f:
        f.write("not-this-machine")
    own = _point_at(monkeypatch, tmp_path / "own")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    before = jax.config.jax_compilation_cache_dir
    enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert os.path.exists(os.path.join(env_dir, "jit_foo-cache", "blob"))
    assert not os.path.exists(own)


def _run(code, cwd, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env)
    full.pop("LPT_COMPILE_CACHE_OFF", None)
    for k, v in env.items():
        if v is None:
            full.pop(k)
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=full,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def test_entry_point_keeps_env_cache_dir(tmp_path):
    """An entry point (the CLI) started with JAX_COMPILATION_CACHE_DIR=x
    leaves jax_compilation_cache_dir == x."""
    x = str(tmp_path / "x")
    code = ("import jax\n"
            "from light_path_tracer_tpu.cli.app import main\n"
            "import light_path_tracer_tpu.cli.shadow as s\n"
            "seen = []\n"
            "s.cmd_shadow = lambda a: seen.append("
            "jax.config.jax_compilation_cache_dir) or 0\n"
            "main(['shadow', '--size', '8', '--analytic', '--output', "
            f"{str(tmp_path / 's.png')!r}])\n"
            "print(seen[0])\n")
    assert _run(code, str(tmp_path), JAX_COMPILATION_CACHE_DIR=x) == x


def test_default_dir_is_under_checkout_whatever_cwd(tmp_path):
    """Unset: the cache is <checkout>/.jax_cache, from any cwd."""
    code = ("from light_path_tracer_tpu.utils import cache\n"
            "print(cache.DEFAULT_CACHE_DIR)\n")
    got = _run(code, str(tmp_path), JAX_COMPILATION_CACHE_DIR=None)
    assert got == os.path.join(REPO, ".jax_cache")
