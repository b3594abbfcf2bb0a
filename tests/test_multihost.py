"""Multi-host (multi-process) path: 2 CPU processes x 4 virtual devices.

The standard hardware-free recipe for validating jax.distributed: spawn
two real OS processes, each with 4 virtual CPU devices, joined through a
local coordinator with gloo collectives; the 8-device global-mesh render
must equal the single-process render (SURVEY.md §5).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from light_path_tracer_tpu.models import Kerr
from light_path_tracer_tpu import camera
from light_path_tracer_tpu.parallel.multihost import trace_grid_multihost
from light_path_tracer_tpu.parallel.mesh import make_mesh


pytestmark = pytest.mark.slow  # full-matrix lane: --runslow

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference_render():
    dim = (16, 16)
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    alpha = np.asarray(camera.build_alpha_lookup(dim, fov,
                                                 dtype=jnp.float64))
    theta = np.asarray(camera.build_theta_lookup(dim, fov,
                                                 dtype=jnp.float64))
    return trace_grid_multihost(
        Kerr(M=1.0, a=0.9), 100.0, alpha, theta,
        mesh=make_mesh(8), max_steps=20000)


def test_two_process_render_matches_single_process(tmp_path):
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(_WORKER))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH"), repo_root) if p)
    env.pop("XLA_FLAGS", None)

    outs = [str(tmp_path / f"proc{i}.npy") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), "2", str(port), outs[i]],
            env=env, cwd=os.path.dirname(os.path.dirname(_WORKER)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        logs.append(out.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    fa0 = np.load(outs[0])
    fa1 = np.load(outs[1])
    # Every process assembled the same global image.
    np.testing.assert_array_equal(fa0, fa1)

    # And it matches the single-process 8-virtual-device render.
    fa_ref, _nh, st_ref = _reference_render()
    st0 = np.load(outs[0].replace(".npy", "_status.npy"))
    np.testing.assert_array_equal(st0, np.asarray(st_ref))
    both = ~np.isnan(fa0) & ~np.isnan(np.asarray(fa_ref))
    np.testing.assert_allclose(fa0[both], np.asarray(fa_ref)[both],
                               rtol=0, atol=1e-12)
    assert (np.isnan(fa0) == np.isnan(np.asarray(fa_ref))).all()

    # Disk-mode trace: both processes agree, and match the
    # single-process sharded disk trace.
    dn0 = np.load(outs[0].replace(".npy", "_diskn.npy"))
    dn1 = np.load(outs[1].replace(".npy", "_diskn.npy"))
    np.testing.assert_array_equal(dn0, dn1)
    dr0 = np.load(outs[0].replace(".npy", "_diskr.npy"))

    from light_path_tracer_tpu.parallel.tiles import trace_disk_grid_sharded
    from light_path_tracer_tpu.disk import DiskConfig
    dim = (16, 16)
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    alpha = camera.build_alpha_lookup(dim, fov, dtype=jnp.float64)
    theta = camera.build_theta_lookup(dim, fov, dtype=jnp.float64)
    ref = trace_disk_grid_sharded(
        Kerr(M=1.0, a=0.9), 100.0, alpha, theta, np.radians(80.0),
        DiskConfig(), mesh=make_mesh(8), max_steps=20000, backend="xla")
    np.testing.assert_array_equal(dn0, np.asarray(ref.n_hits))
    hit = dn0 > 0
    assert hit.sum() > 5
    np.testing.assert_allclose(dr0[hit], np.asarray(ref.r_hits[0])[hit],
                               rtol=0, atol=1e-12)


def _run_cli_cluster(tmp_path, subcmd_args, n_procs, n_local_devices,
                     timeout=600):
    """Spawn n CLI processes forming a jax.distributed cluster; returns
    (returncodes, logs)."""
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(_WORKER))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH"), repo_root) if p)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{n_local_devices}")
    env["JAX_ENABLE_X64"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "light_path_tracer_tpu",
             *subcmd_args,
             "--multihost", "--coordinator", f"localhost:{port}",
             "--num-processes", str(n_procs), "--process-id", str(i)],
            env=env, cwd=repo_root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(n_procs)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost CLI cluster timed out")
        logs.append(out.decode(errors="replace"))
    return [p.returncode for p in procs], logs


def _run_cli_single(tmp_path, subcmd_args, timeout=600):
    repo_root = os.path.dirname(os.path.dirname(_WORKER))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH"), repo_root) if p)
    env.pop("XLA_FLAGS", None)
    env["JAX_ENABLE_X64"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "light_path_tracer_tpu", *subcmd_args],
        env=env, cwd=repo_root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=timeout)
    return proc.returncode, proc.stdout.decode(errors="replace")


def test_cli_multihost_lens_aa_two_procs(tmp_path):
    """Config 5's multi-host story driven ENTIRELY from the CLI: a
    supersampled lensed render on 2 processes x 4 virtual devices
    matches the plain single-process CLI render."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image as mpimg

    rng = np.random.default_rng(3)
    src = np.clip(rng.random((24, 32, 3)), 0, 1).astype(np.float32)
    bg = str(tmp_path / "bg.png")
    mpimg.imsave(bg, src)

    out_mh = str(tmp_path / "mh.png")
    rcs, logs = _run_cli_cluster(
        tmp_path,
        ["lens", "--a", "0.9", "--image", bg, "--aa", "2",
         "--dtype", "float64", "--output", out_mh],
        n_procs=2, n_local_devices=4)
    assert rcs == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    assert any("process 0/2" in log for log in logs)
    assert os.path.exists(out_mh)

    out_ref = str(tmp_path / "ref.png")
    rc, log = _run_cli_single(
        tmp_path, ["lens", "--a", "0.9", "--image", bg, "--aa", "2",
                   "--dtype", "float64", "--output", out_ref])
    assert rc == 0, log[-3000:]

    img_mh = mpimg.imread(out_mh)
    img_ref = mpimg.imread(out_ref)
    # PNG quantizes to 8 bits; the two paths must agree to that level.
    assert img_mh.shape == img_ref.shape
    assert np.abs(img_mh - img_ref).max() <= 2.5 / 255.0


def test_cli_multihost_shadow_three_procs_uneven_rows(tmp_path):
    """Second topology: 3 processes x 2 devices = 6-device mesh over a
    20-row grid (uneven: 20 % 6 != 0 — the padding path)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image as mpimg

    out_mh = str(tmp_path / "mh_shadow.png")
    rcs, logs = _run_cli_cluster(
        tmp_path,
        ["shadow", "--a", "0.9", "--size", "20", "--dtype", "float64",
         "--output", out_mh],
        n_procs=3, n_local_devices=2)
    assert rcs == [0, 0, 0], "".join(log[-2000:] for log in logs)
    assert any("process 0/3" in log for log in logs)

    # Reference: the SAME code path (render_shadow_aa over a global
    # mesh) as a 1-process "cluster" on a 6-device local mesh — the
    # plain `shadow` CLI uses the reference's one-row-off mirror fold,
    # which legitimately differs by a row (aa.py pairing note).
    out_ref = str(tmp_path / "ref_shadow.png")
    rcs1, logs1 = _run_cli_cluster(
        tmp_path,
        ["shadow", "--a", "0.9", "--size", "20", "--dtype", "float64",
         "--output", out_ref],
        n_procs=1, n_local_devices=6)
    assert rcs1 == [0], logs1[0][-3000:]
    img_mh = mpimg.imread(out_mh)
    img_ref = mpimg.imread(out_ref)
    np.testing.assert_array_equal(img_mh, img_ref)


def test_cli_multihost_init_timeout_clear_error(tmp_path):
    """A missing peer fails AT INITIALIZATION with a clear error inside
    --init-timeout, not a silent hang into the first collective."""
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(_WORKER))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH"), repo_root) if p)
    env.pop("XLA_FLAGS", None)
    # Claim 2 processes but start only process 1 (a non-coordinator, so
    # nothing is listening on the port at all).
    proc = subprocess.run(
        [sys.executable, "-m", "light_path_tracer_tpu", "shadow",
         "--size", "8", "--multihost",
         "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", "1",
         "--init-timeout", "5"],
        env=env, cwd=repo_root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=300)
    assert proc.returncode != 0
    log = proc.stdout.decode(errors="replace")
    assert ("initialization failed" in log or "DEADLINE_EXCEEDED" in log
            or "deadline" in log.lower() or "timed out" in log.lower()), \
        log[-3000:]


def test_peer_death_mid_render_fails_survivor(tmp_path):
    """Round-4 verdict item 7: kill one process between renders in a
    2-process cluster; the survivor's next cross-process collective
    must error out with a clear message in BOUNDED time (the
    heartbeat_timeout_s knob, 10 s in the worker) instead of hanging
    the job."""
    import time as _time

    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(_WORKER))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH"), repo_root) if p)
    env.pop("XLA_FLAGS", None)

    outs = [str(tmp_path / f"proc{i}.npy") for i in range(2)]
    modes = ["survive", "die"]   # proc 0 = coordinator stays up
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), "2", str(port), outs[i],
             modes[i]],
            env=env, cwd=repo_root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]

    t0 = _time.monotonic()
    logs = {}
    try:
        out1, _ = procs[1].communicate(timeout=600)
        logs[1] = out1.decode(errors="replace")
        # The dying worker must have completed render 1 and hard-exited.
        assert procs[1].returncode == 42, logs[1][-3000:]
        # The survivor must now FAIL its post-crash render within a
        # bounded window (heartbeat 10 s + detection/teardown grace),
        # not hang: generous bound far below the 100 s default it
        # would take without the knob, and far below "forever".
        out0, _ = procs[0].communicate(timeout=240)
        logs[0] = out0.decode(errors="replace")
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        pytest.fail("survivor hung after peer death "
                    f"(elapsed {_time.monotonic() - t0:.0f}s): "
                    + logs.get(1, "")[-2000:])

    log0 = logs[0]
    assert procs[0].returncode != 0, log0[-3000:]
    assert "post-crash render" in log0
    assert "UNEXPECTEDLY succeeded" not in log0
    # The failure is a clear distributed-runtime error, not a generic
    # crash: accept the usual vocabulary across jax/gloo versions.
    lowered = log0.lower()
    assert any(k in lowered for k in
               ("heartbeat", "disconnect", "unavailable", "peer",
                "connection", "shut down", "shutdown", "barrier",
                "timed out", "deadline")), log0[-3000:]

    # First render (pre-crash) completed and matches on both processes.
    fa0 = np.load(outs[0])
    fa1 = np.load(outs[1])
    np.testing.assert_array_equal(fa0, fa1)
