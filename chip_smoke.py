#!/usr/bin/env python
"""Smoke test of the tracer on the GPU, at the sizes its users render.

  python chip_smoke.py           # one card: every phase below but multi
  python chip_smoke.py --multi   # four cards: the 4k AA frame on a mesh

Phases (one process; each prints its wall and compile time and every
comparison beside its limit):

  device   JAX's first device is a GPU (no CPU fallback).
  shadow   CLI `shadow --a 0.9 --size 1024`, in process: PNG written,
           alpha_crit as printed by a CPU run of the same command; the
           1024^2 grid traced in f32 "fast" vs f64 reference tolerances
           on the card; 256 escaped pixels of the f64 trace vs the SciPy
           oracle (tests/oracles/numpy_reference.py) on the host.
  lens     pipeline.render_scene at 1024^2, Kerr a=0.9, numpy checkerboard
           source: f32 "gate" + bilinear vs f64 reference tolerances.
  disk     CLI `disk --a 0.9 --inclination 80 --size 1024`; f32 vs f64
           crossing records on the 1024^2 grid.
  kernel   the fused Pallas (Triton) kernel vs the XLA loop on the 1024^2
           Kerr grid and on the disk recorder, both compiled for the card.
  multi    (--multi only) 2160x3840 4x jittered-AA Kerr a=0.9 shadow on a
           4-card mesh vs the same render on one card, with each card's
           peak memory.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; it is printed only
when every phase passed. Exits non-zero (and prints no result) when JAX
finds no GPU, when the package is not next to this file, or when any
phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 1024
SPIN = 0.9
R_OBS = 100.0
MULTI_RES = (2160, 3840)        # the 4k frame of BASELINE.json config 5

# Limits, each with its source.
PRECISION_MASK_MIN = 0.999      # tests/test_precision.py:48
PRECISION_MEDIAN_MAX = 5e-4     # tests/test_precision.py:51 [rad]
PRECISION_P99_MAX = 2e-3        # tests/test_precision.py:52 [rad]
ORACLE_ABS_MAX = 1e-4           # tests/test_integrators.py:97 [rad]
ORACLE_RAYS = 256
LENS_RMSE_MAX = 1e-3            # BASELINE.json image gate
DISK_HIT_AGREE_MIN = 0.98       # test_disk.py::test_disk_pallas_matches_xla
# test_disk.py::test_crossing_momentum_null_condition_and_backends_agree
DISK_R_REL_MEDIAN_MAX = 2e-2    # (f32 vs f64, median, relative)
KERNEL_STATUS_MIN = 0.99        # kernel vs XLA status agreement
KERNEL_P99_MAX = 2e-3           # stable-population final angle [rad]
MULTI_DIFF_FRAC_MAX = 1e-4      # 4-card vs 1-card pixels that differ


class PhaseFailed(AssertionError):
    pass


def check(label, value, op, limit, note=""):
    ok = value > limit if op == ">" else value < limit if op == "<" \
        else value <= limit
    print(f"  {label}: {value!r} {op} {limit!r} "
          f"{'PASS' if ok else 'FAIL'}{'  ' + note if note else ''}",
          flush=True)
    if not ok:
        raise PhaseFailed(f"{label} = {value!r}, limit {op} {limit!r}")


def _block(x):
    """block_until_ready through dataclass results (RenderOutput)."""
    import dataclasses
    import jax
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _block(getattr(x, f.name))
    else:
        jax.block_until_ready(x)
    return x


def timed(fn, *args, **kwargs):
    """Run fn twice: (first wall incl. compile, second wall, result).
    The difference is the compile time (the first call compiles)."""
    t0 = time.perf_counter()
    _block(fn(*args, **kwargs))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _block(fn(*args, **kwargs))
    second = time.perf_counter() - t0
    return first, second, out


def report_time(what, first, second):
    print(f"  time {what}: first {first:.3f} s, steady {second:.3f} s, "
          f"compile ~{max(first - second, 0.0):.3f} s", flush=True)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run_cli(argv):
    """The CLI in process; returns its printed output."""
    from light_path_tracer_tpu.cli.app import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    print("  | " + text.strip().replace("\n", "\n  | "), flush=True)
    if rc != 0:
        raise PhaseFailed(f"CLI {argv[0]} exited {rc}")
    return text


def alpha_crit_printed(text):
    m = re.search(r"alpha_crit=(\S+) deg", text)
    if not m:
        raise PhaseFailed("CLI printed no alpha_crit")
    return m.group(1)


def grids(dtype):
    import jax.numpy as jnp
    from light_path_tracer_tpu import camera
    fov = camera.fov_from_vertical(np.radians(40.0), (SIZE, SIZE))
    al = camera.build_alpha_lookup((SIZE, SIZE), fov, dtype=dtype)
    th = camera.build_theta_lookup((SIZE, SIZE), fov, dtype=dtype)
    return fov, jnp.asarray(al, dtype), jnp.asarray(th, dtype)


def angle_errors(fa_a, fa_b):
    both = np.isfinite(fa_a) & np.isfinite(fa_b)
    return np.abs(fa_a - fa_b)[both]


# ---------------------------------------------------------------- phases

def phase_device(jax):
    dev = jax.devices()[0]
    print(f"  {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    if dev.platform != "gpu":
        raise PhaseFailed(f"first device is {dev.platform}, not gpu")


def phase_shadow(jax, tmp, cpu_run):
    import jax.numpy as jnp
    from light_path_tracer_tpu.models import Kerr
    from light_path_tracer_tpu.pipeline import precompute_final_alpha
    from light_path_tracer_tpu.utils.config import RenderConfig, SceneConfig
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.numpy_reference import (integrate_kerr_scipy,
                                         kerr_escape_angle)

    png = os.path.join(tmp, "shadow.png")
    argv = ["shadow", "--a", str(SPIN), "--size", str(SIZE),
            "--output", png]
    t0 = time.perf_counter()
    text = run_cli(argv)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(argv)
    report_time("CLI shadow 1024^2", first, time.perf_counter() - t0)
    if not os.path.getsize(png):
        raise PhaseFailed("shadow PNG not written")
    print(f"  PNG written: {os.path.getsize(png)} bytes")
    cpu_text = cpu_run()
    gpu_ac, cpu_ac = alpha_crit_printed(text), alpha_crit_printed(cpu_text)
    print(f"  alpha_crit printed: gpu {gpu_ac} deg, cpu {cpu_ac} deg "
          f"{'PASS' if gpu_ac == cpu_ac else 'FAIL'} (must be equal)")
    if gpu_ac != cpu_ac:
        raise PhaseFailed("alpha_crit differs from the CPU run")

    scene = SceneConfig(M=1.0, a=SPIN, r_obs_mult=R_OBS)
    fov, al64, th64 = grids(jnp.float64)
    pre = {}
    for dt in ("float32", "float64"):
        cfg = RenderConfig(dtype=dt)
        first, second, res = timed(
            lambda: precompute_final_alpha(scene, cfg, (SIZE, SIZE), fov))
        report_time(f"trace {dt} 1024^2", first, second)
        pre[dt] = np.asarray(res.final_alpha, np.float64)
    fa32, fa64 = pre["float32"], pre["float64"]
    check("captured-mask agreement f32 vs f64",
          float((np.isnan(fa32) == np.isnan(fa64)).mean()), ">",
          PRECISION_MASK_MIN)
    d = angle_errors(fa32, fa64)
    check("median |d alpha| f32 vs f64 [rad]", float(np.median(d)), "<",
          PRECISION_MEDIAN_MAX)
    check("p99 |d alpha| f32 vs f64 [rad]", float(np.percentile(d, 99)),
          "<", PRECISION_P99_MAX)

    # SciPy oracle on 256 random escaped, non-grazing pixels of the
    # traced rows (the rows below are the top/bottom mirror fold's
    # copies, image_lens.py:218-229, not traces of their own pixels).
    m = Kerr(M=1.0, a=SPIN)
    ac = m.alpha_crit(R_OBS)
    al_h, th_h = np.asarray(al64), np.asarray(th64)
    ok = np.isfinite(fa64) & (np.abs(al_h - ac) > 0.05 * ac)
    ok[(SIZE + 1) // 2:] = False
    pick = np.random.default_rng(0).choice(np.flatnonzero(ok.ravel()),
                                           ORACLE_RAYS, replace=False)
    a_s, t_s = al_h.ravel()[pick], th_h.ravel()[pick]
    (r0, q0, f0, pr0, pq0), p_t, p_phi, _ = m.initial_conditions_5d(
        R_OBS, jnp.asarray(a_s), jnp.asarray(t_s), np.pi / 2)
    y0 = np.stack([np.asarray(v, np.float64) for v in (r0, q0, f0, pr0,
                                                       pq0)], 1)
    p_t = np.broadcast_to(np.asarray(p_t, np.float64), (ORACLE_RAYS,))
    p_phi = np.asarray(p_phi, np.float64)
    t0 = time.perf_counter()
    errs, outcome_ok = [], 0
    for i in range(ORACLE_RAYS):
        y_f, outcome = integrate_kerr_scipy(1.0, SPIN, list(y0[i]),
                                            float(p_t[i]), float(p_phi[i]),
                                            R_OBS)
        if outcome == "escaped":
            outcome_ok += 1
            errs.append(abs(fa64.ravel()[pick[i]] - kerr_escape_angle(
                1.0, SPIN, y_f, float(p_t[i]), float(p_phi[i]))))
    print(f"  oracle: {ORACLE_RAYS} rays in "
          f"{time.perf_counter() - t0:.1f} s on the host")
    check("oracle outcomes that differ (f64 escaped, oracle not)",
          ORACLE_RAYS - outcome_ok, "<=", 0)
    check("max |d alpha| f64 vs SciPy oracle [rad]", float(max(errs)),
          "<=", ORACLE_ABS_MAX)


def checkerboard(n, squares=16):
    yy, xx = np.mgrid[0:n, 0:n] * squares // n
    board = ((yy + xx) % 2).astype(np.float32)
    return np.stack([0.15 + 0.7 * board, 0.5 + 0.0 * board,
                     0.85 - 0.7 * board], axis=-1)


def smooth_texture(n):
    """The multi-scale sinusoid texture of scripts/f32_gate.py."""
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                         indexing="ij")
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (3 * xx + 2 * yy)),
        0.5 + 0.5 * np.sin(2 * np.pi * (5 * yy - 1 * xx) + 1.0),
        0.5 + 0.5 * np.sin(2 * np.pi * (2 * xx * yy + 4 * xx) + 2.0),
    ], axis=-1).astype(np.float32)


def phase_lens(jax):
    import jax.numpy as jnp
    from light_path_tracer_tpu.pipeline import render_scene
    from light_path_tracer_tpu.render import render_lensed_image
    from light_path_tracer_tpu.utils.config import RenderConfig, SceneConfig

    scene = SceneConfig(M=1.0, a=SPIN, r_obs_mult=R_OBS)
    src = checkerboard(SIZE)
    outs = {}
    for dt, prec in (("float32", "gate"), ("float64", "fast")):
        cfg = RenderConfig(dtype=dt, precision=prec, sampling="bilinear")
        first, second, out = timed(lambda: render_scene(scene, src, cfg))
        report_time(f"render_scene {dt} {prec} 1024^2", first, second)
        outs[dt] = out
    o32, o64 = outs["float32"], outs["float64"]
    w32 = np.asarray(o32.precompute.winding)
    w64 = np.asarray(o64.precompute.winding)
    # Pixels of winding order >= 2 are chaotic (the photon ring scatters
    # any perturbation by ~e^(pi w)): gated in classification elsewhere.
    calm = (w32 < 2) & (w64 < 2)
    img32, img64 = np.asarray(o32.image), np.asarray(o64.image)
    rmse_board = float(np.sqrt(np.mean((img32 - img64)[calm] ** 2)))
    print(f"  checkerboard image RMSE f32 gate vs f64 (winding < 2, "
          f"{calm.mean():.4f} of pixels): {rmse_board!r}; all pixels: "
          f"{float(np.sqrt(np.mean((img32 - img64) ** 2)))!r}")
    # The gate as BASELINE.json states it: the smooth texture of
    # scripts/f32_gate.py, bilinear, non-chaotic pixels.
    tex = jnp.asarray(smooth_texture(SIZE))
    ac = scene.metric().alpha_crit(R_OBS)
    fov = grids(jnp.float32)[0]
    imgs = [np.asarray(render_lensed_image(
        tex, jnp.asarray(o.alpha_lookup, jnp.float32),
        jnp.asarray(o.precompute.final_alpha, jnp.float32),
        jnp.asarray(o.precompute.winding, jnp.uint16), ac, fov,
        sampling="bilinear")) for o in (o32, o64)]
    rmse = float(np.sqrt(np.mean((imgs[0] - imgs[1])[calm] ** 2)))
    check("image RMSE f32 gate+bilinear vs f64 (smooth texture, winding "
          "< 2)", rmse, "<", LENS_RMSE_MAX)


def phase_disk(jax, tmp):
    import jax.numpy as jnp
    from light_path_tracer_tpu.disk import DiskConfig, trace_disk_rays
    from light_path_tracer_tpu.models import Kerr

    png = os.path.join(tmp, "disk.png")
    argv = ["disk", "--a", str(SPIN), "--inclination", "80", "--size",
            str(SIZE), "--output", png]
    t0 = time.perf_counter()
    run_cli(argv)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(argv)
    report_time("CLI disk 1024^2", first, time.perf_counter() - t0)
    if not os.path.getsize(png):
        raise PhaseFailed("disk PNG not written")
    print(f"  PNG written: {os.path.getsize(png)} bytes")

    m = Kerr(M=1.0, a=SPIN)
    inc = float(np.radians(80.0))
    rec = {}
    for dt in (jnp.float32, jnp.float64):
        _fov_, al, th = grids(dt)
        first, second, res = timed(
            trace_disk_rays, m, R_OBS, al.ravel(), th.ravel(), inc,
            5000.0, 200000, DiskConfig())
        report_time(f"disk trace {jnp.dtype(dt).name} 1024^2", first,
                    second)
        rec[jnp.dtype(dt).name] = res
    r32, r64 = rec["float32"], rec["float64"]
    h32, h64 = np.asarray(r32.n_hits) > 0, np.asarray(r64.n_hits) > 0
    check("disk hit-mask agreement f32 vs f64", float((h32 == h64).mean()),
          ">", DISK_HIT_AGREE_MIN, note="(tests/test_disk.py tolerance)")
    both = h32 & h64
    r64_b = np.asarray(r64.r_hits[0], np.float64)[both]
    d = np.abs(np.asarray(r32.r_hits[0], np.float64)[both] - r64_b)
    print(f"  disk |d r_cross| f32 vs f64: median {float(np.median(d))!r} "
          f"M, p90 {float(np.percentile(d, 90))!r} M over {both.sum()} "
          f"pixels")
    check("disk median |d r_cross| / r f32 vs f64", float(np.median(
        d / r64_b)), "<", DISK_R_REL_MEDIAN_MAX,
        note="(tests/test_disk.py f32-vs-f64 tolerance: median 2e-2 "
             "relative on the crossing state)")


def phase_kernel(jax):
    import jax.numpy as jnp
    from light_path_tracer_tpu.disk import (DiskConfig, r_isco,
                                            trace_disk_rays)
    from light_path_tracer_tpu.models import Kerr
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_disk_rays_pallas, trace_rays_kerr_pallas)

    m = Kerr(M=1.0, a=SPIN)
    ac = m.alpha_crit(R_OBS)
    _f, al, th = grids(jnp.float32)
    half = (SIZE + 1) // 2
    al_s, th_s = al[:half].ravel(), th[:half].ravel()
    rf = jnp.zeros(al_s.shape, bool)

    def stable_p99(alpha, a, b):
        sa, sb = np.asarray(a.status), np.asarray(b.status)
        keep = ((sa == 1) & (sb == 1)
                & (np.abs(np.asarray(alpha) - ac) > 0.05 * ac))
        d = np.abs(np.asarray(a.final_alpha) - np.asarray(b.final_alpha))
        return float((sa == sb).mean()), float(np.percentile(d[keep], 99))

    t = {}
    t["kernel"] = timed(trace_rays_kerr_pallas, m, R_OBS, al_s, th_s,
                        np.pi / 2, rf, 5000.0, 200000)
    t["xla"] = timed(trace_rays_kerr, m, R_OBS, al_s, th_s, np.pi / 2, rf,
                     5000.0, 200000)
    for k in ("kernel", "xla"):
        report_time(f"shadow-grid trace {k} ({al_s.size} rays)",
                    *t[k][:2])
    agree, p99 = stable_p99(al_s, t["kernel"][2], t["xla"][2])
    check("kernel vs XLA status agreement (shadow grid)", agree, ">",
          KERNEL_STATUS_MIN)
    check("kernel vs XLA stable p99 |d alpha| [rad]", p99, "<",
          KERNEL_P99_MAX)

    inc = float(np.radians(80.0))
    plane = (float(r_isco(1.0, SPIN, True)), 20.0, float(np.pi / 2), True)
    al_d, th_d = al.ravel(), th.ravel()
    t["kernel_disk"] = timed(trace_disk_rays_pallas, m, R_OBS, al_d, th_d,
                             inc, 5000.0, 200000, plane, 2)
    t["xla_disk"] = timed(trace_disk_rays, m, R_OBS, al_d, th_d, inc,
                          5000.0, 200000, DiskConfig(), backend="xla")
    for k in ("kernel_disk", "xla_disk"):
        report_time(f"disk-recorder trace {k} ({al_d.size} rays)",
                    *t[k][:2])
    kd, xd = t["kernel_disk"][2], t["xla_disk"][2]
    agree, p99 = stable_p99(al_d, kd, xd)
    check("kernel vs XLA status agreement (disk recorder)", agree, ">",
          KERNEL_STATUS_MIN)
    check("kernel vs XLA stable p99 |d alpha| (disk, no-hit escaped) "
          "[rad]", p99, "<", KERNEL_P99_MAX)
    hk, hx = np.asarray(kd.n_hits) > 0, np.asarray(xd.n_hits) > 0
    check("kernel vs XLA disk hit-mask agreement", float((hk == hx).mean()),
          ">", KERNEL_STATUS_MIN)


def phase_multi(jax):
    from light_path_tracer_tpu.aa import render_shadow_aa
    from light_path_tracer_tpu.parallel.mesh import make_mesh
    from light_path_tracer_tpu.utils.config import RenderConfig, SceneConfig

    n = len(jax.devices())
    if n < 4:
        raise PhaseFailed(f"--multi needs 4 GPUs, JAX sees {n}")
    scene = SceneConfig(M=1.0, a=SPIN, r_obs_mult=R_OBS)
    res = MULTI_RES
    cfg = RenderConfig()
    first, second, (img4, _s) = timed(render_shadow_aa, scene, res, cfg,
                                      aa_samples=4, mesh=make_mesh(4))
    report_time("4k 4x AA shadow on a 4-card mesh", first, second)
    for d in jax.devices()[:4]:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
        print(f"  peak memory {d}: {peak / 2**20:.1f} MiB")
        if peak <= 0:
            raise PhaseFailed(f"{d} holds no work")
    first, second, (img1, _s) = timed(render_shadow_aa, scene, res, cfg,
                                      aa_samples=4)
    report_time("4k 4x AA shadow on one card", first, second)
    diff = float((np.asarray(img4) != np.asarray(img1)).mean())
    check("fraction of pixels 4-card vs 1-card that differ", diff, "<=",
          MULTI_DIFF_FRAC_MAX)


# ------------------------------------------------------------------ main

def start_cpu_shadow(tmp):
    """The same shadow command on the CPU, in a child process that never
    touches the card; returns a function that waits for its output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = os.path.join(tmp, "cpu.txt")
    fh = open(out, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "light_path_tracer_tpu", "shadow", "--a",
         str(SPIN), "--size", str(SIZE), "--output",
         os.path.join(tmp, "shadow_cpu.png")],
        cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT)

    def wait():
        rc = proc.wait(timeout=900)
        fh.close()
        text = open(out).read()
        if rc != 0:
            raise PhaseFailed(f"CPU shadow run exited {rc}: {text[-500:]}")
        return text
    return proc, wait


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(ROOT, "light_path_tracer_tpu")):
        print("chip_smoke.py: the light_path_tracer_tpu package is not "
              "next to this file", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py: no GPU (JAX's first device is "
              f"{dev.platform})", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)

    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        cpu_proc = None
        if args.multi:
            phases = [("device", lambda: phase_device(jax)),
                      ("multi", lambda: phase_multi(jax))]
        else:
            cpu_proc, cpu_wait = start_cpu_shadow(tmp)
            phases = [
                ("device", lambda: phase_device(jax)),
                ("shadow", lambda: phase_shadow(jax, tmp, cpu_wait)),
                ("lens", lambda: phase_lens(jax)),
                ("disk", lambda: phase_disk(jax, tmp)),
                ("kernel", lambda: phase_kernel(jax)),
            ]
        try:
            for name, fn in phases:
                print(f"[{name}]", flush=True)
                t0 = time.perf_counter()
                try:
                    with jax.default_matmul_precision("highest"):
                        fn()
                except Exception:            # recorded; exits non-zero
                    traceback.print_exc()
                    failed.append(name)
                print(f"[{name}] {'FAILED' if name in failed else 'ok'} "
                      f"in {time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            if cpu_proc is not None and cpu_proc.poll() is None:
                cpu_proc.kill()
                cpu_proc.wait()
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
