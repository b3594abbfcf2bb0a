"""Time the fused Pallas kernel against the XLA trace loop on the GPU.

End to end through the library renders a user calls: render_shadow at
1024^2 Kerr a=0.9 and render_disk at 1024^2, inclination 80 deg, each with
RenderConfig(backend="xla") and backend="pallas" in alternating turns
(xla, pallas, pallas, xla, ...), so both see the same card state. Prints
one JSON line per measurement and writes them, with the card's name and
power limit, to chiprun_out/trace_ab.json.

  python scripts/trace_ab.py                 # the A/B
  python scripts/trace_ab.py --sweep         # kernel block/num_warps sweep
  python scripts/trace_ab.py --profile [--backend pallas]
                                             # profile one shadow render
                                             # and reduce the trace

Fails when JAX finds no GPU. Set XLA_FLAGS=--xla_dump_to=<dir> to keep the
compiled PTX (ptxas -v on it reports the kernel's registers and spills).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out")


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def timed(fn, reps):
    """(first-call seconds incl. compile, [steady seconds...], result)."""
    t0 = time.perf_counter()
    out = fn()
    t_first = time.perf_counter() - t0
    steady = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        steady.append(time.perf_counter() - t0)
    return t_first, steady, out


def shadow_fn(backend, size):
    from light_path_tracer_tpu.pipeline import render_shadow
    from light_path_tracer_tpu.utils.config import RenderConfig, SceneConfig
    scene = SceneConfig(M=1.0, a=0.9)
    cfg = RenderConfig(backend=backend)

    def run():
        img, stats = render_shadow(scene, (size, size), cfg)
        img = np.asarray(img)
        return img, int(stats["integrator_steps"])
    return run


def disk_fn(backend, size):
    from light_path_tracer_tpu.disk import DiskConfig, render_disk
    from light_path_tracer_tpu.utils.config import RenderConfig, SceneConfig
    scene = SceneConfig(M=1.0, a=0.9, theta_obs=float(np.radians(80.0)))
    cfg = RenderConfig(backend=backend)

    def run():
        img, stats = render_disk(scene, (size, size), cfg, DiskConfig())
        return np.asarray(img), int(stats["integrator_steps"])
    return run


def ab(size, reps, rounds):
    rows = []
    for mode, make in (("shadow", shadow_fn), ("disk", disk_fn)):
        fns = {b: make(b, size) for b in ("xla", "pallas")}
        outs = {}
        for r in range(rounds):
            order = ("xla", "pallas") if r % 2 == 0 else ("pallas", "xla")
            for b in order:
                t_first, steady, (img, steps) = timed(fns[b], reps)
                outs[b] = img
                row = dict(mode=mode, backend=b, size=size, round=r,
                           first_s=t_first, steady_s=steady,
                           median_s=float(np.median(steady)),
                           integrator_steps=steps)
                print(json.dumps(row), flush=True)
                rows.append(row)
        diff = np.abs(outs["xla"].astype(np.float64)
                      - outs["pallas"].astype(np.float64))
        rows.append(dict(mode=mode, compare="xla_vs_pallas",
                         frac_pixels_differ=float((diff > 1e-3).mean()),
                         max_abs=float(diff.max())))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def sweep(size, reps):
    """Kernel block size x num_warps on the trace alone: the shadow grid
    (Kerr a=0.9, mirror-folded half) and the disk grid (i=80 deg), each
    against the XLA loop on the same rays."""
    import jax.numpy as jnp
    from light_path_tracer_tpu import camera
    from light_path_tracer_tpu.disk import DiskConfig, r_isco
    from light_path_tracer_tpu.models import Kerr
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr
    from light_path_tracer_tpu.disk import trace_disk_rays
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_disk_rays_pallas, trace_rays_kerr_pallas)
    m = Kerr(M=1.0, a=0.9)
    fov = camera.fov_from_vertical(np.radians(40.0), (size, size))
    half = (size + 1) // 2
    al = camera.build_alpha_lookup((size, size), fov)
    th = camera.build_theta_lookup((size, size), fov)
    al_s = jnp.asarray(al[:half].ravel(), jnp.float32)
    th_s = jnp.asarray(th[:half].ravel(), jnp.float32)
    al_d = jnp.asarray(al.ravel(), jnp.float32)
    th_d = jnp.asarray(th.ravel(), jnp.float32)
    rf = jnp.zeros(al_s.shape, bool)
    inc = float(np.radians(80.0))
    plane = (float(r_isco(1.0, 0.9, True)), 20.0, float(np.pi / 2), True)

    def ready(res):
        return np.asarray(res.status), int(res.n_steps)

    cases = {
        "shadow": (
            lambda: ready(trace_rays_kerr(m, 100.0, al_s, th_s, np.pi / 2,
                                          rf, 5000.0, 200000)),
            lambda b, w: ready(trace_rays_kerr_pallas(
                m, 100.0, al_s, th_s, np.pi / 2, rf, 5000.0, 200000,
                block=b, num_warps=w))),
        "disk": (
            lambda: ready(trace_disk_rays(
                m, 100.0, al_d, th_d, inc, 5000.0, 200000, DiskConfig(),
                backend="xla")),
            lambda b, w: ready(trace_disk_rays_pallas(
                m, 100.0, al_d, th_d, inc, 5000.0, 200000, plane, 2,
                block=b, num_warps=w))),
    }
    rows = []
    for mode, (xla, kern) in cases.items():
        t_first, steady, (st_x, steps_x) = timed(xla, reps)
        rows.append(dict(mode=mode, kernel="xla", first_s=t_first,
                         median_s=float(np.median(steady)), steps=steps_x))
        print(json.dumps(rows[-1]), flush=True)
        for block in (32, 64, 128, 256):
            for warps in (1, 2, 4):
                if block < 32 * warps:
                    continue
                t_first, steady, (st, steps) = timed(
                    lambda: kern(block, warps), reps)
                rows.append(dict(mode=mode, kernel="pallas", block=block,
                                 num_warps=warps, first_s=t_first,
                                 median_s=float(np.median(steady)),
                                 steps=steps,
                                 status_agree=float((st == st_x).mean())))
                print(json.dumps(rows[-1]), flush=True)
    return rows


def reduce_trace(trace_dir):
    """Per device line: event count, summed duration and busy union, and
    the largest events by total time."""
    import jax
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    pd = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    lines = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [(e.name, e.start_ns, e.duration_ns) for e in line.events]
            if not evs:
                continue
            spans = sorted((s, s + d) for _n, s, d in evs)
            busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
            for s, e in spans[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            by_name = {}
            for n, _s, d in evs:
                c, t = by_name.get(n, (0, 0.0))
                by_name[n] = (c + 1, t + d)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
            lines.append(dict(
                plane=plane.name, line=line.name, n_events=len(evs),
                sum_ns=float(sum(d for _n, _s, d in evs)), busy_ns=busy,
                window_ns=float(spans[-1][1] - spans[0][0]),
                top=[dict(name=n[:120], count=c, total_ns=t)
                     for n, (c, t) in top]))
    return lines


def profile(size, backend):
    import jax
    run = shadow_fn(backend, size)
    run()                                   # compile outside the window
    trace_dir = os.path.join(OUT, f"{backend}_shadow_trace")
    jax.profiler.start_trace(trace_dir)
    _img, steps = run()
    jax.profiler.stop_trace()
    lines = reduce_trace(trace_dir)
    return dict(mode="shadow", backend=backend, size=size,
                loop_iterations=steps, device_lines=lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--backend", default="xla", choices=["xla", "pallas"],
                    help="backend of the --profile render")
    args = ap.parse_args()

    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX found {jax.devices()[0].platform}")
    dev = jax.devices()[0]
    head = dict(card=card(), device_kind=dev.device_kind,
                count=len(jax.devices()))
    print(json.dumps(head), flush=True)
    result = dict(head)
    if args.profile:
        result["profile"] = profile(args.size, args.backend)
    elif args.sweep:
        result["sweep"] = sweep(args.size, args.reps)
    else:
        result["ab"] = ab(args.size, args.reps, args.rounds)
    os.makedirs(OUT, exist_ok=True)
    name = (f"trace_profile_{args.backend}" if args.profile
            else "trace_sweep" if args.sweep else "trace_ab")
    with open(os.path.join(OUT, name + ".json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
