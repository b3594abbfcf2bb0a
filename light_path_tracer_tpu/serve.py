"""Render serving: compile-once, serve-many HTTP endpoint.

Production-deployment layer beyond the reference (which is batch-only,
image_lens.py:518-535): a lightweight stdlib HTTP server that keeps the
compiled programs warm across requests. The first request of each distinct
signature — the FULL (mode, size, scene, render, disk) configuration;
scene parameters like M/a/psi are static argnums in the jitted
pipelines, so changing them compiles a new program — pays the XLA
compile; every later identical-signature request reuses it (cold and
warm latency on the GPU are not measured yet, ROADMAP S3). Parameter
sweeps that must not recompile should use the traced-parameter
sequence API (sequence.render_param_sequence) directly.

Protocol (JSON over HTTP, no external deps):

    POST /render
        {"mode": "shadow" | "lens" | "disk" | "composite"
                 | "magnification" | "caustics" | "timedelay" | "shear"
                 | "volumetric" | "star",
         "scene":  {... SceneConfig fields, angles in DEGREES ...},
         "render": {... RenderConfig fields ...},
         "disk":   {... DiskConfig fields (disk/composite modes) ...},
         "riaf":   {... RIAFConfig fields (volumetric mode) ...},
         "star":   {... StarConfig fields (star mode) ...},
         "size": [H, W]                 (shadow/disk; lens uses image),
         "image_b64": "<base64 PNG/NPY>" (lens/composite background),
         "format": "png" | "npy"}
    -> 200, body = rendered image (PNG bytes or .npy array), headers
       X-Render-Seconds / X-Cache (warm|cold).

    GET /healthz  -> {"ok": true, "devices": N, "platform": "..."}
    GET /stats    -> per-signature request counts + timing summary

Run:  python -m light_path_tracer_tpu.serve --port 8080
Test: tests/test_serve.py drives a live server end-to-end in-process.

Threading model: requests serialize through one render lock — the GPU
is a single shared accelerator and JAX dispatch is not thread-safe per
device; concurrency should come from horizontal replicas, one process
per card (CUDA_VISIBLE_DEVICES=<i>: a JAX process reserves most of a
card's memory when it starts), matching the tile-DP design (parallel/).

Overload behavior (enforced, not just documented): at most `max_queue`
requests may WAIT for the render lock — beyond that /render replies
503 {"error": "overloaded"} immediately (with Retry-After). Each
request also carries a deadline (request field "deadline_s", default
`default_deadline_s`): if the lock is not acquired within it, 503
{"error": "deadline exceeded"} — a slow 4k render ahead in the queue
cannot stall later requests forever. A render already RUNNING is never
interrupted (JAX dispatches aren't preemptible); the deadline bounds
queue wait. /healthz and /stats never take the render lock, so
liveness checks stay responsive under load (proved in
tests/test_serve.py).
"""

from __future__ import annotations

import base64
import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig

_DEG_FIELDS = {"psi_y", "psi_x", "theta_obs"}          # degrees in JSON
_DISK_DEG_FIELDS = {"tilt", "tilt_azimuth"}


def _scene_from_json(d: dict) -> SceneConfig:
    kw = {}
    for key, val in (d or {}).items():
        if key == "custom_metric":
            # User-defined metrics load local Python (models.custom.
            # load_covariant_fn) — a trust boundary deliberately NOT
            # reachable over HTTP.
            raise ValueError(
                "custom_metric is not accepted over HTTP; use the "
                "CLI --metric-py locally")
        if key == "boost":
            kw[key] = tuple(float(v) for v in val)
        elif key in _DEG_FIELDS:
            kw[key] = math.radians(float(val))
        else:
            kw[key] = val
    return SceneConfig(**kw)


def _render_cfg_from_json(d: dict) -> RenderConfig:
    return RenderConfig(**(d or {}))


def _disk_cfg_from_json(d: dict):
    from light_path_tracer_tpu.disk import DiskConfig
    kw = dict(d or {})
    for key in _DISK_DEG_FIELDS:
        if key in kw:
            kw[key] = math.radians(float(kw[key]))
    if not kw.get("warp_radius"):
        # 0 means "flat plane" at the API boundary (CLI parity); None
        # internally, so an untilted disk keeps the fast Pallas path.
        kw.pop("warp_radius", None)
    return DiskConfig(**kw)


def _riaf_cfg_from_json(d: dict):
    from light_path_tracer_tpu.volumetric import RIAFConfig
    riaf = RIAFConfig(**dict(d or {}))
    # Field-value validation normally happens inside render_volumetric
    # (make_emission_fn); run it here so a bad profile/shell config is
    # a 400 client error, not a 500 mid-render.
    if riaf.profile not in ("torus", "powerlaw", "shell", "jet"):
        raise ValueError(f"riaf.profile must be 'torus', 'powerlaw', "
                         f"'shell' or 'jet', got {riaf.profile!r}")
    if not 0.0 <= riaf.jet_beta < 1.0:
        raise ValueError(f"riaf.jet_beta must be in [0, 1), got "
                         f"{riaf.jet_beta}")
    if riaf.profile == "shell" and not riaf.shell_out > riaf.shell_in:
        raise ValueError("shell profile needs shell_out > shell_in")
    return riaf


def _star_cfg_from_json(d: dict):
    from light_path_tracer_tpu.star import StarConfig
    kw = dict(d or {})
    if "spots" in kw:
        kw["spots"] = tuple(tuple(float(v) for v in s)
                            for s in kw["spots"])
    star = StarConfig(**kw)
    # Geometry validation normally happens inside render_star
    # (_validate needs the metric); the metric-free parts run here so
    # a malformed spot list is a 400 client error, not a 500.
    for spot in star.spots:
        if len(spot) != 4:
            raise ValueError("each star.spots entry is (colat_deg, "
                             f"az_deg, radius_deg, T), got {spot!r}")
    return star


def _decode_image(b64: str) -> np.ndarray:
    raw = base64.b64decode(b64)
    if raw[:6] == b"\x93NUMPY":
        return np.load(io.BytesIO(raw), allow_pickle=False)
    import matplotlib.image as mpimg
    return mpimg.imread(io.BytesIO(raw), format="png")


def _encode_image(img: np.ndarray, fmt: str) -> tuple[bytes, str]:
    img = np.asarray(img)
    if fmt == "npy":
        buf = io.BytesIO()
        np.save(buf, img, allow_pickle=False)
        return buf.getvalue(), "application/octet-stream"
    import matplotlib.image as mpimg
    buf = io.BytesIO()
    mpimg.imsave(buf, np.clip(img, 0.0, 1.0), format="png",
                 **({} if img.ndim == 3 else
                    {"cmap": "gray", "vmin": 0, "vmax": 1}))
    return buf.getvalue(), "image/png"


def _display_encode(mode: str, img: np.ndarray, fmt: str) -> np.ndarray:
    """PNG display encodings for the raw-map modes (npy ships the raw
    arrays untouched): signed-mu display for magnification, the omega
    panel on a diverging scale for shear, log-compressed inferno /
    viridis for caustics / timedelay. Shared by the HTTP handler and
    the offline `render_request` replay."""
    if fmt != "png":
        return img
    if mode == "magnification":
        from light_path_tracer_tpu.render import magnification_display
        return magnification_display(img)
    if mode == "shear":
        # Raw stacked maps are an npy product; the png ships the
        # omega (frame-dragging) panel on a symmetric diverging
        # scale, NaN black.
        import matplotlib.cm as _cm
        om = np.asarray(img[3], np.float64)
        fin = np.isfinite(om)
        lim = (float(np.percentile(np.abs(om[fin]), 99.0))
               if fin.any() else 1.0) or 1.0
        rgba = _cm.RdBu_r(np.clip(0.5 + 0.5 * om / lim, 0.0, 1.0))
        rgba[~fin] = (0.0, 0.0, 0.0, 1.0)
        return rgba
    if mode in ("caustics", "timedelay"):
        # Raw A / tau maps are npy products; for png, log-compress
        # (NaN shadow -> black).
        import matplotlib.cm as _cm
        raw = np.asarray(img, np.float64)
        disp = np.log10(1.0 + np.nan_to_num(
            np.maximum(raw, 0.0), nan=0.0))
        lim = float(np.nanpercentile(disp, 99.5)) or 1.0
        cmap = _cm.inferno if mode == "caustics" else _cm.viridis
        rgba = cmap(np.clip(disp / lim, 0.0, 1.0))
        rgba[~np.isfinite(raw)] = (0.0, 0.0, 0.0, 1.0)
        return rgba
    return img


_MODES = ("shadow", "lens", "disk", "composite", "magnification",
          "caustics", "timedelay", "shear", "volumetric", "star")


def decode_request(req: dict, source_image=None):
    """Decode one /render request dict into RenderService.render()
    arguments. Shared verbatim by the HTTP handler and the offline
    replay (`render_request` / CLI `request` subcommand), so a
    recorded production request replays against the exact serving
    contract. Raises ValueError/TypeError/KeyError on anything
    malformed (the HTTP layer maps those to 400).

    source_image, when given, replaces the request's `image_b64` for
    lens/composite (the CLI loads it from a local path); the HTTP
    path never passes it, so a missing image_b64 stays a client error.
    """
    mode = req.get("mode", "shadow")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    scene = _scene_from_json(req.get("scene", {}))
    cfg = _render_cfg_from_json(req.get("render", {}))
    disk = (_disk_cfg_from_json(req.get("disk", {}))
            if mode in ("disk", "composite") else None)
    riaf = (_riaf_cfg_from_json(req.get("riaf", {}))
            if mode == "volumetric" else None)
    star = (_star_cfg_from_json(req.get("star", {}))
            if mode == "star" else None)
    if mode in ("lens", "composite"):
        src = (source_image if source_image is not None
               else _decode_image(req["image_b64"]))
    else:
        src = None
    size = req.get("size", [256, 256])
    if mode in ("shadow", "disk", "magnification", "caustics",
                "timedelay", "shear", "volumetric", "star"):
        if len(size) != 2 or any(int(v) <= 0 for v in size):
            raise ValueError(
                f"size must be two positive ints, got {size!r}")
        size = [int(v) for v in size]
    deadline_s = req.get("deadline_s")
    if deadline_s is not None:
        deadline_s = float(deadline_s)
        if deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
    return (mode, scene, cfg, disk, riaf, star, src, size, deadline_s)


def render_request(req: dict, svc=None, source_image=None,
                   fmt: str | None = None):
    """Render one /render-shaped request dict WITHOUT the HTTP layer.

    The offline twin of POST /render: same decode, same mode dispatch
    (RenderService), same display encodings — the returned body is
    byte-compatible with the HTTP response for the same request. Use
    it to replay recorded production requests locally
    (`python -m light_path_tracer_tpu request req.json`) or as a
    library entry point for batch scene files.

    Returns (body_bytes, content_type, seconds, "warm"|"cold").
    `fmt` overrides the request's "format" field; `source_image`
    replaces image_b64 for lens/composite.
    """
    (mode, scene, cfg, disk, riaf, star, src, size,
     deadline_s) = decode_request(req, source_image=source_image)
    if fmt is None:
        fmt = req.get("format", "png")
    service = svc if svc is not None else RenderService()
    img, dt, cache = service.render(
        mode, scene, cfg, size=size, source_image=src, disk=disk,
        riaf=riaf, star=star, deadline_s=deadline_s)
    img = _display_encode(mode, img, fmt)
    body, ctype = _encode_image(img, fmt)
    return body, ctype, dt, cache


class Overloaded(RuntimeError):
    """Too many requests already waiting for the render lock."""


class DeadlineExceeded(RuntimeError):
    """The render lock was not acquired within the request deadline."""


class RenderService:
    """Mode dispatch + warm-signature accounting (transport-agnostic).

    max_queue: how many requests may wait for the render lock at once
    (the running one is not counted); further requests get Overloaded.
    default_deadline_s: queue-wait bound when the request doesn't set
    "deadline_s" itself.
    """

    def __init__(self, max_queue: int = 4,
                 default_deadline_s: float = 120.0):
        self._lock = threading.Lock()
        self._meta = threading.Lock()   # guards _waiting + _signatures
        self._waiting = 0
        self.max_queue = int(max_queue)
        self.default_deadline_s = float(default_deadline_s)
        self._signatures: dict[str, dict] = {}

    def signature(self, mode, scene: SceneConfig, cfg: RenderConfig,
                  size, disk, riaf=None, star=None) -> str:
        """The compiled-program identity: static argnums only. psi, M,
        a, boost are traced-or-refolded per call by the pipelines, but
        M/a/psi DO enter compiled constants in the static paths — the
        honest signature is everything except the background image."""
        return json.dumps([mode, list(size or ()), repr(scene),
                           repr(cfg), repr(disk), repr(riaf),
                           repr(star)], sort_keys=True)

    def render(self, mode: str, scene: SceneConfig, cfg: RenderConfig,
               size=None, source_image=None, disk=None, riaf=None,
               star=None, deadline_s: float | None = None):
        """Returns (image ndarray, seconds, cache 'warm'|'cold').

        Raises Overloaded when max_queue requests already wait, and
        DeadlineExceeded when the render lock is not acquired within
        deadline_s (default: self.default_deadline_s). A render that
        has STARTED always runs to completion.
        """
        deadline = (self.default_deadline_s if deadline_s is None
                    else float(deadline_s))
        sig = self.signature(mode, scene, cfg, size, disk, riaf, star)
        with self._meta:
            if self._waiting >= self.max_queue:
                raise Overloaded(
                    f"{self._waiting} requests already queued "
                    f"(max_queue={self.max_queue})")
            self._waiting += 1
        try:
            if not self._lock.acquire(timeout=max(deadline, 0.0)):
                raise DeadlineExceeded(
                    f"render lock not acquired within {deadline:.1f}s")
        finally:
            with self._meta:
                self._waiting -= 1
        try:
            with self._meta:
                entry = self._signatures.setdefault(
                    sig, {"count": 0, "total_s": 0.0, "mode": mode})
                warm = entry["count"] > 0
            t0 = time.perf_counter()
            if mode == "shadow":
                from light_path_tracer_tpu.pipeline import render_shadow
                img, _stats = render_shadow(scene, tuple(size), cfg)
            elif mode == "lens":
                from light_path_tracer_tpu.pipeline import render_scene
                img = render_scene(scene, source_image, cfg).image
            elif mode == "disk":
                from light_path_tracer_tpu.disk import render_disk
                img, _stats = render_disk(scene, tuple(size), cfg, disk)
            elif mode == "magnification":
                from light_path_tracer_tpu.pipeline import (
                    render_magnification)
                img, _stats = render_magnification(scene, tuple(size),
                                                   cfg)
            elif mode == "caustics":
                # size = the TRACED grid; the returned map bins at
                # size/2 (>= ~4 rays per CIC bin keeps the map smooth).
                from light_path_tracer_tpu.pipeline import (
                    render_caustics)
                img, _extent, _stats = render_caustics(
                    scene, tuple(size), cfg,
                    bins=max(int(size[0]) // 2, 8))
            elif mode == "timedelay":
                from light_path_tracer_tpu.pipeline import (
                    render_time_delay)
                img, _stats = render_time_delay(scene, tuple(size),
                                                cfg)
            elif mode == "shear":
                # Weak-lensing decomposition: ship the five maps
                # stacked (kappa, gamma1, gamma2, omega, gamma).
                from light_path_tracer_tpu.pipeline import render_shear
                maps, _stats = render_shear(scene, tuple(size), cfg)
                img = np.stack([np.asarray(maps[k]) for k in
                                ("kappa", "gamma1", "gamma2",
                                 "omega", "gamma")])
            elif mode == "volumetric":
                from light_path_tracer_tpu.volumetric import (
                    render_volumetric, RIAFConfig)
                img, _stats = render_volumetric(
                    scene, tuple(size), cfg, riaf or RIAFConfig())
            elif mode == "star":
                from light_path_tracer_tpu.star import (render_star,
                                                        StarConfig)
                img, _stats = render_star(scene, tuple(size), cfg,
                                          star or StarConfig())
            elif mode == "composite":
                from light_path_tracer_tpu.disk import (
                    render_scene_with_disk, composite_gamma_encode)
                img, stats = render_scene_with_disk(
                    scene, source_image, cfg, disk)
                if disk.spectrum == "blackbody":
                    img = composite_gamma_encode(img, stats["disk_mask"])
            else:
                raise ValueError(f"unknown mode {mode!r}")
            img = np.asarray(img)
            dt = time.perf_counter() - t0
            with self._meta:
                entry["count"] += 1
                entry["total_s"] += dt
        finally:
            self._lock.release()
        return img, dt, ("warm" if warm else "cold")

    def stats(self) -> dict:
        with self._meta:
            return {
                "signatures": len(self._signatures),
                "requests": sum(e["count"]
                                for e in self._signatures.values()),
                "waiting": self._waiting,
                "max_queue": self.max_queue,
                "per_signature": [
                    {"mode": e["mode"], "count": e["count"],
                     "mean_s": e["total_s"] / max(e["count"], 1)}
                    for e in self._signatures.values()],
            }


def make_server(host: str = "127.0.0.1", port: int = 0,
                service: RenderService | None = None):
    """Build (but don't start) the HTTP server; port=0 picks a free one."""
    svc = service or RenderService()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):           # quiet by default
            pass

        def _reply(self, code, body: bytes, ctype: str, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for key, val in extra:
                self.send_header(key, val)
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code, obj):
            self._reply(code, json.dumps(obj).encode(),
                        "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                import jax
                devs = jax.devices()
                self._reply_json(200, {"ok": True, "devices": len(devs),
                                       "platform": devs[0].platform})
            elif self.path == "/stats":
                self._reply_json(200, svc.stats())
            else:
                self._reply_json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/render":
                self._reply_json(404, {"error": "unknown path"})
                return
            replied = False
            try:
                # Request decode: anything wrong here is the CLIENT's
                # error -> 400.
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    (mode, scene, cfg, disk, riaf, star, src, size,
                     deadline_s) = decode_request(req)
                except Exception as exc:        # noqa: BLE001 — client
                    self._reply_json(400, {"error":
                                           f"{type(exc).__name__}: {exc}"})
                    replied = True
                    return
                # Overload/deadline -> 503 (retryable, NOT a server
                # bug); render failures (compile error, OOM, bugs) are
                # OURS -> 500, so monitoring doesn't classify outages
                # as bad requests.
                try:
                    img, dt, cache = svc.render(
                        mode, scene, cfg, size=size, source_image=src,
                        disk=disk, riaf=riaf, star=star,
                        deadline_s=deadline_s)
                    fmt = req.get("format", "png")
                    img = _display_encode(mode, img, fmt)
                    body, ctype = _encode_image(img, fmt)
                except Overloaded as exc:
                    self._reply(503,
                                json.dumps({"error": "overloaded",
                                            "detail": str(exc)}).encode(),
                                "application/json",
                                extra=[("Retry-After", "1")])
                    replied = True
                    return
                except DeadlineExceeded as exc:
                    self._reply_json(503, {"error": "deadline exceeded",
                                           "detail": str(exc)})
                    replied = True
                    return
                except Exception as exc:        # noqa: BLE001 — server
                    self._reply_json(500, {"error":
                                           f"{type(exc).__name__}: {exc}"})
                    replied = True
                    return
                replied = True
                self._reply(200, body, ctype,
                            extra=[("X-Render-Seconds", f"{dt:.4f}"),
                                   ("X-Cache", cache)])
            except (BrokenPipeError, ConnectionResetError):
                # Client went away mid-reply: nothing to send and no
                # second reply on a half-written socket.
                pass
            except Exception:
                if not replied:
                    try:
                        self._reply_json(500, {"error": "internal"})
                    except OSError:
                        pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.service = svc
    return server


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="light_path_tracer_tpu render server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max-queue", type=int, default=4,
                        help="max requests waiting for the render lock "
                             "before 503 overloaded")
    parser.add_argument("--deadline", type=float, default=120.0,
                        help="default per-request queue-wait deadline "
                             "[s] (overridable per request via "
                             "deadline_s)")
    args = parser.parse_args(argv)

    import jax
    from light_path_tracer_tpu.utils.cache import enable_compilation_cache
    # Snapshot the process-global cache config so an in-process caller
    # (tests) gets it back when the server exits — same leak class as
    # cli.main().
    restore = {}
    for key in ("jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs"):
        try:
            restore[key] = getattr(jax.config, key)
        except AttributeError:
            pass
    enable_compilation_cache()

    server = make_server(args.host, args.port,
                         RenderService(max_queue=args.max_queue,
                                       default_deadline_s=args.deadline))
    host, port = server.server_address[:2]
    print(f"render server on http://{host}:{port} "
          f"(POST /render, GET /healthz /stats)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        for key, val in restore.items():
            jax.config.update(key, val)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
