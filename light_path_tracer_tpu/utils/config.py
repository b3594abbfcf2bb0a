"""Unified scene/render configuration.

The reference scatters configuration across argparse flags
(image_lens.py:519-532), keyword defaults (image_lens.py:432-433), and
hardcoded constants (WINDING_DTYPE / Y_AXIS_REFINE_FRAC, image_lens.py:12-14;
integrator tolerances, metrics.py:431-432). Here it is one pair of frozen
dataclasses — hashable, so jitted programs can treat them as static.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Physics + camera scene description."""

    M: float = 1.0
    a: float = 0.0
    # Black-hole charge in units of M (Reissner-Nordstrom when != 0;
    # mutually exclusive with a != 0 — models.make_metric).
    Q: float = 0.0
    # Johannsen-Psaltis deformation (test-GR deformed Kerr when != 0;
    # mutually exclusive with Q — models.make_metric). Shadow/lens/
    # magnification surfaces; disk orbital dynamics stays Kerr-only.
    eps3: float = 0.0
    r_obs_mult: float = 100.0          # observer radius in units of M
    psi_y: float = 0.0                 # BH screen pitch offset [rad]
    psi_x: float = 0.0                 # BH screen yaw offset [rad]
    vertical_fov_deg: float = 40.0
    theta_obs: float = math.pi / 2     # observer inclination
    # Camera 3-velocity in units of c, camera coords (+x right, +y down,
    # +z forward); (0,0,0) = the reference's static observer. Non-zero
    # aberrates every pixel's view direction into the static frame
    # before tracing (camera.aberrate_view) and Doppler-shifts observed
    # intensities/temperatures (camera.doppler_lookup).
    boost: tuple = (0.0, 0.0, 0.0)
    # User-defined spacetime (models.custom.CustomMetric or any Metric
    # instance): overrides the (M, a, Q, eps3) family selection when
    # set. Still a frozen/hashable field (CustomMetric is a frozen
    # dataclass), so scenes stay valid jit cache keys. Shadow/lens/
    # magnification/AA/trajectory surfaces; disk orbital dynamics and
    # polarization keep their closed-form families.
    custom_metric: object = None

    @property
    def psi(self):
        return (self.psi_y, self.psi_x)

    def metric(self):
        """The scene's Metric: `custom_metric` if set, else the
        (M, a, Q, eps3) family dispatch (models.make_metric)."""
        if self.custom_metric is not None:
            return self.custom_metric
        from light_path_tracer_tpu.models import make_metric
        return make_metric(self.M, self.a, self.Q, self.eps3)

    @property
    def boosted(self) -> bool:
        return any(float(b) != 0.0 for b in self.boost)

    @property
    def r_obs(self) -> float:
        return self.r_obs_mult * self.M

    @property
    def vertical_fov(self) -> float:
        return math.radians(self.vertical_fov_deg)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Numerics + performance knobs."""

    dtype: str = "float32"             # "float32" | "float64"
    # Kerr integrator: "dp45" (reference-parity Dormand-Prince 4(5)),
    # "dop853" (8th-order Hairer pair — fewer, costlier steps; see
    # ops/kerr_trace.py), or "rk4" (fixed-step comparison path).
    integrator: str = "dp45"
    # "auto" (the fused Pallas kernel for f32 on a GPU, XLA otherwise),
    # "xla" or "pallas".
    backend: str = "auto"
    # "hermite" (more accurate) or "linear" (bug-for-bug reference parity,
    # metrics.py:528-548) boundary-crossing interpolation.
    event_interp: str = "hermite"
    # Polar-coordinate formulation of the Kerr hot loop: "theta"
    # (reference-parity coordinate, the default) or "mu" (mu = cos(theta),
    # rational transcendental-free RHS + theta-form pole retrace via
    # trace_rays_kerr_hybrid, on the XLA path).
    formulation: str = "theta"
    # Tolerance tier: "fast" (f32 atol 3e-5; the throughput tier),
    # "precise" (f32 3e-6; ~5.6e-5-rad final-alpha RMSE),
    # or "gate" (f32 1e-6; f64 1e-7 — the accuracy tier). Acceptance
    # gate (image RMSE < 1e-3, chip_smoke.py lens phase): f32 "gate"
    # passes it under sampling="bilinear"; the nearest-
    # sampling gate as written passes on dtype="float64" at the
    # default reference tolerances (see ops/kerr_trace.py TOLS_GATE
    # comment for the texel-flip-floor analysis).
    precision: str = "fast"
    # Background-texture sampling: "nearest" (reference parity,
    # image_lens.py:119-120 rint) or "bilinear" (continuous gather —
    # smoother lensed images; image error tracks angle accuracy instead
    # of the nearest-texel flip floor, BASELINE.md accuracy targets).
    sampling: str = "nearest"
    max_steps: int = 200000            # adaptive-step bound (metrics.py:452)
    phi_max: float = 50.0              # Schwarzschild orbit bound
    h_max: float = 0.05                # Schwarzschild fixed step
    # Kerr straggler containment on the XLA path. None = one dispatch
    # over the whole grid; chunking bounds memory and each chunk's
    # straggler blast radius for very large or heterogeneous grids.
    chunk_size: int | None = None
    sort_by_difficulty: bool = True    # group photon-ring grazers
    # Emission-saturation early exit for the volumetric/extras family
    # (ops/kerr_trace.dp45_integrate docstring): a trapped photon-ring
    # lane whose monitored path integrals were bitwise-unchanged for
    # this many CONSECUTIVE integrator attempts while inside the
    # photon-shell band exits as budget-complete instead of grinding
    # the max_steps budget. The grinder seen so far (the order-
    # decomposition mode ground 204,819 steps on the previous
    # accelerator) is a reject limit cycle whose whole state freezes
    # bitwise — attempts-counting catches it; accepted-step counting
    # would never fire. The window must exceed the
    # longest in-band no-change dwell of a legitimately progressing ray
    # (~100 steps measured at "gate" tolerance on the a=0.9 capture
    # boundary; 2048 is ~20x that) — an undersized window can exit a
    # near-critical ray before it collects far-field emission it would
    # have reached within budget. 0 disables (every lane runs to
    # termination / budget).
    sat_window: int = 2048
    axis_refine_frac: float = 0.07     # Y_AXIS_REFINE_FRAC
    use_tb_symmetry: bool = True       # top/bottom mirror when applicable
    render_loop_around: bool = False
    winding_max: int = 65535           # uint16 winding clip (image_lens.py:13)
    # Chunked-trace progress: False | True (tqdm) | "live" (in-place
    # ANSI bar with CPU%% + RSS telemetry, utils/progress.py — the
    # legacy debugging harness's bar, debugging_image_lense.py:175-229).
    progress: bool | str = False
