"""light_path_tracer_tpu — a general-relativistic ray tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference CPU ray tracer (dhg14n9/Light-path-tracer): null-geodesic
integration around Schwarzschild and Kerr black holes, black-hole shadow
rendering, and gravitational lensing of background images.

Design (array-first, not a port):
  * Structure-of-arrays ray state over the whole pixel grid; every hot path
    is a single jitted XLA program (vmapped `lax.while_loop` / `lax.scan`),
    not a per-ray Python loop (reference: metrics.py:661-679 prange loops).
  * Per-lane masked adaptive Dormand-Prince 4(5) with FSAL replaces the
    per-ray divergent while loop (reference: metrics.py:419-567).
  * Multi-chip scaling via `jax.sharding.Mesh` image-tile data parallelism
    (reference had none; closest analogue is its ProcessPoolExecutor rows).

Public API mirrors the reference surface (metric classes, camera
conversions, lensing pipeline, CLI) — see individual module docstrings for
file:line parity citations.
"""

from light_path_tracer_tpu.version import __version__
from light_path_tracer_tpu.models import (
    Schwarzschild, Kerr, ReissnerNordstrom, Metric, make_metric)
from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig

__all__ = [
    "__version__",
    "Schwarzschild",
    "Kerr",
    "ReissnerNordstrom",
    "Metric",
    "make_metric",
    "SceneConfig",
    "RenderConfig",
    # Lazily imported heavyweight entry points (see __getattr__):
    "render_scene",
    "render_shadow",
    "render_disk",
    "render_disk_aa",
    "render_disk_decomposed",
    "render_disk_frames",
    "render_scene_with_disk",
    "render_scene_with_disk_aa",
    "render_scene_rings",
    "render_shadow_adaptive",
    "render_scene_adaptive",
    "line_profile",
    "hotspot_light_curve",
    "render_polarization",
    "render_volumetric",
    "render_volumetric_spectrum",
    "render_volumetric_movie",
    "render_volumetric_decomposed",
    "render_polarized_volumetric",
    "RIAFConfig",
    "render_star",
    "pulse_profile",
    "StarConfig",
    "circular_orbit",
    "orbit_from_apsides",
    "timelike_initial_conditions",
    "integrate_orbit",
    "periapsis_precession",
    "nodal_precession",
    "trace_batch",
    "find_point_images",
    "LensedImage",
    "render_panorama",
    "render_pano_image",
    "build_pano_lookups",
    "grid_sky",
]

_LAZY = {
    "render_scene": ("light_path_tracer_tpu.pipeline", "render_scene"),
    "render_shadow": ("light_path_tracer_tpu.pipeline", "render_shadow"),
    "render_disk": ("light_path_tracer_tpu.disk", "render_disk"),
    "render_scene_with_disk": ("light_path_tracer_tpu.disk",
                               "render_scene_with_disk"),
    "render_disk_aa": ("light_path_tracer_tpu.disk", "render_disk_aa"),
    "render_disk_decomposed": ("light_path_tracer_tpu.disk",
                               "render_disk_decomposed"),
    "render_disk_frames": ("light_path_tracer_tpu.disk",
                           "render_disk_frames"),
    "render_scene_with_disk_aa": ("light_path_tracer_tpu.disk",
                                  "render_scene_with_disk_aa"),
    "render_scene_rings": ("light_path_tracer_tpu.pipeline",
                           "render_scene_rings"),
    "render_shadow_adaptive": ("light_path_tracer_tpu.adaptive",
                               "render_shadow_adaptive"),
    "render_scene_adaptive": ("light_path_tracer_tpu.adaptive",
                              "render_scene_adaptive"),
    "line_profile": ("light_path_tracer_tpu.spectra", "line_profile"),
    "render_polarization": ("light_path_tracer_tpu.polarization",
                            "render_polarization"),
    "hotspot_light_curve": ("light_path_tracer_tpu.spectra",
                            "hotspot_light_curve"),
    "render_volumetric": ("light_path_tracer_tpu.volumetric",
                          "render_volumetric"),
    "render_volumetric_spectrum": ("light_path_tracer_tpu.volumetric",
                                   "render_volumetric_spectrum"),
    "render_volumetric_movie": ("light_path_tracer_tpu.volumetric",
                                "render_volumetric_movie"),
    "render_volumetric_decomposed": ("light_path_tracer_tpu.volumetric",
                                     "render_volumetric_decomposed"),
    "render_polarized_volumetric": ("light_path_tracer_tpu.polarization",
                                    "render_polarized_volumetric"),
    "RIAFConfig": ("light_path_tracer_tpu.volumetric", "RIAFConfig"),
    "render_star": ("light_path_tracer_tpu.star", "render_star"),
    "pulse_profile": ("light_path_tracer_tpu.star", "pulse_profile"),
    "StarConfig": ("light_path_tracer_tpu.star", "StarConfig"),
    "circular_orbit": ("light_path_tracer_tpu.particles", "circular_orbit"),
    "orbit_from_apsides": ("light_path_tracer_tpu.particles",
                           "orbit_from_apsides"),
    "timelike_initial_conditions": ("light_path_tracer_tpu.particles",
                                    "timelike_initial_conditions"),
    "integrate_orbit": ("light_path_tracer_tpu.particles",
                        "integrate_orbit"),
    "periapsis_precession": ("light_path_tracer_tpu.particles",
                             "periapsis_precession"),
    "nodal_precession": ("light_path_tracer_tpu.particles",
                         "nodal_precession"),
    "trace_batch": ("light_path_tracer_tpu.ops.batch", "trace_batch"),
    "find_point_images": ("light_path_tracer_tpu.images",
                          "find_point_images"),
    "LensedImage": ("light_path_tracer_tpu.images", "LensedImage"),
    "render_panorama": ("light_path_tracer_tpu.pano", "render_panorama"),
    "render_pano_image": ("light_path_tracer_tpu.pano",
                          "render_pano_image"),
    "build_pano_lookups": ("light_path_tracer_tpu.pano",
                           "build_pano_lookups"),
    "grid_sky": ("light_path_tracer_tpu.pano", "grid_sky"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)
