"""Command-line interface.

Flag parity with the reference (`image_lens.py:519-532`): --M --a --r-obs
--psi-y --psi-x --fov-v, same semantics and defaults (psi in degrees,
r-obs in units of M, vertical FOV in degrees). Extends it with subcommands
for the other entry points (shadow render, single-ray demo, trajectory
plot) and accelerator knobs (dtype, chunking, lookup cache, device mesh).

Usage:
  python -m light_path_tracer_tpu lens   --a 0.9 --image image.jpg
  python -m light_path_tracer_tpu shadow --a 0.9 --size 1024
  python -m light_path_tracer_tpu shadow --analytic          # zero-integration
  python -m light_path_tracer_tpu ray    --alpha-deg 8       # single-ray demo
  python -m light_path_tracer_tpu plot   --angles 0,2,4,5.5,5.97,8
"""

from light_path_tracer_tpu.cli.app import build_parser, main
from light_path_tracer_tpu.cli._shared import (_render_cfg_from,
                                               _scene_from)

__all__ = ["build_parser", "main"]
