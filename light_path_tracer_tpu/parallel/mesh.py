"""Device mesh construction for image-tile data parallelism.

The reference's only cross-worker parallelism is ProcessPoolExecutor rows
(debugging_image_lense.py:530-592); the equivalent here is a
`jax.sharding.Mesh` over the GPUs with the pixel grid sharded across it.
Ray tracing is embarrassingly parallel, and the cards of one host are
joined all to all, so a 1-D mesh is the whole layout: the only collective
(the final tile gather) rides NVLink.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None,
              axis_name: str = "tiles") -> Mesh:
    """1-D mesh over the first `n_devices` devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def shard_map_fn():
    """jax.shard_map across JAX versions, with vma checking disabled.

    The tracer's while_loop carry mixes mesh-invariant initial values
    (broadcast scalars) with varying outputs, which the strict
    varying-manual-axes checker rejects; the computation itself is purely
    per-shard, so the check is safely disabled.
    """
    if hasattr(jax, "shard_map"):
        base = jax.shard_map
    else:  # pragma: no cover
        from jax.experimental.shard_map import shard_map as base

    def wrapped(f, **kwargs):
        for key in ("check_vma", "check_rep"):
            try:
                return base(f, **kwargs, **{key: False})
            except TypeError:
                continue
        return base(f, **kwargs)  # pragma: no cover

    return wrapped
