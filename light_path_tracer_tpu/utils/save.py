"""PNG save for the main path: numpy + zlib, no matplotlib.

Images are quantized to uint8 ON DEVICE before the readback (1-4 B/px
instead of 12-16), then encoded here. The pixels are those matplotlib's
``mpimg.imsave`` writes for the same input — RGBA, float channels
truncated as ``(clip(x, 0, 1) * 255).astype(uint8)``, colormaps through
their 256-entry lookup tables — so switching encoders changed no image.
Pinned against matplotlib in tests/test_save.py (where it is installed).
Plots, image reading and the other colormaps still use matplotlib (the
optional ``viz`` extra).

Reference analogue: the save path /root/reference/image_lens.py:510
(mpimg.imsave of the float image).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def quantize_u8(img):
    """[0,1] float image -> uint8 on the SAME device, matplotlib-
    identical quantization (clip then truncate)."""
    import jax.numpy as jnp
    q = jnp.clip(img, 0.0, 1.0) * 255.0
    return q.astype(jnp.uint8)


def quantize_cmap_index(img):
    """[0,1] float scalar image -> uint8 colormap INDEX on the same
    device, matching matplotlib Colormap.__call__'s float quantization
    exactly (``clip(int(x * 256), 0, 255)``). Read back 1 byte/px and
    apply the lookup table on the host."""
    import jax.numpy as jnp
    idx = jnp.clip((img * 256.0).astype(jnp.int32), 0, 255)
    return idx.astype(jnp.uint8)


def _lut_from_segments(x, y):
    """matplotlib's 256-entry table for a linear segment map whose
    breakpoints x carry values y (its _create_lookup_table)."""
    n = 256
    x = np.asarray(x, float) * (n - 1)
    y = np.asarray(y, float)
    xind = (n - 1) * np.linspace(0.0, 1.0, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1])
                          + y[ind - 1], [y[-1]]])
    return np.clip(lut, 0.0, 1.0)


def colormap_lut(name: str) -> np.ndarray:
    """(256, 4) uint8 RGBA table of a matplotlib colormap: "gray" (the
    shadow CLI) or "afmhot" (the disk CLI), written out in numpy."""
    if name == "gray":
        rgb = [_lut_from_segments([0.0, 1.0], [0.0, 1.0])] * 3
    elif name == "afmhot":
        # gnuplot's afmhot: r = 2x, g = 2x - 1/2, b = 2x - 1, clipped.
        x = np.linspace(0.0, 1.0, 256)
        rgb = [np.clip(2.0 * x - off, 0.0, 1.0) for off in (0.0, 0.5, 1.0)]
    else:
        raise ValueError(f"no built-in lookup table for {name!r}; "
                         f"use matplotlib for other colormaps")
    lut = np.stack(rgb + [np.ones(256)], axis=-1)
    return (lut * 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, pixels) -> None:
    """Write a uint8 (H, W), (H, W, 3) or (H, W, 4) array as an 8-bit
    gray, RGB or RGBA PNG (filter 0 on every row, zlib level 6)."""
    arr = np.ascontiguousarray(pixels)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_png needs uint8 pixels, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    height, width, channels = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}.get(channels)
    if color_type is None:
        raise ValueError(f"write_png needs 1, 3 or 4 channels, got "
                         f"{channels}")
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8),
         arr.reshape(height, width * channels)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _rgba(arr):
    if arr.ndim == 3 and arr.shape[-1] == 3:
        alpha = np.full(arr.shape[:2] + (1,), 255, np.uint8)
        arr = np.concatenate([arr, alpha], axis=-1)
    return arr


def save_png(path, img) -> None:
    """Save a [0,1] float RGB(A) image (device or host) or a uint8 one as
    an RGBA PNG — the pixels mpimg.imsave(path, img) writes. A device
    array is quantized before the readback."""
    if isinstance(img, np.ndarray):
        arr = img
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    else:
        arr = np.asarray(quantize_u8(img))
    write_png(path, _rgba(arr))


def save_cmap_png(path, img, cmap: str) -> None:
    """Save a [0,1] scalar image through the "gray" or "afmhot" colormap
    — the pixels of mpimg.imsave(path, img, cmap=cmap, vmin=0, vmax=1).
    A device array is quantized to colormap indices before the
    readback."""
    if isinstance(img, np.ndarray):
        idx = np.clip((img * 256.0).astype(np.int64), 0, 255)
    else:
        idx = np.asarray(quantize_cmap_index(img))
    write_png(path, colormap_lut(cmap)[idx])
