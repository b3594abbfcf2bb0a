"""utils/save.py: the numpy + zlib PNG writer must write the pixels
matplotlib's mpimg.imsave writes for the same input (decoded and
compared; the files themselves differ in compression and metadata), and
the main-path save must not need matplotlib at all."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import jax.numpy as jnp

from light_path_tracer_tpu.utils.save import (
    colormap_lut, quantize_cmap_index, quantize_u8, save_cmap_png, save_png,
    write_png)


def _decode(path):
    """Minimal PNG decoder for 8-bit gray/RGB/RGBA files whose rows all
    use filter 0 (what write_png writes)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    width, height, depth, color_type = header[:4]
    assert depth == 8
    channels = {0: 1, 2: 3, 6: 4}[color_type]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + width * channels)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(height, width, channels)


def _imread_u8(path):
    """Decode any PNG with matplotlib, as uint8 RGBA."""
    mpimg = pytest.importorskip("matplotlib.image")
    arr = mpimg.imread(str(path))
    if arr.dtype != np.uint8:
        arr = np.round(arr * 255).astype(np.uint8)
    return arr


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_roundtrip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    px = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    f = tmp_path / "x.png"
    write_png(str(f), px[..., 0] if channels == 1 else px)
    np.testing.assert_array_equal(_decode(f), px)


def test_write_png_rejects_float_and_bad_channels(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "a.png"), np.zeros((4, 4, 3)))
    with pytest.raises(ValueError, match="channels"):
        write_png(str(tmp_path / "b.png"), np.zeros((4, 4, 2), np.uint8))


def test_png_bytes_identical_to_float_imsave(tmp_path):
    """The decoded pixel bytes equal matplotlib's float imsave."""
    mpimg = pytest.importorskip("matplotlib.image")
    rng = np.random.default_rng(0)
    img = rng.random((48, 64, 3)).astype(np.float32)
    # include exact-boundary and out-of-range values (cli clips, but
    # the helper must be safe without it)
    img[0, 0] = [0.0, 1.0, 0.5]
    img[0, 1] = [-0.2, 1.3, 0.999999]

    f_float = tmp_path / "float.png"
    f_dev = tmp_path / "dev.png"
    mpimg.imsave(str(f_float), np.clip(img, 0.0, 1.0))
    save_png(str(f_dev), jnp.asarray(img))
    np.testing.assert_array_equal(_imread_u8(f_float), _decode(f_dev))


def test_quantize_matches_matplotlib_truncation():
    rng = np.random.default_rng(1)
    img = rng.random((32, 32, 3)).astype(np.float32)
    q = np.asarray(quantize_u8(jnp.asarray(img)))
    ref = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    np.testing.assert_array_equal(q, ref)


def test_save_png_numpy_passthrough(tmp_path):
    mpimg = pytest.importorskip("matplotlib.image")
    rng = np.random.default_rng(2)
    img = rng.random((8, 8, 3)).astype(np.float64)
    f1 = tmp_path / "a.png"
    f2 = tmp_path / "b.png"
    mpimg.imsave(str(f1), img)
    save_png(str(f2), img)
    np.testing.assert_array_equal(_imread_u8(f1), _decode(f2))


@pytest.mark.parametrize("name", ["gray", "afmhot"])
def test_colormap_lut_matches_matplotlib(name):
    cm = pytest.importorskip("matplotlib.cm")
    ref = getattr(cm, name)(np.arange(256), bytes=True)
    np.testing.assert_array_equal(colormap_lut(name), ref)


def test_colormap_lut_rejects_unknown():
    with pytest.raises(ValueError, match="viridis"):
        colormap_lut("viridis")


def test_cmap_index_matches_matplotlib_float_path():
    cm = pytest.importorskip("matplotlib.cm")
    rng = np.random.default_rng(3)
    x = rng.random((40, 40)).astype(np.float32)
    x[0, :4] = [0.0, 1.0, 0.5, 0.999999]
    ref = cm.afmhot(x)
    idx = np.asarray(quantize_cmap_index(jnp.asarray(x)))
    assert idx.dtype == np.uint8
    alt = cm.afmhot(idx)
    np.testing.assert_array_equal(ref, alt)


@pytest.mark.parametrize("cmap", ["gray", "afmhot"])
@pytest.mark.parametrize("on_device", [True, False])
def test_gray_cmap_bytes_roundtrip_identical(tmp_path, cmap, on_device):
    """The shadow (gray) and disk (afmhot) CLI saves: the pixels of
    mpimg.imsave(float, cmap=cmap, vmin=0, vmax=1)."""
    mpimg = pytest.importorskip("matplotlib.image")
    rng = np.random.default_rng(4)
    img = rng.random((24, 24)).astype(np.float32)
    img[0, :4] = [0.0, 1.0, 0.5, 0.999999]
    f1 = tmp_path / "float.png"
    f2 = tmp_path / "idx.png"
    mpimg.imsave(str(f1), img, cmap=cmap, vmin=0, vmax=1)
    save_cmap_png(str(f2), jnp.asarray(img) if on_device else img, cmap)
    np.testing.assert_array_equal(_imread_u8(f1), _decode(f2))


def test_shadow_save_runs_without_matplotlib(tmp_path):
    """The shadow CLI's render + save with matplotlib blocked: the main
    path imports only JAX, numpy, scipy and the standard library."""
    out = tmp_path / "s.png"
    code = (
        "import sys\n"
        "for m in ('matplotlib', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from light_path_tracer_tpu.cli.app import main\n"
        f"rc = main(['shadow', '--size', '24', '--a', '0.9', "
        f"'--output', {str(out)!r}])\n"
        "assert rc == 0, rc\n"
        "assert not any(k.startswith('matplotlib') and sys.modules[k] "
        "for k in sys.modules)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", LPT_COMPILE_CACHE_OFF="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    px = _decode(out)
    assert px.shape == (24, 24, 4)
    assert (px[..., :3] == 0).any() and (px[..., :3] == 255).any()


def test_viz_mode_without_matplotlib_says_so(tmp_path):
    """A mode that plots needs the optional viz extra: with matplotlib
    missing the CLI says so and exits 2 instead of a traceback."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from light_path_tracer_tpu.cli.app import main\n"
        f"rc = main(['lens', '--magnification', "
        f"{str(tmp_path / 'm.png')!r}, '--size', '8'])\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", LPT_COMPILE_CACHE_OFF="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2, r.stderr[-2000:]
    assert "viz extra" in r.stderr
