"""chip_smoke.py's helpers on CPU arrays, and its refusal to report a
result where there is no GPU or no package next to it."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("value, op, limit, ok", [
    (0.5, "<", 1.0, True), (1.0, "<", 1.0, False),
    (1.0, "<=", 1.0, True), (1.1, "<=", 1.0, False),
    (0.9995, ">", 0.999, True), (0.999, ">", 0.999, False),
])
def test_check_passes_and_fails_on_the_limit(capsys, value, op, limit, ok):
    if ok:
        cs.check("x", value, op, limit)
    else:
        with pytest.raises(cs.PhaseFailed):
            cs.check("x", value, op, limit)
    assert ("PASS" if ok else "FAIL") in capsys.readouterr().out


def test_alpha_crit_is_read_from_cli_output():
    text = ("Shadow (integrated): 64x64, alpha_crit=3.8782 deg, "
            "precompute 0.1s")
    assert cs.alpha_crit_printed(text) == "3.8782"
    with pytest.raises(cs.PhaseFailed):
        cs.alpha_crit_printed("no angle here")


def test_angle_errors_skip_nonfinite():
    a = np.array([0.1, np.nan, 0.3, 0.4])
    b = np.array([0.1, 0.2, np.nan, 0.5])
    np.testing.assert_allclose(cs.angle_errors(a, b), [0.0, 0.1])


def test_textures_shape_and_range():
    board = cs.checkerboard(64)
    assert board.shape == (64, 64, 3) and board.dtype == np.float32
    assert len(np.unique(board[..., 0])) == 2
    smooth = cs.smooth_texture(32)
    assert smooth.shape == (32, 32, 3)
    assert smooth.min() >= 0.0 and smooth.max() <= 1.0


def test_block_walks_dataclass_results():
    @dataclasses.dataclass
    class Out:
        image: object
        n: int

    out = Out(jnp.ones(3), 4)
    assert cs._block(out) is out
    first, second, res = cs.timed(lambda: jnp.arange(4.0) * 2)
    assert first >= 0.0 and second >= 0.0
    np.testing.assert_array_equal(np.asarray(res), [0, 2, 4, 6])


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_gpu_and_prints_no_result():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run("chip_smoke.py", str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
