"""Profiling + live telemetry.

The reference instruments per-stage wall-clock + MPix/s
(image_lens.py:404-425) and its legacy harness samples CPU utilization
from /proc/<pid>/stat and RSS/peak-RSS from /proc/<pid>/status
(debugging_image_lense.py:19-172). Device-side equivalents:

  * `profile(path)` — jax.profiler trace context; view in TensorBoard /
    XProf to see per-op device time (the XLA analogue of the legacy
    harness's live core counters).
  * `device_memory()` — per-device HBM stats from the PJRT allocator.
  * `HostTelemetry` — RSS / peak-RSS / CPU-time sampling of this process
    (same /proc sources as the reference, new implementation).
"""

from __future__ import annotations

import contextlib
import os
import time

import jax


@contextlib.contextmanager
def profile(log_dir: str = "/tmp/lpt_profile"):
    """jax.profiler trace around a block; artifacts go to `log_dir`."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_memory():
    """Per-device memory stats (bytes). Keys vary by backend;
    'bytes_in_use' and 'peak_bytes_in_use' are present on GPU PJRT."""
    out = {}
    for d in jax.local_devices():
        try:
            stats = d.memory_stats()
        except Exception:
            stats = None
        out[str(d)] = stats
    return out


class HostTelemetry:
    """Process CPU-time and memory sampling from /proc (Linux)."""

    def __init__(self):
        self._clk = os.sysconf("SC_CLK_TCK")
        self._t0 = time.monotonic()
        self._cpu0 = self._cpu_seconds()

    def _cpu_seconds(self) -> float:
        with open(f"/proc/{os.getpid()}/stat") as f:
            fields = f.read().split()
        utime, stime = int(fields[13]), int(fields[14])
        return (utime + stime) / self._clk

    def memory(self) -> dict:
        """Current and peak RSS in MiB from /proc/self/status."""
        rss = peak = None
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) / 1024.0
                elif line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) / 1024.0
        return {"rss_mib": rss, "peak_rss_mib": peak}

    def sample(self) -> dict:
        """CPU utilization since construction + memory snapshot."""
        wall = max(time.monotonic() - self._t0, 1e-9)
        cpu = self._cpu_seconds() - self._cpu0
        out = {"wall_s": wall, "cpu_s": cpu, "cpu_util": cpu / wall}
        out.update(self.memory())
        return out
