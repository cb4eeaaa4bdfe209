"""Stage timers + lightweight structured logging.

Equivalent of the reference's TRACE macro / wall-clock prints
(``include/ms/Debug.h:28-32``, ``pipeline/pipeline.sh:110``): per-stage
host timers that can be dumped as JSON, plus optional ``jax.profiler``
trace capture around a stage.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    stages: dict[str, float] = field(default_factory=dict)
    counters: dict[str, int] = field(default_factory=dict)
    verbose: bool = field(default_factory=lambda: bool(os.environ.get("MS_TPU_TRACE")))

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.stages[name] = self.stages.get(name, 0.0) + elapsed
            if self.verbose:
                print(f"[ms-tpu] {name}: {elapsed:.3f}s", file=sys.stderr)

    def count(self, name: str, value: int) -> None:
        self.counters[name] = value
        if self.verbose:
            print(f"[ms-tpu] {name} = {value}", file=sys.stderr)

    def dump(self) -> str:
        return json.dumps(
            {"stages": self.stages, "counters": self.counters, "memory": memory_stats()},
            indent=2,
        )


def memory_stats() -> dict:
    """Peak host RSS + device memory, the TrackingAllocator equivalent
    (reference ``src/TrackingAllocator.cpp``, printed under
    TRACK_MEMORY_USAGE at ``main.cpp:317-319``)."""
    out: dict = {}
    try:
        import resource

        out["host_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        pass
    try:
        import jax

        stats = jax.devices()[0].memory_stats()
        if stats:
            out["device_bytes_in_use"] = stats.get("bytes_in_use")
            out["device_peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    except Exception:
        pass
    return out


@contextlib.contextmanager
def jax_profile(outdir: str | None):
    """Capture a jax.profiler trace around a block when ``outdir`` is set."""
    if not outdir:
        yield
        return
    import jax

    jax.profiler.start_trace(outdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
