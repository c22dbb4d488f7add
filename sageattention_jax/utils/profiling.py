"""Profiling helpers (reference: hand-rolled hipEvent pairs in
gfx942.hip:196-199 and CUDA-event timing in bench/utils.py:7-33 — replaced
by jax.profiler traces plus a per-stage wall timer).

* :func:`trace` — context manager around ``jax.profiler.trace``; open the
  written directory with TensorBoard / xprof to see per-kernel device time,
  the stand-in for nsys/rocprof (which need a profiling-capable host).
* :class:`StageTimer` — coarse per-stage wall timing with device sync, the
  analogue of the reference's event pairs around QK/softmax/SV stages.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Record a device profile: ``with trace("/tmp/prof"): step()``."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Named wall-clock stage timing with a device barrier per stage.

    Append the stage's outputs to the yielded holder so the barrier
    waits on THAT stage's computation (JAX dispatch is async — without
    it the time would land on whichever later stage happens to block)::

        t = StageTimer()
        with t("quant") as hold:
            qkv = quantize(...)
            hold.append(qkv)
        with t("attention") as hold:
            hold.append(kernel(...))
        print(t.report())
    """

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        result_holder = []
        try:
            yield result_holder
        finally:
            if result_holder:
                jax.block_until_ready(result_holder)
            else:
                # no outputs handed over: drain EVERYTHING in flight.
                # (block_until_ready on a fresh transfer would only wait
                # for that transfer, attributing this stage's async work
                # to a later stage.)
                try:
                    jax.effects_barrier()
                except Exception:
                    pass
                for dev in jax.live_arrays():
                    jax.block_until_ready(dev)
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - start
            )

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [
            f"{k:>20s}: {v*1e3:9.3f} ms ({v/total*100:5.1f}%)"
            for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
