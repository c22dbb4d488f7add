"""Stage-dump parity harness (reference: the fork's save-once tensor dumps,
core.py:320-352 / core.py:845-881 / gfx942.hip:270-323 — reimagined without
hot-path hacks or hardcoded /home/tmp paths).

Usage::

    dumper = StageDumper("/tmp/sage_dumps/run1")
    dumper("q_int8", q_i8)                  # saves once per key
    ...
    # offline, against another backend's dumps:
    report = dumper.compare_against("/tmp/sage_dumps/run2")

Each tensor is written once per key per run (atomic marker semantics like
the reference, but per-directory instead of global).  Comparison uses the
utils.compare metrics.
"""

from __future__ import annotations

import json
import os

import numpy as np

from sageattention_jax.utils import compare


class StageDumper:
    """Save named intermediate tensors once each, for offline parity diffs."""

    def __init__(self, directory: str, enabled: bool = True):
        self.directory = directory
        self.enabled = enabled
        self._seen: set[str] = set()
        if enabled:
            os.makedirs(directory, exist_ok=True)

    def __call__(self, key: str, value) -> None:
        if not self.enabled or key in self._seen:
            return
        self._seen.add(key)
        path = os.path.join(self.directory, f"{key}.npy")
        if os.path.exists(path):
            return  # another process/run already dumped this stage
        # per-process temp name: concurrent rank dumps of the same key
        # must not interleave writes before the atomic publish
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:  # handle: np.save would append .npy
            np.save(f, np.asarray(value))
        os.replace(tmp, path)  # atomic publish

    def keys(self) -> list[str]:
        return sorted(
            f[:-4] for f in os.listdir(self.directory) if f.endswith(".npy")
        )

    def load(self, key: str) -> np.ndarray:
        return np.load(os.path.join(self.directory, f"{key}.npy"))

    def compare_against(
        self, other_dir: str, threshold: float = 0.002
    ) -> list[dict]:
        """Diff every common stage against another dump directory
        (the offline analogue of reference utils/count.py runs)."""
        other = StageDumper(other_dir, enabled=False)
        reports = []
        common = set(self.keys()) & set(
            f[:-4] for f in os.listdir(other_dir) if f.endswith(".npy")
        )
        for key in sorted(common):
            reports.append(
                compare.compare_report(
                    self.load(key), other.load(key), name=key,
                    threshold=threshold,
                )
            )
        return reports


def load_dump(directory: str, key: str) -> np.ndarray:
    return np.load(os.path.join(directory, f"{key}.npy"))


def write_report(reports: list[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(reports, f, indent=2)
