"""Checkpoint/resume of a pytree as numpy ``.npz`` files.

``save(directory, step, tree)`` writes ``step_<n>.npz`` (one array per
leaf, in flattening order) and keeps the newest ``max_to_keep``;
``restore(directory, step, like)`` rebuilds a tree shaped like ``like``.
The write goes to a temporary name first and is renamed into place, so a
job killed mid-save leaves the previous checkpoint intact.
"""

from __future__ import annotations

import os
import re

import jax
import jax.numpy as jnp
import numpy as np

_NAME = re.compile(r"^step_(\d+)\.npz$")


def all_steps(directory) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m
    )


def latest_step(directory) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _path(directory, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.npz")


def save(directory, step: int, tree, max_to_keep: int = 2) -> None:
    os.makedirs(directory, exist_ok=True)
    leaves = jax.tree.leaves(jax.device_get(tree))
    tmp = os.path.join(directory, f".tmp_step_{step:08d}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, *[np.asarray(x) for x in leaves])
    os.replace(tmp, _path(directory, step))
    for old in all_steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))


def restore(directory, step: int, like):
    """The checkpoint of ``step`` as a tree with ``like``'s structure and
    leaf dtypes (``like`` may hold arrays or ShapeDtypeStructs)."""
    leaves, treedef = jax.tree.flatten(like)
    with np.load(_path(directory, step)) as data:
        saved = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(saved) != len(leaves):
        raise ValueError(
            f"checkpoint holds {len(saved)} arrays, the template "
            f"{len(leaves)}"
        )
    out = []
    for x, ref in zip(saved, leaves):
        if x.shape != tuple(ref.shape):
            raise ValueError(f"shape {x.shape} != template {ref.shape}")
        if x.dtype.kind == "V":  # bfloat16 and friends round-trip as void
            x = x.view(ref.dtype)
        out.append(jnp.asarray(x, ref.dtype))
    return jax.tree.unflatten(treedef, out)
