"""Device-mesh construction helpers.

The reference delegates all parallelism to xDiT/torchrun over NCCL
(reference: example/run_parallel.sh:48, parallel_sageattn_cogvideo.py:30-39).
Here it is a named `jax.sharding.Mesh` with axes for data/CFG ("data"),
sequence ("seq"), and heads ("heads") — the degrees mirror xFuserArgs'
cfg/ring/ulysses degrees — and XLA lowers the collectives to NCCL.  The
cards of one host are joined all to all by NVLink, so the mesh follows the
algorithm alone: no device reordering.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(
    data: int = 1,
    seq: int = 1,
    heads: int = 1,
    *,
    devices=None,
) -> Mesh:
    """Build a ("data", "seq", "heads") mesh.

    ``data`` carries DP and classifier-free-guidance branches (xDiT
    --use_cfg_parallel), ``seq`` carries ring/context parallelism (xDiT
    --ring_degree), ``heads`` carries Ulysses head parallelism (xDiT
    --ulysses_degree).  Degrees must multiply to the device count, like
    the reference example validates (parallel_sageattn_cogvideo.py:32-36).
    """
    if devices is None:
        devices = jax.devices()
    n = data * seq * heads
    if n != len(devices):
        raise ValueError(
            f"data*seq*heads = {n} must equal device count {len(devices)}"
        )
    arr = np.asarray(devices).reshape(data, seq, heads)
    return Mesh(arr, axis_names=("data", "seq", "heads"))
