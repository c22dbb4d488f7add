"""Interop adapters: run the framework from other tensor stacks.

The reference's public surface is torch (``sageattn(q, k, v)`` on torch
tensors, installed by monkey-patching
``torch.nn.functional.scaled_dot_product_attention`` — reference
example/cogvideox-2b.py:16-23).  A user switching from the reference to
this framework can keep that exact integration style:

    from sageattention_jax.interop import sageattn_torch, patch_torch_sdpa

    out = sageattn_torch(q, k, v, is_causal=True)   # torch in, torch out
    undo = patch_torch_sdpa()                       # drop-in SDPA patch
    ...
    undo()

Tensors cross via DLPack (zero-copy on CPU); results come back as torch
tensors.  For native JAX pipelines use :mod:`sageattention_jax.core`
directly — the adapter syncs per call by design.
"""

from sageattention_jax.interop.jax_sdpa import (  # noqa: F401
    dot_product_attention,
    patch_jax_sdpa,
)
from sageattention_jax.interop.torch_adapter import (  # noqa: F401
    from_torch,
    patch_torch_sdpa,
    sageattn_torch,
    to_torch,
)

__all__ = [
    "from_torch",
    "to_torch",
    "sageattn_torch",
    "patch_torch_sdpa",
    "dot_product_attention",
    "patch_jax_sdpa",
]
