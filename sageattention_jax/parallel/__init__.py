from sageattention_jax.parallel.mesh import make_mesh
from sageattention_jax.parallel.ring import ring_sageattn, make_ring_attention
from sageattention_jax.parallel.ulysses import (
    ulysses_sageattn,
    make_ulysses_attention,
)
from sageattention_jax.parallel.api import make_parallel_sageattn
from sageattention_jax.parallel.decode import (
    make_sharded_append,
    make_sharded_decode,
    make_sharded_paged_append,
    make_sharded_paged_decode,
)

__all__ = [
    "make_mesh",
    "ring_sageattn",
    "make_ring_attention",
    "ulysses_sageattn",
    "make_ulysses_attention",
    "make_parallel_sageattn",
    "make_sharded_decode",
    "make_sharded_append",
    "make_sharded_paged_decode",
    "make_sharded_paged_append",
]
