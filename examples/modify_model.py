#!/usr/bin/env python
"""Per-layer attention-processor injection (reference:
example/modify_model/modify_wan.py:9-40, example/mochi.py:11-50).

Instead of the global backend switch, a ``SageAttnProcessor`` is attached
to the model so only its attention layers run the quantized kernel — the
way the reference injects WanAttnProcessor2_0 into individual diffusers
attention modules.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from examples.common import scaled_config
from sageattention_jax import models
from sageattention_jax.models.attention import SageAttnProcessor
from sageattention_jax.utils.compare import cosine_similarity


def main():
    cfg = scaled_config("wan2.1-t2v-1.3b", 0.25)
    # keep the global backend at the baseline; inject sage per layer
    models.set_attention_backend("sdpa")
    proc = SageAttnProcessor(backend="sage", kwargs={"pv_dtype": "int8"})
    model = models.VideoDiT(cfg, processor=proc)
    baseline = models.VideoDiT(cfg)  # uses the global (sdpa) backend

    b = 1
    lat = jax.random.normal(
        jax.random.PRNGKey(0),
        (b, cfg.latent_frames, cfg.latent_height, cfg.latent_width, 16),
        jnp.bfloat16,
    )
    txt = jax.random.normal(
        jax.random.PRNGKey(1), (b, cfg.text_len, 512), jnp.bfloat16
    )
    t = jnp.array([500])
    params = model.init(jax.random.PRNGKey(2), lat, txt, t)

    out_sage = jax.jit(model.apply)(params, lat, txt, t)
    out_base = jax.jit(baseline.apply)(params, lat, txt, t)
    jax.block_until_ready((out_sage, out_base))
    print(f"wan-shaped DiT, injected SageAttnProcessor: "
          f"parity vs sdpa cosine={cosine_similarity(out_sage, out_base):.6f}")


if __name__ == "__main__":
    main()
