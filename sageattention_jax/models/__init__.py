from sageattention_jax.models.attention import (
    attention,
    set_attention_backend,
    get_attention_backend,
    set_mesh,
    sage_attention_fn,
    SageAttnProcessor,
)
from sageattention_jax.models.configs import MODEL_CONFIGS, DiTConfig, LLMConfig
from sageattention_jax.models.dit import VideoDiT
from sageattention_jax.models.llm import CausalLM
from sageattention_jax.models.mmdit import (
    CrossAttnVideoDiT,
    DualStreamVideoDiT,
)

__all__ = [
    "attention",
    "set_attention_backend",
    "get_attention_backend",
    "SageAttnProcessor",
    "sage_attention_fn",
    "MODEL_CONFIGS",
    "DiTConfig",
    "LLMConfig",
    "VideoDiT",
    "CausalLM",
    "DualStreamVideoDiT",
    "CrossAttnVideoDiT",
]
