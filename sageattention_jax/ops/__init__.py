from sageattention_jax.ops import reference  # noqa: F401
