from sageattention_jax.utils.compare import (  # noqa: F401
    compare_report,
    cosine_similarity,
    per_axis_cosine,
    rel_err_rate,
)
from sageattention_jax.utils.dump import StageDumper, load_dump  # noqa: F401
from sageattention_jax.utils.profiling import (  # noqa: F401
    StageTimer,
    trace,
)
