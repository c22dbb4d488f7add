#!/usr/bin/env python
"""hunyuanvideo with sage attention (reference: example/hunyuanvideo.py).

Runs the natively-implemented hunyuanvideo-shaped video DiT with the selected
attention backend and reports per-denoise-step time and output parity.
Use --scale 1.0 for the full model geometry.
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from examples.common import base_parser, run_video_example
from sageattention_jax import models

if __name__ == "__main__":
    args = base_parser(__doc__).parse_args()
    run_video_example("hunyuanvideo", args, model_cls=models.DualStreamVideoDiT)
