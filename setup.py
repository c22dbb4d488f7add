"""Build & packaging (reference: the reference's setup.py:76-260 probes GPU
arches and conditionally compiles CUDA/HIP extensions).

No device code is compiled at install time — the attention kernel is
Pallas, which Triton compiles when it is first traced on the GPU, so the
per-arch extension matrix disappears.  The only native piece is the host-side
varlen/data-prep library (csrc/host/varlen_pack.cpp, plain C++ with a
ctypes binding); it is built here when a toolchain exists and on demand at
runtime otherwise (sageattention_jax/native.py falls back to numpy when
neither works).
"""

import shutil

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        super().run()
        if shutil.which("g++"):
            import sys

            sys.path.insert(0, ".")
            from sageattention_jax.native import ensure_built

            path = ensure_built()
            if path:
                print(f"built native host library: {path}")
            else:
                print("native host library build failed; numpy fallback "
                      "will be used")


setup(cmdclass={"build_py": BuildWithNative})
