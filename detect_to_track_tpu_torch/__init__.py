"""detect_to_track_tpu_torch: the PyTorch / CUDA port of detect_to_track_tpu
for one NVIDIA H100.

The JAX package `detect_to_track_tpu` stays the reference; this package
imports none of it and no JAX. Plain tensor code is PyTorch; each TPU
(Pallas) kernel on a ported path is a CUDA C++ kernel under `ops/csrc/`,
built with nvcc at first use. Entry points run on `cuda` unless the caller
passes `device="cpu"`.
"""

__version__ = "0.1.0"

from .config import Config, load_config
