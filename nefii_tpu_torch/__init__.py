"""nefii_tpu_torch — the PyTorch + CUDA port of nefii_tpu.

The JAX package `nefii_tpu` stays the reference; this package mirrors its
module names (models/, ops/, utils/, datasets/, scripts/) so every module
has a counterpart to be held against. It never imports JAX. The two fused
SDF-MLP kernels live in `ops/kernels/` as hand-written CUDA C++ built at
first use with nvcc.
"""

__version__ = "0.1.0"
