"""rpvg_tpu_torch: the PyTorch / CUDA port of rpvg_tpu.

The port keeps the JAX package's module names so a reader can find each
counterpart.  It runs the ``haplotype-transcripts`` model (ploidy 2,
collapsed groups, no Gibbs) end to end:

* host half: the JAX package's framework-free modules (projection,
  clustering, probability matrices, the C++ library, the writers),
  reached through :mod:`rpvg_tpu_torch._host` only;
* device half: diploid pair scoring as a torch op and the EM fixed
  point as a hand-written CUDA kernel (``csrc/em_fixed_point.cu``),
  each with a plain PyTorch version that CPU tensors run through.

Numerics are float64 throughout (the reference contract).  The package
imports torch and never jax.
"""

from . import _host  # noqa: F401  (must run before any rpvg_tpu import)

__version__ = _host.__version__
