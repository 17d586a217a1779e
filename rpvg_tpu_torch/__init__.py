"""rpvg_tpu_torch: the PyTorch / CUDA port of rpvg_tpu.

The port keeps the JAX package's module names so a reader can find each
counterpart.  It runs all four models end to end without Gibbs sampling
(``haplotypes`` and ``haplotype-transcripts`` at ploidy 2):

* host half: the JAX package's framework-free modules (projection,
  clustering, probability matrices, the C++ library, the writers),
  reached through :mod:`rpvg_tpu_torch._host` only;
* device half: diploid pair scoring as a torch op and the EM fixed
  point as hand-written CUDA kernels (``csrc/em_fixed_point.cu`` over
  ragged tasks, ``csrc/em_fused.cu`` over padded shape buckets), each
  with a plain PyTorch version that CPU tensors run through.

Numerics are float64 throughout (the reference contract).  The package
imports torch and never jax.
"""

from . import _host  # noqa: F401  (must run before any rpvg_tpu import)

__version__ = _host.__version__
