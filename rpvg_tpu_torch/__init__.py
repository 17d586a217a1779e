"""rpvg_tpu_torch: the PyTorch / CUDA port of rpvg_tpu.

The port keeps the JAX package's module names so a reader can find each
counterpart.  It runs all four models end to end without Gibbs sampling
(``haplotypes`` and ``haplotype-transcripts`` at ploidy 2):

* host half: the port's own copies of the JAX package's framework-free
  modules (projection, clustering, probability matrices, the C++ library
  in ``csrc/host``, the writers), byte for byte as they are there
  (``tests/test_torch_host_copies.py`` pins each copy);
* device half: diploid pair scoring as a torch op and the EM fixed
  point as hand-written CUDA kernels (``csrc/em_fixed_point.cu`` over
  ragged tasks, ``csrc/em_fused.cu`` over padded shape buckets, both on
  the per-task loop of ``csrc/em_task.cuh``), each with a plain PyTorch
  version that CPU tensors run through.

Numerics are float64 throughout (the reference contract).  The package
imports torch and never jax or ``rpvg_tpu``.
"""

# Keep large host buffers on the reusable heap; see hostalloc.py.
from .hostalloc import tune_glibc_allocator as _tune_glibc_allocator

_tune_glibc_allocator()

__version__ = "0.1.0"
