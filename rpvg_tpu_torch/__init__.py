"""rpvg_tpu_torch: the PyTorch / CUDA port of rpvg_tpu.

The port keeps the JAX package's module names so a reader can find each
counterpart.  It runs every configuration of the JAX package's CLI: the
four models, read-count Gibbs sampling (``-n``), ``haplotypes`` and
``haplotype-transcripts`` at every ploidy, ``--use-hap-gibbs``,
``--ind-hap-inference``, ``--multiprocess`` and the fused native routes;
``python -m rpvg_tpu_torch.tools`` converts inputs (``json-to-rpa``,
``gamp-to-json``):

* host half: the port's own copies of the JAX package's framework-free
  modules (projection, clustering, probability matrices, the C++ library
  in ``csrc/host``, the writers, the input tools), byte for byte as they
  are there (``tests/test_torch_host_copies.py`` pins each copy);
* device half: the EM fixed point, the Gibbs samplers and the multiset
  group scorer as hand-written CUDA kernels (``csrc/*.cu``), each with a
  plain PyTorch version that CPU tensors run through; diploid pair
  scoring as a torch op on ``cuda`` and, on ``cpu``, in the C++
  library, as the JAX package scores it off the TPU.

Numerics are float64 throughout (the reference contract).  The package
imports torch and never jax or ``rpvg_tpu``.
"""

# Keep large host buffers on the reusable heap; see hostalloc.py.
from .hostalloc import tune_glibc_allocator as _tune_glibc_allocator

_tune_glibc_allocator()

__version__ = "0.1.0"
