"""The one gateway from the port to the JAX package's framework-free
host modules.

The host half of the pipeline (projection, path index, clustering,
probability matrices, the C++ library and the writers) imports no JAX,
but importing any ``rpvg_tpu`` submodule first runs
``rpvg_tpu/__init__.py``, which imports jax unless both
``RPVG_TPU_DISABLE_X64=1`` and ``RPVG_TPU_NO_COMPILE_CACHE=1`` are set.

* Where jax is not installed (the machine with the card), both variables
  are set here, before the first ``import rpvg_tpu``.
* Where jax is installed, they are left alone: in a shared test process
  setting them would switch x64 off for every reference test that runs
  after this import.

This module never imports ``rpvg_tpu.pipeline``, ``rpvg_tpu.backend``,
``rpvg_tpu.infer.{em,batching,posteriors,estimators,batched_models,
readcount_gibbs}``, ``rpvg_tpu.ops`` or ``rpvg_tpu.parallel``: each of
those imports jax.  ``rpvg_tpu_torch/__init__.py`` imports this module
first, so every later ``from rpvg_tpu.<host module> import ...`` in the
port runs after the variables are settled.
"""

from __future__ import annotations

import importlib.util
import os

if importlib.util.find_spec("jax") is None:
    os.environ["RPVG_TPU_DISABLE_X64"] = "1"
    os.environ["RPVG_TPU_NO_COMPILE_CACHE"] = "1"

import rpvg_tpu  # noqa: E402
from rpvg_tpu import alignments, native, sim  # noqa: E402,F401
from rpvg_tpu.io import rpa  # noqa: E402,F401

__version__ = rpvg_tpu.__version__
