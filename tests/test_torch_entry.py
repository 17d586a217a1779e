"""The port's entry points (``rpvg_tpu_torch/entry.py``) on the CPU:
``entry()`` against ``__graft_entry__.entry()`` on the same example
batch, the multi-device dry run on 8 virtual CPU shards, and the dry run's
refusal to fall back to the CPU when CUDA is asked for."""

import importlib.util
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from rpvg_tpu_torch import entry
from rpvg_tpu_torch.device import DeviceUnavailableError

from test_torch_slice import REPO, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_matches_jax_entry():
    ref_fn, ref_args = _graft_entry().entry()
    ref = np.asarray(jax.jit(ref_fn)(*ref_args))
    fn, args = entry.entry("cpu")
    assert all(a.dtype == torch.float64 and a.device == CPU for a in args)
    out = fn(*args)
    assert out.shape == ref.shape == (4, 16)
    # The JAX inputs are float32.
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)
    np.testing.assert_allclose(out.sum(dim=1).numpy(), 1.0, rtol=1e-12)


def test_dryrun_multidevice_8_virtual_cpu_shards(monkeypatch):
    report = entry.dryrun_multidevice(8, "cpu", virtual=True)
    assert report["regimes"] == {"score": "byte-identical", "qual": "byte-identical"}
    assert report["sharded_giant_clusters"] > 0
    assert not os.environ.get("RPVG_TPU_NATIVE_EM") and not os.environ.get("RPVG_TPU_AUTOSHARD")


@pytest.mark.parametrize("virtual", [False, True])
def test_dryrun_on_cuda_without_cuda_raises_and_writes_nothing(virtual, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(DeviceUnavailableError):
        entry.dryrun_multidevice(2, "cuda", virtual=virtual)
    with pytest.raises(DeviceUnavailableError):
        entry.entry("cuda")
    assert os.listdir(tmp_path) == []


def test_dryrun_needs_virtual_for_more_than_one_cpu_shard(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(DeviceUnavailableError, match="virtual=True"):
        entry.dryrun_multidevice(2, "cpu")
    assert os.listdir(tmp_path) == []
