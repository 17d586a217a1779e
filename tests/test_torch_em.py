"""The port's EM (plain version, ragged packing, host fold) against the
JAX package: the XLA batched loop, the native ragged kernel, the Pallas
kernel in interpret mode and the host fold.  Inputs are made with numpy
from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from rpvg_tpu.infer import batching as ref_batching
from rpvg_tpu.infer import em as ref_em
from rpvg_tpu.ops.em_pallas import em_pallas_batched
from rpvg_tpu_torch.infer import batching, em
from rpvg_tpu_torch.ops import em_cuda
from rpvg_tpu_torch.testing import counted, edge_case_tasks, em_task_set

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _padded_batch(seed, B, R, C, dtype=np.float64):
    """A padded stack with masked tail columns and zero-count tail rows,
    as the bucketing produces."""
    rng = np.random.default_rng(seed)
    probs = rng.random((B, R, C))
    probs /= probs.sum(axis=2, keepdims=True)
    counts = rng.integers(1, 20, size=(B, R)).astype(np.float64)
    col_masks = np.ones((B, C))
    for b in range(B):
        n_cols = int(rng.integers(1, C + 1))
        n_rows = int(rng.integers(1, R + 1))
        col_masks[b, n_cols:] = 0.0
        probs[b, :, n_cols:] = 0.0
        probs[b, n_rows:, :] = 0.0
        counts[b, n_rows:] = 0.0
    return probs.astype(dtype), counts.astype(dtype), col_masks.astype(dtype)


@pytest.mark.parametrize(
    "seed,B,R,C,max_its",
    [(1, 8, 8, 8, 10000), (2, 16, 32, 16, 10000), (3, 4, 128, 64, 10000), (4, 8, 32, 8, 40)],
)
def test_plain_em_matches_xla_batched(seed, B, R, C, max_its):
    probs, counts, col_masks = _padded_batch(seed, B, R, C)
    ref_fracs, ref_conv, ref_its = ref_em._em_solve_batched(
        probs, counts, col_masks, np.int32(max_its), np.float64(1e-3)
    )
    fracs, conv, its = em._em_solve_batched(
        torch.from_numpy(probs), torch.from_numpy(counts), torch.from_numpy(col_masks),
        max_its, 1e-3,
    )
    np.testing.assert_allclose(fracs.numpy(), np.asarray(ref_fracs), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(ref_conv))
    assert int(its.max()) == int(ref_its)


@pytest.mark.parametrize("max_its", [10000, 50])
def test_ragged_em_matches_native(max_its):
    tasks = em_task_set(120, seed=21)
    port = batching.run_batched_em(tasks, max_its, 1e-3, CPU)
    native = ref_batching.run_native_em(tasks, max_its, 1e-3)
    for (p_counts, p_noise), (n_counts, n_noise) in zip(port, native):
        np.testing.assert_allclose(p_counts, n_counts, rtol=1e-6, atol=1e-9)
        assert p_noise == pytest.approx(n_noise, rel=1e-6, abs=1e-9)


def test_edge_case_tasks_match_native():
    """R = 1, C = 1 (noise only), an all-zero row and a zero-count row
    follow the formula with no special casing."""
    tasks = edge_case_tasks(np.random.default_rng(5))
    port = batching.run_batched_em(tasks, 10000, 1e-3, CPU)
    native = ref_batching.run_native_em(tasks, 10000, 1e-3)
    for (p_counts, p_noise), (n_counts, n_noise) in zip(port, native):
        np.testing.assert_allclose(p_counts, n_counts, rtol=1e-6, atol=1e-9)
        assert p_noise == pytest.approx(n_noise, rel=1e-6, abs=1e-9)


def test_plain_em_matches_pallas_interpret():
    """Same f32 inputs through the Pallas kernel (interpret mode, f32)
    and the port (f64): the tolerance of tests/test_em_pallas.py."""
    probs, counts, col_masks = _padded_batch(9, 4, 16, 8, dtype=np.float32)
    pallas = np.asarray(
        em_pallas_batched(probs, counts, col_masks, 500, 0.001, interpret=True)
    )
    fracs, _, _ = em._em_solve_batched(
        torch.from_numpy(probs.astype(np.float64)),
        torch.from_numpy(counts.astype(np.float64)),
        torch.from_numpy(col_masks.astype(np.float64)),
        500, 0.001,
    )
    np.testing.assert_allclose(fracs.numpy(), pallas, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_em_postprocess_bitwise(seed):
    rng = np.random.default_rng(seed)
    fracs = rng.random(13) * np.where(rng.random(13) < 0.4, 1e-9, 1.0)
    total = float(rng.integers(1, 500))
    port_counts, port_noise = batching.em_postprocess(fracs, total)
    ref_counts, ref_noise = ref_batching.em_postprocess(fracs, total)
    np.testing.assert_array_equal(port_counts, ref_counts)
    assert port_noise == ref_noise


def test_pack_ragged_matches_native_layout():
    tasks = em_task_set(30, seed=4)
    packed = batching.pack_ragged(tasks, CPU)
    n_rows = np.array([p.shape[0] for p, _ in tasks])
    n_cols = np.array([p.shape[1] for p, _ in tasks])
    np.testing.assert_array_equal(packed.n_rows.numpy(), n_rows)
    np.testing.assert_array_equal(packed.n_cols.numpy(), n_cols)
    np.testing.assert_array_equal(packed.mat_offsets.numpy(), np.concatenate([[0], np.cumsum(n_rows * n_cols)]))
    np.testing.assert_array_equal(packed.row_offsets.numpy(), np.concatenate([[0], np.cumsum(n_rows)]))
    np.testing.assert_array_equal(packed.col_offsets.numpy(), np.concatenate([[0], np.cumsum(n_cols)]))
    np.testing.assert_array_equal(packed.probs.numpy(), np.concatenate([p.ravel() for p, _ in tasks]))
    np.testing.assert_array_equal(packed.counts.numpy(), np.concatenate([c for _, c in tasks]))
    np.testing.assert_array_equal(packed.shapes, np.stack([n_rows, n_cols], axis=1))
    assert packed.probs.dtype == torch.float64 and packed.mat_offsets.dtype == torch.int64


def test_cpu_tensors_take_plain_version_without_launch():
    tasks = batching.pack_ragged(em_task_set(20, seed=8), CPU)
    with counted() as counts:
        fracs, iters = em_cuda.em_fixed_point(tasks, 10000, 1e-3)
    plain_fracs, plain_iters = em_cuda.em_fixed_point_plain(tasks, 10000, 1e-3)
    assert torch.equal(fracs, plain_fracs) and torch.equal(iters, plain_iters)
    assert counts["em.ragged.launches"] == 0


def test_other_devices_raise():
    tasks = batching.pack_ragged(em_task_set(3, seed=8), torch.device("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        em_cuda.em_fixed_point(tasks, 10000, 1e-3)
