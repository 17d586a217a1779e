"""The port's multi-bucket EM (plain padded version, bucket plan, fused
dispatch and host fold) against the JAX package: the fused and
single-bucket Pallas kernels in interpret mode, the XLA batched loop,
the JAX package's own dispatch and the native ragged kernel.  Inputs are
made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from rpvg_tpu.infer import batching as ref_batching
from rpvg_tpu.infer.em import em_abundances_batched
from rpvg_tpu.ops.em_pallas import em_pallas_batched, em_pallas_fused
from rpvg_tpu_torch.infer import batching
from rpvg_tpu_torch.ops import em_cuda, em_fused_cuda
from rpvg_tpu_torch.testing import counted, em_task_set, padded_block_set, random_task

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _pallas_test_blocks():
    """The blocks of tests/test_em_pallas.py::test_pallas_fused_matches_per_block."""
    rng = np.random.default_rng(11)
    blocks = []
    for B, R, C in ((4, 16, 8), (2, 32, 16), (8, 8, 8)):
        probs = rng.random((B, R, C)).astype(np.float32)
        probs /= probs.sum(axis=2, keepdims=True)
        counts = rng.integers(1, 20, size=(B, R)).astype(np.float32)
        masks = np.ones((B, C), dtype=np.float32)
        masks[0, C // 2 :] = 0.0
        probs[0, :, C // 2 :] = 0.0
        blocks.append((probs, counts, masks))
    return blocks


def _to_torch(blocks):
    return [
        tuple(torch.from_numpy(np.asarray(a, dtype=np.float64)) for a in block)
        for block in blocks
    ]


def test_plain_padded_matches_pallas_fused_and_single():
    """f32 inputs through the Pallas kernels (interpret mode, f32) and
    the port (f64): the tolerance of tests/test_em_pallas.py."""
    blocks = _pallas_test_blocks()
    fused = em_pallas_fused(blocks, 500, 0.001, interpret=True)
    port, _ = em_fused_cuda.em_fixed_point_padded_plain(_to_torch(blocks), 500, 0.001)
    for block, fused_out, port_out in zip(blocks, fused, port):
        single = np.asarray(em_pallas_batched(*block, 500, 0.001, interpret=True))
        np.testing.assert_allclose(port_out.numpy(), np.asarray(fused_out), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(port_out.numpy(), single, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("max_its", [10000, 50])
def test_plain_padded_matches_xla_batched(max_its):
    blocks = padded_block_set(3)
    port, port_iters = em_fused_cuda.em_fixed_point_padded(_to_torch(blocks), max_its, 1e-3)
    for (probs, counts, masks), fracs, iters in zip(blocks, port, port_iters):
        ref, _ = em_abundances_batched(probs, counts, masks, max_its, 1e-3)
        np.testing.assert_allclose(fracs.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)
        assert int(iters.max()) <= max_its
    dummy_fracs, dummy_iters = port[0][-1], port_iters[0][-1]
    assert not dummy_fracs.any() and int(dummy_iters) == 10


def _results_close(got, want):
    for (got_counts, got_noise), (want_counts, want_noise) in zip(got, want):
        np.testing.assert_allclose(got_counts, want_counts, rtol=1e-6, atol=1e-9)
        assert got_noise == pytest.approx(want_noise, rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("fuse", ["0", "1"])
def test_dispatch_matches_reference_dispatch_and_native(fuse, monkeypatch):
    # The plain padded route (with the native EM, the CPU dispatch takes
    # run_native_em as run_batched_em does).
    monkeypatch.setenv("RPVG_TPU_NATIVE_EM", "0")
    monkeypatch.setenv("RPVG_TPU_FUSE_EM", fuse)
    tasks = em_task_set(300, seed=23)
    indices = list(range(len(tasks)))
    groups = batching.plan_em_groups(tasks, indices)
    if fuse == "1":
        assert any(len(group) >= 2 for group in groups)
    else:
        assert all(len(group) == 1 for group in groups)
    assert sorted(i for g in groups for chunk, _, _ in g for i in chunk) == indices

    results = [None] * len(tasks)
    batching.gather_em_device(
        batching.dispatch_em_device(tasks, indices, 10000, 1e-3, CPU), tasks, results
    )
    ref_results = [None] * len(tasks)
    ref_batching.gather_em_device(
        ref_batching.dispatch_em_device(tasks, indices, 10000, 1e-3, use_pallas="off"),
        tasks, ref_results,
    )
    _results_close(results, ref_results)
    _results_close(results, ref_batching.run_native_em(tasks, 10000, 1e-3))


@pytest.mark.parametrize("max_its", [10000, 50])
def test_fused_route_of_run_batched_em_matches_native(max_its, monkeypatch):
    tasks = em_task_set(120, seed=29)
    monkeypatch.setenv("RPVG_TPU_FUSE_EM", "1")
    _results_close(
        batching.run_batched_em(tasks, max_its, 1e-3, CPU),
        ref_batching.run_native_em(tasks, max_its, 1e-3),
    )


def test_plan_chunks_follows_reference_buckets():
    """Rows to powers of four, columns to powers of two, chunks of
    max(1, 4096 // R_pad) * 8 tasks."""
    shapes = [(3, 9)] * 70 + [(600, 5), (2000, 70), (9, 2)]
    plans = batching.plan_chunks(shapes, range(len(shapes)))
    assert [(len(c), R, C) for c, R, C in plans] == [
        (70, 8, 16), (1, 2048, 8), (1, 2048, 128), (1, 32, 8),
    ]
    many = batching.plan_chunks([(600, 5)] * 40, range(40))
    assert [len(c) for c, _, _ in many] == [16, 16, 8]


def test_fused_group_respects_launch_bytes(monkeypatch):
    monkeypatch.setenv("RPVG_TPU_FUSE_EM", "1")
    rng = np.random.default_rng(7)
    tasks = [random_task(rng, 2000, 60) for _ in range(12)] + em_task_set(50, seed=8)
    for group in batching.plan_em_groups(tasks, range(len(tasks))):
        cost = sum(len(c) * (R * C + R + C) * 8 for c, R, C in group)
        assert len(group) == 1 or cost <= batching._FUSED_LAUNCH_BYTES


def test_build_block_pads_with_zeros():
    tasks = em_task_set(6, seed=9)
    chunk = [1, 3, 4]
    probs, counts, masks = batching.build_block(tasks, chunk, 32, 64, CPU)
    assert probs.shape == (3, 32, 64) and probs.dtype == torch.float64
    for b, idx in enumerate(chunk):
        p, c = tasks[idx]
        R, C = p.shape
        np.testing.assert_array_equal(probs[b, :R, :C].numpy(), p)
        assert not probs[b, R:].any() and not probs[b, :, C:].any()
        np.testing.assert_array_equal(counts[b, :R].numpy(), c)
        assert not counts[b, R:].any()
        assert masks[b].sum() == C and masks[b, :C].all()


def test_cpu_blocks_take_plain_version_without_launch():
    blocks = _to_torch(padded_block_set(4))
    with counted() as counts:
        fracs, iters = em_fused_cuda.em_fixed_point_padded(blocks, 10000, 1e-3)
    plain_fracs, plain_iters = em_fused_cuda.em_fixed_point_padded_plain(blocks, 10000, 1e-3)
    for a, b in zip(fracs + iters, plain_fracs + plain_iters):
        assert torch.equal(a, b)
    assert (counts["em.padded.launches"], counts["em.padded.blocks"]) == (0, 0)


def test_other_devices_raise():
    blocks = [tuple(t.to("meta") for t in block) for block in _to_torch(padded_block_set(5))]
    with pytest.raises(ValueError, match="unsupported device"):
        em_fused_cuda.em_fixed_point_padded(blocks, 10000, 1e-3)


def test_shared_memory_bound():
    """A tall task keeps P, counts and q in global memory and fits; a task
    too wide for one thread block's shared memory raises before any
    launch."""
    (launch,) = em_cuda.plan_launches([8192], [64], "em_fused")
    assert (launch.threads, launch.staged) == (1024, False)
    assert launch.smem_bytes == 8 * (32 + 2 * 64)
    with pytest.raises(ValueError, match="shared memory"):
        em_cuda.plan_launches([8], [16384], "em_fused")
