"""The CUDA EM kernel against its plain PyTorch version, and the slice's
device half on the card.  Every test here needs a CUDA device: they are
marked ``gpu`` and skip on a host without one.  The module imports no
jax (the card's host has none), so on the card it runs without the
suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from rpvg_tpu_torch.infer import posteriors
from rpvg_tpu_torch.infer.batching import fold_fractions, pack_ragged, run_batched_em
from rpvg_tpu_torch.ops import em_cuda
from rpvg_tpu_torch.testing import em_task_set, random_task

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the EM kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _folded(fracs, tasks, task_list):
    return np.concatenate([np.append(*r) for r in fold_fractions(fracs, tasks, task_list)])


@pytest.mark.parametrize("max_its", [10000, 50])
def test_kernel_matches_plain(cuda, max_its):
    task_list = em_task_set(512, seed=31)
    tasks = pack_ragged(task_list, cuda)
    launches = em_cuda.LAUNCHES
    k_fracs, k_iters = em_cuda.em_fixed_point(tasks, max_its, 1e-3)
    assert em_cuda.LAUNCHES == launches + 1
    p_fracs, p_iters = em_cuda.em_fixed_point_plain(tasks, max_its, 1e-3)
    torch.cuda.synchronize()
    assert em_cuda.LAUNCHES == launches + 1
    kernel = _folded(k_fracs, tasks, task_list)
    plain = _folded(p_fracs, tasks, task_list)
    np.testing.assert_allclose(kernel, plain, rtol=1e-6, atol=1e-9)
    assert int(k_iters.max()) <= max_its


def test_kernel_is_deterministic(cuda):
    tasks = pack_ragged(em_task_set(256, seed=32), cuda)
    first, _ = em_cuda.em_fixed_point(tasks, 10000, 1e-3)
    second, _ = em_cuda.em_fixed_point(tasks, 10000, 1e-3)
    assert torch.equal(first, second)


def test_run_batched_em_on_cuda_matches_cpu(cuda):
    task_list = em_task_set(128, seed=33)
    tasks_before = em_cuda.TASKS
    port = run_batched_em(task_list, 10000, 1e-3, cuda)
    assert em_cuda.TASKS == tasks_before + len(task_list)
    on_cpu = run_batched_em(task_list, 10000, 1e-3, torch.device("cpu"))
    for (p_counts, p_noise), (n_counts, n_noise) in zip(port, on_cpu):
        np.testing.assert_allclose(p_counts, n_counts, rtol=1e-6, atol=1e-9)
        assert p_noise == pytest.approx(n_noise, rel=1e-6, abs=1e-9)


def test_pair_scores_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(34)
    clusters = []
    for R, P in [(3, 2), (9, 5), (40, 12)]:
        probs = rng.random((R, P)) * (rng.random((R, P)) < 0.6)
        clusters.append(
            (probs, rng.uniform(1e-4, 0.2, R), rng.integers(1, 9, R).astype(float),
             rng.integers(1, 4, P).tolist())
        )
    before = posteriors.SCORED_CLUSTERS["cuda"]
    on_cuda = posteriors.diploid_posteriors_batched(clusters, 1e-3, cuda)
    assert posteriors.SCORED_CLUSTERS["cuda"] == before + len(clusters)
    on_cpu = posteriors.diploid_posteriors_batched(clusters, 1e-3, torch.device("cpu"))
    for (g_cuda, p_cuda), (g_cpu, p_cpu) in zip(on_cuda, on_cpu):
        assert g_cuda == g_cpu
        np.testing.assert_allclose(p_cuda, p_cpu, rtol=1e-9)


def test_kernel_wide_and_tall_tasks_match_plain(cuda):
    """Tasks past the kernel's fast paths: more columns than threads in a
    block (unsliced column sums) and more rows than fit q in shared
    memory (q in global scratch)."""
    rng = np.random.default_rng(35)
    task_list = [random_task(rng, R, C) for R, C in [(2500, 5), (40, 200), (3000, 150), (3, 9)]]
    tasks = pack_ragged(task_list, cuda)
    k_fracs, k_iters = em_cuda.em_fixed_point(tasks, 10000, 1e-3)
    p_fracs, p_iters = em_cuda.em_fixed_point_plain(tasks, 10000, 1e-3)
    np.testing.assert_allclose(
        _folded(k_fracs, tasks, task_list), _folded(p_fracs, tasks, task_list),
        rtol=1e-6, atol=1e-9,
    )
    assert torch.equal(k_iters.cpu(), p_iters.cpu())
