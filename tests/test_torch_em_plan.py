"""The EM kernels' launch planner (``em_cuda.plan_launches``), on the CPU:
which team each task runs as, how much shared memory each launch asks
for, and which tasks keep P in global memory.  Both EM kernels launch by
this plan, so a task gets the same team, and the same summation order,
in either kernel."""

import numpy as np
import pytest
import torch

from rpvg_tpu_torch.ops import em_cuda, em_fused_cuda
from rpvg_tpu_torch.testing import edge_case_tasks, em_task_set, padded_block_set

TEAMS = (1024, 512, 256, 128, 32)


def _largest_staged_rows(C, limit=em_cuda.SMEM_LIMIT):
    R = 1
    while 8 * int(em_cuda.staged_doubles([R + 1], [C])[0]) <= limit:
        R += 1
    return R


def _shapes(name):
    if name == "main_path":
        return [p.shape for p, _ in em_task_set(4096, seed=11)]
    if name == "edge":
        return [p.shape for p, _ in edge_case_tasks(np.random.default_rng(5))] + [(1, 1), (0, 0)]
    if name == "tall_and_wide":
        return [(2500, 5), (40, 200), (3000, 150), (3, 9), (8192, 8), (90, 150)]
    if name == "shared_memory_edge":
        R = _largest_staged_rows(61)
        return [(R, 61), (R + 1, 61), (348, 61), (16, 16), (17, 16), (256, 1), (257, 1)]
    if name == "fused_extents":
        blocks = [tuple(torch.from_numpy(a) for a in b) for b in padded_block_set(38)]
        return [tuple(e) for e in em_fused_cuda.cluster_extents(blocks)]
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["main_path", "edge", "tall_and_wide", "shared_memory_edge", "fused_extents"]
)
def test_plan_covers_every_task_once_within_shared_memory(name):
    shapes = np.array(_shapes(name), dtype=np.int64).reshape(-1, 2)
    rows, cols = shapes[:, 0], shapes[:, 1]
    launches = em_cuda.plan_launches(rows, cols)

    planned = np.concatenate([launch.tasks for launch in launches])
    np.testing.assert_array_equal(np.sort(planned), np.arange(len(shapes)))
    assert [launch.threads for launch in launches] == sorted(
        (launch.threads for launch in launches), reverse=True
    )
    keys = [(launch.threads, launch.staged) for launch in launches]
    assert len(set(keys)) == len(keys)
    for launch in launches:
        assert launch.threads in TEAMS
        assert launch.smem_bytes <= em_cuda.SMEM_LIMIT == 232_448
        r, c = rows[launch.tasks], cols[launch.tasks]
        need = em_cuda.staged_doubles(r, c) if launch.staged else em_cuda.global_doubles(c)
        slots = em_cuda.WARPS_PER_BLOCK if launch.threads == 32 else 1
        assert launch.smem_bytes == 8 * slots * int(need.max())
        np.testing.assert_array_equal(em_cuda.team_threads(r, c), launch.threads)
        if launch.threads == 32:
            assert launch.staged and (r * c <= em_cuda.WARP_TEAM_ELEMENTS).all()
        if not launch.staged:
            assert (8 * em_cuda.staged_doubles(r, c) > em_cuda.SMEM_LIMIT).all()

    # The plan depends on (R, C) alone: shuffled tasks get the same teams.
    order = np.random.default_rng(7).permutation(len(shapes))
    team_of = {}
    for launch in launches:
        for i in launch.tasks:
            team_of[(int(rows[i]), int(cols[i]))] = (launch.threads, launch.staged)
    for launch in em_cuda.plan_launches(rows[order], cols[order]):
        for j in launch.tasks:
            i = order[j]
            assert team_of[(int(rows[i]), int(cols[i]))] == (launch.threads, launch.staged)


def test_main_path_teams():
    """The median task runs as a warp, the largest main-path task as a
    1,024-thread block with P staged; one row more than fits shared
    memory at 61 columns takes the global path."""
    R = _largest_staged_rows(61)
    launches = em_cuda.plan_launches([3, 348, R, R + 1], [9, 61, 61, 61])
    team = {int(i): (lc.threads, lc.staged) for lc in launches for i in lc.tasks}
    assert team == {0: (32, True), 1: (1024, True), 2: (1024, True), 3: (1024, False)}


@pytest.mark.parametrize(
    "elements,threads",
    [(0, 32), (1, 32), (256, 32), (257, 128), (1024, 128), (1025, 256), (2048, 256),
     (2049, 512), (12288, 512), (12289, 1024), (21228, 1024)],
)
def test_team_threads_by_elements(elements, threads):
    assert int(em_cuda.team_threads(np.array([elements]), np.array([1]))[0]) == threads
    assert int(em_cuda.team_threads(np.array([1]), np.array([elements]))[0]) == threads


def test_launch_task_ids_follow_launch_order():
    launches = em_cuda.plan_launches([3, 348, 14, 90], [9, 61, 16, 150])
    ids = em_cuda.launch_task_ids(launches, torch.device("cpu"))
    np.testing.assert_array_equal(ids.numpy(), np.concatenate([lc.tasks for lc in launches]))
    assert ids.dtype == torch.int64


def test_task_past_32_bit_indexing_raises():
    with pytest.raises(ValueError, match="2\\^31"):
        em_cuda.plan_launches([2**22], [4], strides=[2**10])
