"""In-process data-parallel sharding of the batched device dispatches
(counterpart of ``rpvg_tpu/parallel/autoshard.py``).

Every batched dispatch of the port (the EM of phase D, the read-count
Gibbs jobs of D2, the pair and group scores and the posterior samplers
of phase B) works on clusters or tasks that are independent of each
other: the reference's dynamic ``omp parallel for`` over clusters
(``reference/src/main.cpp:827-998``).  So they split over the data
devices with no reduction across them, and each shard runs the same
kernel, on its own tasks, that one device would run on all of them.

* :func:`data_devices` names the devices: every visible CUDA device for
  ``cuda``, the one device when only one is visible or
  ``RPVG_TPU_AUTOSHARD=0`` (the JAX package's switch), the CPU for
  ``cpu``.  It never names the CPU when CUDA was asked for.  It is
  resolved at the first dispatch and cached (:func:`cache_clear`), so a
  ``--multiprocess`` run still forks before this process makes any CUDA
  call.
* :func:`shard_batched` splits padded ``(B, ...)`` stacks over the
  devices, all or nothing, as in the JAX package; :func:`shard_tasks`
  cuts a ragged task list into contiguous ranges of about equal work.
* :func:`virtual_devices` asks for n shards of one device, the
  counterpart of XLA's ``--xla_force_host_platform_device_count``: the
  shard logic then runs on one CPU or one GPU, with the real kernels.

Each dispatch adds what each shard took to the run's counters
``shard.<s>.<items>`` (:func:`count_shards`, :mod:`rpvg_tpu_torch.spans`).
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rpvg_tpu_torch import spans

# (device type, shard count) while virtual_devices is active.
_VIRTUAL: Optional[Tuple[str, int]] = None


@functools.lru_cache(maxsize=None)
def data_devices(device: torch.device) -> Tuple[torch.device, ...]:
    """The devices a dispatch on ``device`` splits over (see the module
    notes); ``n`` copies of ``device`` under :func:`virtual_devices`."""
    if _VIRTUAL is not None and _VIRTUAL[0] == device.type:
        return (device,) * _VIRTUAL[1]
    if device.type == "cpu":
        return (device,)
    if device.type != "cuda":
        raise ValueError(f"data_devices: unsupported device {device}")
    if os.environ.get("RPVG_TPU_AUTOSHARD", "1") == "0":
        return (device,)
    count = torch.cuda.device_count()
    if count < 2:
        return (device,)
    return tuple(torch.device("cuda", i) for i in range(count))


def cache_clear() -> None:
    """Forget the resolved devices (after a change of
    ``RPVG_TPU_AUTOSHARD``)."""
    data_devices.cache_clear()


def num_data_shards(device: torch.device) -> int:
    return len(data_devices(device))


@contextlib.contextmanager
def virtual_devices(device: torch.device, n: int) -> Iterator[Tuple[torch.device, ...]]:
    """Within the block, every dispatch on a device of ``device``'s type
    splits into ``n`` shards, all on ``device``."""
    global _VIRTUAL
    if n < 1:
        raise ValueError(f"virtual_devices: n must be at least 1, not {n}")
    saved = _VIRTUAL
    _VIRTUAL = (device.type, int(n))
    cache_clear()
    try:
        yield data_devices(device)
    finally:
        _VIRTUAL = saved
        cache_clear()


def shard_batched(devices: Sequence[torch.device], *arrays) -> List[Tuple[torch.Tensor, ...]]:
    """Per shard, the shard's slice of the leading axis of every array
    (numpy or tensor) on that shard's device.  One part, every array
    whole on ``devices[0]``, when there is one device or a leading axis
    does not divide the shard count: all or nothing across the arguments,
    so every operand of one launch shares a layout."""
    tensors = [a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
               for a in arrays]
    n = len(devices)
    if n == 1 or any(t.shape[0] % n for t in tensors):
        return [tuple(_to_device(t, devices[0]) for t in tensors)]
    return [
        tuple(_to_device(t[s * (t.shape[0] // n) : (s + 1) * (t.shape[0] // n)], device)
              for t in tensors)
        for s, device in enumerate(devices)
    ]


def _to_device(tensor: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``tensor`` on ``device``; a host tensor goes to a CUDA device from
    a page-locked copy without waiting for the stream (a copy from
    pageable memory would wait for the kernels already queued)."""
    if device.type == "cuda" and tensor.device.type == "cpu":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def shard_tasks(shapes, n: int) -> List[Tuple[int, int]]:
    """``n`` contiguous (start, stop) ranges over the tasks of ``shapes``
    ((R, C) per task), cut where the running sum of R * C passes each
    n-th of the total (by task count when every task is empty).  Ranges
    may be empty; concatenated in order they are the task list."""
    shapes = np.asarray(shapes, dtype=np.int64).reshape(-1, 2)
    work = shapes[:, 0] * shapes[:, 1]
    if not work.sum():
        work = np.ones(len(shapes), dtype=np.int64)
    running = np.cumsum(work)
    total = int(running[-1]) if len(running) else 0
    # Shard k ends with the task whose running sum reaches k/n of the total.
    bounds = [0] + [
        min(int(np.searchsorted(running, total * k / n)) + 1, len(shapes)) for k in range(1, n)
    ] + [len(shapes)]
    return [(bounds[s], bounds[s + 1]) for s in range(n)]


def count_shards(items: str, counts: Sequence[int]) -> None:
    """Add the ``items`` (tasks, jobs, clusters) each shard of one dispatch
    took to the run's counter ``shard.<s>.<items>`` (an unsplit dispatch
    counts on shard 0)."""
    for s, n in enumerate(counts):
        spans.count(f"shard.{s}.{items}", int(n))
