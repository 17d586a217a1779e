"""A small grid of torch devices and the sharded inference steps
(counterpart of ``rpvg_tpu/parallel/mesh.py``).

Layout, as in the JAX package:

* **data axis**: clusters are independent, so padded cluster batches
  split over the data shards (the reference's dynamic parallel-for over
  clusters, ``reference/src/main.cpp:829``);
* **model axis**: inside one giant cluster, the rows of the (P, P)
  diplotype pair matrix split over the model shards, every shard holding
  the cluster's probabilities, noise, counts and log frequencies (the
  reference's serial branch-and-bound loop,
  ``reference/src/path_estimator.cpp:420-451``);
* the TPM normaliser and the fragment-length histogram are the only
  reductions across shards (``reference/src/main.cpp:1029-1057``,
  ``:203-235``): each shard's partial is summed on the first device in
  shard order, so the result does not depend on timing.

A shard's EM goes through ``em_fused_cuda.em_fixed_point_padded``: the
multi-bucket kernel on a CUDA device, its plain version on the CPU.
The functions take numpy arrays or tensors and return tensors on the
mesh's first device.  With :func:`~rpvg_tpu_torch.parallel.autoshard.
virtual_devices` (or a list naming one device n times) the same code
runs n shards on one CPU or one GPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from rpvg_tpu_torch.ops import em_fused_cuda
from rpvg_tpu_torch.parallel.autoshard import shard_batched


@dataclass(frozen=True)
class Mesh:
    """``devices[d][m]`` is the device of data shard d, model shard m."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        return tuple(row[0] for row in self.devices)

    @property
    def model_devices(self) -> Tuple[torch.device, ...]:
        return self.devices[0]

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]


def make_mesh(
    devices: Sequence[torch.device], data: Optional[int] = None, model: int = 1
) -> Mesh:
    """A (data, model) grid over ``devices``, filled row by row."""
    devices = list(devices)
    if data is None:
        data = len(devices) // model
    if data * model != len(devices) or data < 1:
        raise ValueError(f"make_mesh: {len(devices)} devices do not make a {data} x {model} grid")
    return Mesh(tuple(tuple(devices[d * model : (d + 1) * model]) for d in range(data)))


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64)


def _sum_in_order(partials, device: torch.device) -> torch.Tensor:
    total = partials[0].to(device)
    for partial in partials[1:]:
        total = total + partial.to(device)
    return total


def sharded_em_step(mesh: Mesh, max_em_its: int = 10000, max_rel_em_conv: float = 0.001):
    """Batched EM and the TPM partial reduction, data-parallel over the
    cluster-batch axis.  Returns fn(probs (B, R, C), counts (B, R),
    col_masks (B, C), inv_eff_lengths (B, C - 1)) -> (abundance fractions
    (B, C), TPM normaliser), float64 on the mesh's first device."""

    def step(probs, counts, col_masks, inv_eff_lengths):
        parts = shard_batched(
            mesh.data_devices, *(_f64(a) for a in (probs, counts, col_masks, inv_eff_lengths))
        )
        outs = []
        for p, c, m, inv in parts:
            (fracs,), _ = em_fused_cuda.em_fixed_point_padded([(p, c, m)], max_em_its, max_rel_em_conv)
            # Per-path read counts over effective length: this shard's
            # part of the TPM denominator.
            path_counts = fracs[:, :-1] * c.sum(dim=1)[:, None]
            outs.append((fracs, (path_counts * inv).sum()))
        abundances = torch.cat([fracs.to(mesh.first) for fracs, _ in outs])
        return abundances, _sum_in_order([partial for _, partial in outs], mesh.first)

    return step


def sharded_diploid_scores(mesh: Mesh):
    """All-pairs diplotype scores of one cluster with the pair matrix's
    rows split over the model shards and the reads on every shard.
    Returns fn(probs (R, P), noise (R,), counts (R,), log_freqs (P,)) ->
    (P, P) float64 on the mesh's first device; P must divide the model
    shard count."""
    from rpvg_tpu_torch.infer.posteriors import _diploid_pair_scores_rows

    def score(probs, noise, counts, log_freqs):
        devices = mesh.model_devices
        P = int(probs.shape[1])
        if P % len(devices):
            raise ValueError(f"sharded_diploid_scores: {P} paths do not divide {len(devices)} shards")
        stripe = P // len(devices)
        stripes = []
        for s, device in enumerate(devices):
            on = [_f64(a).to(device) for a in (probs, noise, counts, log_freqs)]
            rows = slice(s * stripe, (s + 1) * stripe)
            stripes.append(_diploid_pair_scores_rows(*on, on[0][:, rows] * 0.5, on[3][rows]))
        return torch.cat([s.to(mesh.first) for s in stripes])

    return score


def psum_histogram(mesh: Mesh):
    """The fragment-length histogram reduction: fn(local_hist (H, bins))
    -> (bins,), each data shard summing its rows, the partials summed on
    the first device in shard order."""

    def reduce_hist(local_hist):
        parts = shard_batched(mesh.data_devices, torch.as_tensor(local_hist))
        return _sum_in_order([hist.sum(dim=0) for (hist,) in parts], mesh.first)

    return reduce_hist


def full_inference_step(mesh: Mesh, max_em_its: int = 1000):
    """One combined sharded step over a padded cluster batch: the batched
    EM (data shards), the pair scores of the first cluster (model shards)
    and the TPM reduction."""
    em = sharded_em_step(mesh, max_em_its=max_em_its)
    diploid = sharded_diploid_scores(mesh)

    def step(probs, counts, col_masks, inv_eff_lengths, noise, log_freqs):
        abundances, tpm = em(probs, counts, col_masks, inv_eff_lengths)
        pair_ll = diploid(_f64(probs)[0][:, :-1], noise, _f64(counts)[0], log_freqs)
        return abundances, tpm, pair_ll

    return step
