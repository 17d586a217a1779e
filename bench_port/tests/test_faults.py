"""A run whose timed path is broken underneath comes out not correct:
for each fault this cell can have, the harness runs on the CPU with the
port patched.  (The cells run on one chip: no exchange between chips to
leave out.)"""

import numpy as np
import pytest

WORKLOAD = "tiny_diploid.sample3k"


def _em_returns_its_start(monkeypatch):
    """A step that returns its state unchanged: every EM task keeps its
    starting abundances."""
    from rpvg_tpu_torch.infer import batched_models, batching

    def unchanged(cluster_inputs, max_em_its, max_rel_em_conv, device):
        out = []
        for probs, counts in cluster_inputs:
            fracs = np.full(probs.shape[1], 1.0 / probs.shape[1])
            out.append(batching.em_postprocess(fracs, float(counts.sum())))
        return out, None

    monkeypatch.setattr(batched_models, "run_batched_em_packed", unchanged)


def _half_the_tasks_left_out(monkeypatch):
    """Half of the batch left out: the EM runs the even tasks, and each
    odd task gets the mean abundance of its columns instead."""
    from rpvg_tpu_torch.infer import batched_models, batching

    original = batched_models.run_batched_em_packed

    def half(cluster_inputs, max_em_its, max_rel_em_conv, device):
        done, _ = original(cluster_inputs[0::2], max_em_its, max_rel_em_conv, device)
        out = []
        for i, (probs, counts) in enumerate(cluster_inputs):
            if i % 2 == 0:
                out.append(done[i // 2])
            else:
                total = float(counts.sum())
                out.append((np.full(probs.shape[1] - 1, total / probs.shape[1]),
                            total / probs.shape[1]))
        return out, None

    monkeypatch.setattr(batched_models, "run_batched_em_packed", half)


def _one_answer_altered(monkeypatch):
    """An answer altered where it is produced: one read count of the
    largest cluster is 1 % off when the files are written."""
    from rpvg_tpu_torch import pipeline

    original = pipeline.write_outputs

    def altered(config, results, *args, **kwargs):
        for result in results:
            if result.estimates.abundances:
                result.estimates.abundances[0] *= 1.01
                break
        return original(config, results, *args, **kwargs)

    monkeypatch.setattr(pipeline, "write_outputs", altered)


@pytest.mark.parametrize("fault", [_em_returns_its_start, _half_the_tasks_left_out,
                                   _one_answer_altered])
def test_a_broken_timed_path_is_not_correct(small_cell, monkeypatch, fault):
    fault(monkeypatch)
    result = small_cell(WORKLOAD, seed=2**31 + 23, seconds=0.2)
    assert not result["correct"], result["checks"]
    assert result["failed"] == result["attempted"]
