"""The k-group route of phase B under the port's spans and counters
(``posteriors.full_posteriors_batched``): the four ``rpvg.groups.*``
spans once per call, each ``groups.*`` counter equal to its closed form
over the call's inputs, the host engine's clusters counted, a
diploid pass recording none of these names, and a second pass counting
what the first did (the counters are per run); on the CPU, on synthetic
clusters and through ``run_pipeline`` on a small ``.rpa``."""

import math
from dataclasses import replace

import pytest
import torch

from rpvg_tpu_torch import spans
from rpvg_tpu_torch.infer import batched_models, posteriors
from rpvg_tpu_torch.parallel import autoshard
from rpvg_tpu_torch.pipeline import run_pipeline
from rpvg_tpu_torch.testing import enumeration_cluster_set, shard_counts

from test_torch_slice import one_torch_thread  # noqa: F401
from test_torch_spans import small_rpa, staged  # noqa: F401

CPU = torch.device("cpu")
GROUP_SPANS = ("rpvg.groups.host_enum", "rpvg.groups.pack", "rpvg.groups.wait",
               "rpvg.groups.finish")
COUNTERS = ("groups.clusters", "groups.groups", "groups.rows", "groups.cells",
            "groups.row_groups", "groups.slots", "groups.host_enum_clusters")


def closed_forms(calls, limit=None):
    """Each counter's value over the calls' (inputs, k), worked out from
    the shapes: a cluster of R rows over P paths has comb(P + k - 1, k)
    groups, and goes to the host engine when its padded count passes
    ``limit``."""
    limit = posteriors._FULL_ENUM_GROUP_LIMIT if limit is None else limit
    want = dict.fromkeys(COUNTERS, 0)
    for inputs, k in calls:
        for probs, *_ in inputs:
            R, P = probs.shape
            if math.comb(posteriors._ceil_pow2(P) + k - 1, k) > limit:
                want["groups.host_enum_clusters"] += 1
                continue
            G = math.comb(P + k - 1, k)
            want["groups.clusters"] += 1
            want["groups.groups"] += G
            want["groups.rows"] += R
            want["groups.cells"] += R * P
            want["groups.row_groups"] += R * G
            want["groups.slots"] += k * G
    return want


def _in_a_run(fn):
    with spans.RunSpan("test") as root:
        out = fn()
    return out, root.run.summary()


@pytest.mark.parametrize("k", [3, 4])
def test_one_call_enters_each_span_once_and_counts_its_shapes(k):
    clusters = enumeration_cluster_set(12, seed=140 + k, group_size=k, max_paths=12, max_rows=48)
    (_, found) = _in_a_run(lambda: posteriors.full_posteriors_batched(clusters, k, CPU))
    for name in GROUP_SPANS:
        assert found["spans"][name]["count"] == 1, name
    want = closed_forms([(clusters, k)])
    assert want["groups.clusters"] == len(clusters) and want["groups.host_enum_clusters"] == 0
    assert {name: found["counters"][name] for name in COUNTERS} == want


def test_host_engine_clusters_are_counted_and_kept_off_the_scorer(monkeypatch):
    clusters = enumeration_cluster_set(6, seed=150, group_size=3, max_rows=20)
    # Up to 8 paths (comb(8 + 2, 3) = 120 groups) stay on the scorer.
    monkeypatch.setattr(posteriors, "_FULL_ENUM_GROUP_LIMIT", 120)
    (_, found) = _in_a_run(lambda: posteriors.full_posteriors_batched(clusters, 3, CPU))
    want = closed_forms([(clusters, 3)], limit=120)
    assert 0 < want["groups.host_enum_clusters"] < len(clusters)
    assert {name: found["counters"][name] for name in COUNTERS} == want
    assert all(found["spans"][name]["count"] == 1 for name in GROUP_SPANS)


def test_a_call_with_every_cluster_on_the_host_engine(monkeypatch):
    clusters = enumeration_cluster_set(3, seed=160, group_size=3, max_rows=16)
    monkeypatch.setattr(posteriors, "_FULL_ENUM_GROUP_LIMIT", 0)
    (results, found) = _in_a_run(lambda: posteriors.full_posteriors_batched(clusters, 3, CPU))
    assert all(result is not None for result in results)
    assert found["spans"]["rpvg.groups.host_enum"]["count"] == 1
    assert not set(GROUP_SPANS[1:]) & set(found["spans"])
    assert found["counters"]["groups.host_enum_clusters"] == len(clusters)
    assert all(found["counters"][name] == 0 for name in COUNTERS[:-1])


def test_results_are_the_same_inside_and_outside_a_run():
    clusters = enumeration_cluster_set(8, seed=170, group_size=4, max_paths=12, max_rows=32)
    bare = posteriors.full_posteriors_batched(clusters, 4, CPU)
    (traced, _) = _in_a_run(lambda: posteriors.full_posteriors_batched(clusters, 4, CPU))
    for (groups, post), (groups_t, post_t) in zip(bare, traced):
        assert groups == groups_t
        assert post.tobytes() == post_t.tobytes()


# ------------------------------------------------- run_pipeline, end to end


@pytest.fixture
def phase_b_calls(monkeypatch):
    """The (inputs, k) of every call phase B makes into the full
    enumeration while the fixture is active."""
    calls = []
    original = batched_models.full_posteriors_batched

    def recorded(inputs, group_size, device):
        calls.append((list(inputs), group_size))
        return original(inputs, group_size, device)

    monkeypatch.setattr(batched_models, "full_posteriors_batched", recorded)
    return calls


def _run(config, prefix, **changes):
    return run_pipeline(replace(config, output_prefix=str(prefix), **changes), CPU)


def test_tetraploid_pass_spans_and_counts_phase_b(small_rpa, staged, phase_b_calls,  # noqa: F811
                                                  tmp_path):
    stats = _run(small_rpa, tmp_path / "y4", ploidy=4)
    assert phase_b_calls and all(k == 4 for _, k in phase_b_calls)
    found = stats["spans"]
    for name in GROUP_SPANS:
        assert found[name]["count"] == len(phase_b_calls) == found["rpvg.phase.B"]["count"]
        assert found[name]["total_s"] <= found["rpvg.phase.B"]["total_s"]
    want = closed_forms(phase_b_calls)
    assert want["groups.host_enum_clusters"] == 0 and want["groups.clusters"] > 0
    assert {name: stats["counters"][name] for name in COUNTERS} == want
    assert stats["counters"]["groups.cells"] < stats["counters"]["groups.row_groups"]


def test_tetraploid_pass_counts_the_host_engine(small_rpa, staged, phase_b_calls,  # noqa: F811
                                                tmp_path, monkeypatch):
    # Clusters of more than two paths (comb(4 + 3, 4) = 35 groups padded)
    # go to the host engine.
    monkeypatch.setattr(posteriors, "_FULL_ENUM_GROUP_LIMIT", 34)
    stats = _run(small_rpa, tmp_path / "y4_host", ploidy=4)
    want = closed_forms(phase_b_calls, limit=34)
    assert want["groups.host_enum_clusters"] > 0
    assert stats["counters"]["groups.host_enum_clusters"] == want["groups.host_enum_clusters"]
    assert stats["counters"]["posteriors.scored.cpu"] == stats["scored_clusters"]
    assert {name: stats["counters"][name] for name in COUNTERS} == want


@pytest.mark.parametrize("limit", [None, 34], ids=["scorer", "host-engine"])
def test_second_pass_counts_what_the_first_did(limit, small_rpa, staged,  # noqa: F811
                                               tmp_path, monkeypatch):
    """Two -y 4 passes in a row on two data shards (the scorer's clusters
    and the plain EM's tasks split over them), or with every cluster on
    the host engine: the second reports the first's host-engine
    clusters, scored clusters by device and what each shard took, not
    their sums."""
    if limit is not None:
        monkeypatch.setattr(posteriors, "_FULL_ENUM_GROUP_LIMIT", limit)
    monkeypatch.setenv("RPVG_TPU_NATIVE_EM", "0")
    with autoshard.virtual_devices(CPU, 2):
        first, second = (_run(small_rpa, tmp_path / f"y4_{n}", ploidy=4)["counters"]
                         for n in (1, 2))
    names = ("groups.host_enum_clusters", "posteriors.scored.cpu", "posteriors.scored.cuda")
    assert [second.get(name) for name in names] == [first.get(name) for name in names]
    assert first["posteriors.scored.cpu"] > 0
    assert (first["groups.host_enum_clusters"] > 0) == (limit is not None)
    assert shard_counts(second) == shard_counts(first)
    assert len(shard_counts(first, "em_tasks")) == 2
    assert sum(shard_counts(first, "group_clusters")) == first["groups.clusters"]


def test_diploid_pass_records_no_group_names(small_rpa, staged, phase_b_calls,  # noqa: F811
                                             tmp_path):
    stats = _run(small_rpa, tmp_path / "y2", ploidy=2)
    assert not phase_b_calls
    assert not [name for name in stats["spans"] if name.startswith("rpvg.groups.")]
    assert not [name for name in stats["counters"] if name.startswith("groups.")]
