"""The per-transcript route (``--ind-hap-inference``) and phase D under the
port's counters and spans, on the CPU: each ``indhap.*`` counter equal to
its closed form over the jobs and subsets the pass made, the EM's
``rpvg.em.*`` spans once per ``run_batched_em_packed`` call on both
nested routes (the native EM's one span, and on the plain ragged route
the packing, launch and fold), the estimate files the same bytes inside
and outside an open run, and a collapsed pass recording no ``indhap.*``
counter."""

import math
from dataclasses import replace

import pytest
import torch

from rpvg_tpu_torch import spans
from rpvg_tpu_torch.infer import batched_models, batching
from rpvg_tpu_torch.parallel import autoshard
from rpvg_tpu_torch.pipeline import run_pipeline
from rpvg_tpu_torch.testing import em_task_set

from test_torch_slice import one_torch_thread  # noqa: F401
from test_torch_spans import small_rpa, staged  # noqa: F401

CPU = torch.device("cpu")
COUNTERS = ("indhap.clusters", "indhap.jobs", "indhap.single_candidate_jobs",
            "indhap.draws", "indhap.subsets")
EM_SPANS = ("rpvg.em.pack", "rpvg.em.launch", "rpvg.em.fold")


@pytest.fixture
def sampled(monkeypatch):
    """What phase I3 took and gave in each call while the fixture is
    active: (cluster groups, jobs, job results, min_hap_prob, all tasks)."""
    calls = []
    original = batched_models._sample_subsets

    def recorded(estimator, cluster_data, cluster_groups, jobs, results, rng_seed, rank_of):
        out = original(estimator, cluster_data, cluster_groups, jobs, results, rng_seed, rank_of)
        calls.append((dict(cluster_groups), list(jobs), list(results),
                      estimator.min_hap_prob, list(out[1])))
        return out

    monkeypatch.setattr(batched_models, "_sample_subsets", recorded)
    return calls


@pytest.fixture
def em_calls(monkeypatch):
    """The number of ``run_batched_em_packed`` calls the routes make."""
    calls = []
    original = batched_models.run_batched_em_packed

    def counted_call(*args, **kwargs):
        calls.append(len(args[0]))
        return original(*args, **kwargs)

    monkeypatch.setattr(batched_models, "run_batched_em_packed", counted_call)
    return calls


def closed_forms(calls):
    want = dict.fromkeys(COUNTERS, 0)
    for cluster_groups, jobs, results, min_hap_prob, all_tasks in calls:
        want["indhap.clusters"] += len(cluster_groups)
        want["indhap.jobs"] += len(jobs)
        want["indhap.single_candidate_jobs"] += sum(len(sets) == 1 for sets, _ in results)
        want["indhap.draws"] += len(jobs) * math.floor(1.0 / min_hap_prob)
        want["indhap.subsets"] += len(all_tasks)
    return want


def _run(config, prefix, **changes):
    return run_pipeline(replace(config, output_prefix=str(prefix), **changes), CPU)


@pytest.mark.parametrize("changes", [{}, {"ploidy": 3}, {"min_hap_prob": 0.01}],
                         ids=["y2", "y3", "min-hap-prob"])
def test_counters_equal_their_closed_forms(small_rpa, staged, sampled, tmp_path,  # noqa: F811
                                           changes):
    stats = _run(small_rpa, tmp_path / "ih", ind_hap_inference=True, **changes)
    assert len(sampled) == 1
    want = closed_forms(sampled)
    assert {name: stats["counters"][name] for name in COUNTERS} == want
    assert want["indhap.subsets"] == stats["em_tasks"] > 0
    assert want["indhap.jobs"] == stats["scored_clusters"] > want["indhap.clusters"] > 0
    assert want["indhap.single_candidate_jobs"] < want["indhap.jobs"]
    # At -y 2 some transcripts keep one pair after the cutoff.
    assert want["indhap.single_candidate_jobs"] > 0 or "ploidy" in changes
    min_hap_prob = changes.get("min_hap_prob", small_rpa.min_hap_prob)
    assert want["indhap.draws"] == want["indhap.jobs"] * round(1 / min_hap_prob)


def test_second_pass_counts_what_the_first_did(small_rpa, staged, tmp_path):  # noqa: F811
    first, second = (_run(small_rpa, tmp_path / f"ih{n}", ind_hap_inference=True)["counters"]
                     for n in (1, 2))
    assert {name: second[name] for name in COUNTERS} == {name: first[name] for name in COUNTERS}


@pytest.mark.parametrize("ind_hap", [False, True], ids=["collapsed", "independent"])
def test_native_em_is_one_launch_span_a_call(small_rpa, staged, em_calls, tmp_path,  # noqa: F811
                                             ind_hap):
    stats = _run(small_rpa, tmp_path / "em", ind_hap_inference=ind_hap)
    assert em_calls == [stats["em_tasks"]]
    found = stats["spans"]
    assert found["rpvg.em.launch"]["count"] == len(em_calls)
    assert found["rpvg.em.launch"]["total_s"] <= found["rpvg.phase.D"]["total_s"]
    # The native EM packs and folds inside its one call.
    assert not {"rpvg.em.pack", "rpvg.em.fold"} & set(found)


@pytest.mark.parametrize("ind_hap", [False, True], ids=["collapsed", "independent"])
def test_ragged_route_packs_launches_and_folds_once_a_call(small_rpa, staged, em_calls,  # noqa: F811
                                                          tmp_path, monkeypatch, ind_hap):
    monkeypatch.setenv("RPVG_TPU_NATIVE_EM", "0")
    stats = _run(small_rpa, tmp_path / "em", ind_hap_inference=ind_hap)
    found = stats["spans"]
    assert len(em_calls) == 1
    for name in EM_SPANS:
        assert found[name]["count"] == 1, name
    launch = found["rpvg.em.launch"]
    # Packing runs inside the launch span; the fold after it.
    assert launch["self_s"] == pytest.approx(launch["total_s"] - found["rpvg.em.pack"]["total_s"])
    spanned = launch["total_s"] + found["rpvg.em.fold"]["total_s"]
    assert spanned <= found["rpvg.phase.D"]["total_s"]


def test_each_shard_packs_inside_the_one_launch(monkeypatch):
    monkeypatch.setenv("RPVG_TPU_NATIVE_EM", "0")
    tasks = em_task_set(48, seed=23)
    with autoshard.virtual_devices(CPU, 3):
        with spans.RunSpan("test") as root:
            results, packed = batching.run_batched_em_packed(tasks, 10000, 1e-3, CPU)
    found = root.run.summary()["spans"]
    # One pack a shard that took tasks.
    assert len(packed.parts) > 1 and len(results) == len(tasks)
    assert [found[name]["count"] for name in EM_SPANS] == [len(packed.parts), 1, 1]
    bare, _ = batching.run_batched_em_packed(tasks, 10000, 1e-3, CPU)
    for (counts, noise), (counts_b, noise_b) in zip(results, bare):
        assert counts.tobytes() == counts_b.tobytes() and noise == noise_b


@pytest.mark.parametrize("native", [True, False], ids=["native-em", "plain-em"])
def test_files_are_the_same_inside_and_outside_an_open_run(small_rpa, staged, tmp_path,  # noqa: F811
                                                           monkeypatch, native):
    if not native:
        monkeypatch.setenv("RPVG_TPU_NATIVE_EM", "0")
    _run(small_rpa, tmp_path / "bare", ind_hap_inference=True)
    with spans.RunSpan("outer") as outer:
        _run(small_rpa, tmp_path / "inside", ind_hap_inference=True)
    counters = outer.run.summary()["counters"]
    assert counters["indhap.subsets"] > 0
    for suffix in (".txt", "_joint.txt"):
        bare = (tmp_path / f"bare{suffix}").read_bytes()
        assert bare == (tmp_path / f"inside{suffix}").read_bytes(), suffix
        assert bare.count(b"\n") > 10


def test_collapsed_pass_records_no_indhap_counter(small_rpa, staged, sampled,  # noqa: F811
                                                  tmp_path):
    stats = _run(small_rpa, tmp_path / "collapsed")
    assert not sampled and stats["em_tasks"] > 0
    assert not [name for name in stats["counters"] if name.startswith("indhap.")]
