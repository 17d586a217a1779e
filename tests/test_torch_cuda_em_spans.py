"""Phase D's spans and the per-transcript route's counters on the card:
``run_batched_em_packed`` on ``cuda`` enters ``rpvg.em.pack``,
``.launch`` and ``.fold`` once a call with the same results as outside a
run, and an ``--ind-hap-inference`` pass on ``cuda`` counts what the same
pass on the CPU counts, with its estimate files the same bytes inside and
outside an open run.  Marked ``gpu``: they skip on a host without a CUDA
device.  The module imports no jax, so on the card:

    python -m pytest tests/test_torch_cuda_em_spans.py -m gpu -q --noconftest
"""

from dataclasses import replace

import pytest
import torch

from rpvg_tpu_torch import alignments, sim, spans
from rpvg_tpu_torch.infer import batching
from rpvg_tpu_torch.io import rpa
from rpvg_tpu_torch.pipeline import PipelineConfig, run_pipeline
from rpvg_tpu_torch.testing import em_task_set

pytestmark = pytest.mark.gpu

EM_SPANS = ("rpvg.em.pack", "rpvg.em.launch", "rpvg.em.fold")
INDHAP = ("indhap.clusters", "indhap.jobs", "indhap.single_candidate_jobs", "indhap.draws",
          "indhap.subsets")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the EM kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def small_rpa(tmp_path_factory):
    """20 genes x 4 isoforms x 4 haplotypes and 1,000 multipath read
    pairs as ``.rpa``, with the run's configuration."""
    work = tmp_path_factory.mktemp("em_spans_panel")
    panel = sim.build_gene_panel(
        num_genes=20, isoforms_per_gene=4, num_haplotypes=4,
        exons_per_gene=6, exon_length=120, variant_sites=3, seed=5,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 1000, read_length=100, frag_mean=250, frag_sd=25, seed=17,
        abundances=sim.gene_abundances(panel, seed=7), multipath_dag=True,
    )
    parsed = [alignments.parse_multipath_alignment(r) for r in records]
    files = {name: str(work / name) for name in ("graph.json", "panel.json", "info.tsv", "aln.rpa")}
    rpa.write_fragments(
        files["aln.rpa"], list(zip(parsed[0::2], parsed[1::2])),
        is_multipath=True, is_paired=True, frag_mean=250.0, frag_sd=25.0,
    )
    panel.write_graph_json(files["graph.json"])
    panel.write_panel_json(files["panel.json"])
    panel.write_info_tsv(files["info.tsv"])
    return PipelineConfig(
        graph=files["graph.json"], paths=files["panel.json"], alignments=files["aln.rpa"],
        inference_model="haplotype-transcripts", path_info=files["info.tsv"], threads=2,
        rng_seed=42, score_not_qual=True, ind_hap_inference=True,
    )


def test_ragged_em_call_spans_once_with_the_same_results(cuda):
    tasks = em_task_set(512, seed=37)
    with spans.RunSpan("test") as root:
        results, packed = batching.run_batched_em_packed(tasks, 10000, 1e-3, cuda)
    found = root.run.summary()
    assert [found["spans"][name]["count"] for name in EM_SPANS] == [1, 1, 1]
    assert found["counters"]["em.ragged.tasks"] == len(tasks) and len(packed.parts) == 1
    bare, _ = batching.run_batched_em_packed(tasks, 10000, 1e-3, cuda)
    for (counts, noise), (counts_b, noise_b) in zip(results, bare):
        assert counts.tobytes() == counts_b.tobytes() and noise == noise_b


def test_indhap_pass_on_cuda_counts_what_the_cpu_pass_counts(cuda, small_rpa, tmp_path):
    on_cpu = run_pipeline(replace(small_rpa, output_prefix=str(tmp_path / "cpu")),
                          torch.device("cpu"))
    bare = run_pipeline(replace(small_rpa, output_prefix=str(tmp_path / "bare")), cuda)
    with spans.RunSpan("outer") as outer:
        run_pipeline(replace(small_rpa, output_prefix=str(tmp_path / "inside")), cuda)
    found = bare["spans"]
    assert [found[name]["count"] for name in EM_SPANS] == [1, 1, 1]
    assert {name: bare["counters"][name] for name in INDHAP} == {
        name: on_cpu["counters"][name] for name in INDHAP}
    assert outer.run.summary()["counters"]["indhap.subsets"] == bare["em_tasks"]
    for suffix in (".txt", "_joint.txt"):
        assert (tmp_path / f"bare{suffix}").read_bytes() == (
            tmp_path / f"inside{suffix}").read_bytes(), suffix
