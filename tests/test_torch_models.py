"""The port's ``transcripts``, ``strains`` and ploidy-2 ``haplotypes``
models end to end on the CPU: golden files, in-process reference runs
on a gene panel (default and fused EM routes) and a run with jax
blocked."""

import os
import subprocess
import sys

import pytest

import rpvg_tpu.pipeline as ref_pipeline
from rpvg_tpu import sim
from rpvg_tpu_torch import cli
from rpvg_tpu_torch.compare import compare_estimate_files

from test_golden import GOLDEN_DIR, make_dataset
from test_torch_slice import _NO_JAX_RUN, REPO, _write_inputs, one_torch_thread  # noqa: F401

RTOL = 1e-6
ATOL = 1e-6


def _argv(graph, paths, aln, prefix, model, qual=False, extra=()):
    argv = [
        "-g", graph, "-p", paths, "-a", aln, "-o", prefix, "-i", model,
        "-r", "99", "--backend", "cpu", *extra,
    ]
    if not qual:
        argv.append("--score-not-qual")
    return argv


@pytest.mark.parametrize("model", ["transcripts", "strains", "haplotypes"])
@pytest.mark.parametrize("qual", [False, True])
def test_cpu_models_match_golden(model, qual, tmp_path, record_property):
    name = model + ("-qual" if qual else "")
    panel, aln, _ = make_dataset(str(tmp_path), qual=qual)
    graph, paths = _write_inputs(panel, str(tmp_path))
    prefix = str(tmp_path / "out")
    assert cli.main(_argv(graph, paths, aln, prefix, model, qual=qual)) == 0
    report = compare_estimate_files(
        prefix + ".txt", os.path.join(GOLDEN_DIR, name + ".txt"), RTOL, ATOL
    )
    record_property("byte_identical", report["byte_identical"])
    print(f"{name}.txt: {report}")


@pytest.fixture(scope="module")
def gene_panel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gene_panel")
    panel = sim.build_gene_panel(
        num_genes=8, isoforms_per_gene=4, num_haplotypes=4,
        exons_per_gene=6, exon_length=100, variant_sites=3, seed=41,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 2000, read_length=80, frag_mean=200, frag_sd=20, seed=43,
        abundances=sim.gene_abundances(panel, seed=47), multipath_dag=True,
    )
    aln = str(tmp / "aln.json")
    sim.write_alignment_json(records, aln)
    info = str(tmp / "info.tsv")
    panel.write_info_tsv(info)
    graph, paths = _write_inputs(panel, str(tmp))
    return graph, paths, aln, info


@pytest.mark.parametrize(
    "model,with_info,fuse",
    [
        ("transcripts", True, "0"),
        ("transcripts", True, "1"),
        ("transcripts", False, "1"),
        ("strains", False, "0"),
        ("haplotypes", False, "0"),
    ],
)
def test_cpu_models_match_reference_pipeline(model, with_info, fuse, gene_panel, tmp_path, monkeypatch):
    """``transcripts -f`` collapses haplotypes to transcript names;
    ``RPVG_TPU_FUSE_EM=1`` takes the bucketed multi-bucket route."""
    graph, paths, aln, info = gene_panel
    ref_prefix = str(tmp_path / "ref")
    ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=graph, paths=paths, alignments=aln, output_prefix=ref_prefix,
        inference_model=model, path_info=info if with_info else None, rng_seed=99,
        score_not_qual=True, threads=2,
    ))
    monkeypatch.setenv("RPVG_TPU_FUSE_EM", fuse)
    prefix = str(tmp_path / "port")
    extra = ("-t", "2") + (("-f", info) if with_info else ())
    assert cli.main(_argv(graph, paths, aln, prefix, model, extra=extra)) == 0
    report = compare_estimate_files(prefix + ".txt", ref_prefix + ".txt", RTOL, ATOL)
    assert report["rows"] > 10


def test_transcripts_run_with_jax_blocked(tmp_path):
    """Stands in for the machine with the card, which has no jax."""
    panel, aln, _ = make_dataset(str(tmp_path))
    graph, paths = _write_inputs(panel, str(tmp_path))
    prefix = str(tmp_path / "out")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, *_argv(graph, paths, aln, prefix, "transcripts")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK 0" in proc.stdout
    report = compare_estimate_files(
        prefix + ".txt", os.path.join(GOLDEN_DIR, "transcripts.txt"), RTOL, ATOL
    )
    assert report["rows"] > 0
