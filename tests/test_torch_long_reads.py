"""--long-reads on the CPU against the JAX package: the port's CLI and an
in-process ``rpvg_tpu`` run on the same long single reads write the same
bytes (effective lengths dropped, ``pipeline.py``'s long-read branch)."""

import pytest

import rpvg_tpu.pipeline as ref_pipeline
from rpvg_tpu import sim
from rpvg_tpu_torch import cli

from test_torch_slice import _write_inputs, one_torch_thread, output_suffixes  # noqa: F401


@pytest.mark.parametrize("model", ["transcripts", "haplotype-transcripts"])
def test_cpu_long_reads_match_reference(model, tmp_path):
    panel = sim.build_gene_panel(
        num_genes=4, isoforms_per_gene=3, num_haplotypes=4,
        exons_per_gene=5, exon_length=100, variant_sites=3, seed=91,
    )
    records, _ = sim.simulate_single_reads(panel, 600, read_length=250, seed=93)
    aln = str(tmp_path / "lr.json")
    sim.write_alignment_json(records, aln)
    info = str(tmp_path / "info.tsv")
    panel.write_info_tsv(info)
    graph, paths = _write_inputs(panel, str(tmp_path))
    ref_prefix = str(tmp_path / "ref")
    ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=graph, paths=paths, alignments=aln, output_prefix=ref_prefix,
        inference_model=model, path_info=info, rng_seed=99, score_not_qual=True,
        long_reads=True,
    ))
    prefix = str(tmp_path / "port")
    argv = ["-g", graph, "-p", paths, "-a", aln, "-o", prefix, "-i", model, "-f", info,
            "-r", "99", "--score-not-qual", "--backend", "cpu", "--long-reads"]
    assert cli.main(argv) == 0
    for suffix in output_suffixes(model):
        with open(prefix + suffix, "rb") as port, open(ref_prefix + suffix, "rb") as ref:
            port_bytes = port.read()
            assert port_bytes == ref.read()
        assert port_bytes.count(b"\n") > 10
    # Effective lengths are dropped: every path's EffectiveLength is its Length.
    with open(prefix + ".txt") as handle:
        header = handle.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in handle if line.strip()]
    length, effective = header.index("Length"), header.index("EffectiveLength")
    assert rows and all(float(r[length]) == float(r[effective]) for r in rows)
