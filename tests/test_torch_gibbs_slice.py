"""Gibbs configurations of the port's CLI on the CPU against in-process
runs of the JAX package: every output file byte-identical (the CPU route
runs the port's copies of the same native samplers on the same threefry
keys), under the staged routes the port takes and under the JAX
package's defaults (its fused native routes, pinned bitwise to the
staged ones by tests/test_nested_fused.py)."""

import gzip
import os
import subprocess
import sys

import pytest

import rpvg_tpu.pipeline as ref_pipeline
from rpvg_tpu import sim
from rpvg_tpu_torch import cli

from test_torch_slice import _NO_JAX_RUN, REPO, one_torch_thread  # noqa: F401

SEED = 31

# (name, model, -f info, extra CLI flags, PipelineConfig fields)
CONFIGS = [
    ("transcripts-n", "transcripts", False, ("-n", "8"), {"num_gibbs_samples": 8}),
    ("transcripts-f-n", "transcripts", True, ("-n", "8"), {"num_gibbs_samples": 8}),
    ("strains-n", "strains", False, ("-n", "8"), {"num_gibbs_samples": 8}),
    ("haplotype-transcripts-n", "haplotype-transcripts", True, ("-n", "8"),
     {"num_gibbs_samples": 8}),
    ("haplotypes-hap-gibbs", "haplotypes", False, ("--use-hap-gibbs",),
     {"use_hap_gibbs": True}),
    ("haplotype-transcripts-hap-gibbs", "haplotype-transcripts", True, ("--use-hap-gibbs",),
     {"use_hap_gibbs": True}),
    ("haplotype-transcripts-n-hap-gibbs", "haplotype-transcripts", True,
     ("-n", "8", "--use-hap-gibbs"), {"num_gibbs_samples": 8, "use_hap_gibbs": True}),
]

STAGED = {"RPVG_TPU_FUSED_NESTED": "0", "RPVG_TPU_FUSED_STRAINS": "0"}


@pytest.fixture(scope="module")
def panel_files(tmp_path_factory):
    """A small gene panel (8 genes x 4 isoforms x 4 haplotypes) and 2,000
    multipath read pairs."""
    work = tmp_path_factory.mktemp("gibbs_panel")
    panel = sim.build_gene_panel(
        num_genes=8, isoforms_per_gene=4, num_haplotypes=4,
        exons_per_gene=6, exon_length=100, variant_sites=3, seed=41,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 2000, read_length=80, frag_mean=200, frag_sd=20, seed=43,
        abundances=sim.gene_abundances(panel, seed=47), multipath_dag=True,
    )
    files = {name: str(work / name) for name in ("graph.json", "panel.json", "aln.json", "info.tsv")}
    sim.write_alignment_json(records, files["aln.json"])
    panel.write_graph_json(files["graph.json"])
    panel.write_panel_json(files["panel.json"])
    panel.write_info_tsv(files["info.tsv"])
    return files


def _argv(files, model, info, extra, prefix):
    argv = [
        "-g", files["graph.json"], "-p", files["panel.json"], "-a", files["aln.json"],
        "-o", prefix, "-i", model, "-r", str(SEED), "--score-not-qual", "-t", "2",
        "--backend", "cpu", *extra,
    ]
    return argv + (["-f", files["info.tsv"]] if info else [])


def _outputs(prefix, model, gibbs):
    names = [".txt"]
    if model == "haplotype-transcripts":
        names.append("_joint.txt")
    if gibbs:
        names.append("_gibbs.txt.gz")
    contents = {}
    for name in names:
        opener = gzip.open if name.endswith(".gz") else open
        with opener(prefix + name, "rb") as handle:
            contents[name] = handle.read()
    return contents


def _reference(files, model, info, fields, prefix, monkeypatch, env):
    for key in STAGED:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=files["graph.json"], paths=files["panel.json"], alignments=files["aln.json"],
        output_prefix=prefix, inference_model=model,
        path_info=files["info.tsv"] if info else None, rng_seed=SEED, score_not_qual=True,
        threads=2, **fields,
    ))


@pytest.mark.parametrize(
    "name,model,info,extra,fields", CONFIGS, ids=[c[0] for c in CONFIGS]
)
def test_gibbs_cli_byte_identical_to_reference(
    name, model, info, extra, fields, panel_files, tmp_path, monkeypatch
):
    gibbs = fields.get("num_gibbs_samples", 0) > 0
    prefix = str(tmp_path / "port")
    assert cli.main(_argv(panel_files, model, info, extra, prefix)) == 0
    port = _outputs(prefix, model, gibbs)
    assert port[".txt"].count(b"\n") > 10
    if gibbs:
        assert port["_gibbs.txt.gz"].count(b"\n") > 10
    for mode, env in (("staged", STAGED), ("defaults", {})):
        ref_prefix = str(tmp_path / f"ref_{mode}")
        _reference(panel_files, model, info, fields, ref_prefix, monkeypatch, env)
        ref = _outputs(ref_prefix, model, gibbs)
        assert sorted(port) == sorted(ref)
        for suffix in port:
            assert port[suffix] == ref[suffix], f"{name} {mode}: {suffix} differs"


def test_gibbs_cli_runs_with_jax_blocked(panel_files, tmp_path):
    """`haplotype-transcripts -n 8 --use-hap-gibbs` with jax and the JAX
    package blocked (the card's host has neither)."""
    prefix = str(tmp_path / "out")
    argv = _argv(panel_files, "haplotype-transcripts", True, ("-n", "8", "--use-hap-gibbs"), prefix)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, *argv],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK 0" in proc.stdout
    contents = _outputs(prefix, "haplotype-transcripts", gibbs=True)
    assert contents["_gibbs.txt.gz"].count(b"\n") > 10
