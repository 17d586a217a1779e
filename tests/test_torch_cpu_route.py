"""The port's ``--backend cpu`` route against the JAX package's off the
TPU, bit for bit: diploid pairs are scored, selected and normalised in
the C++ library (``_diploid_posteriors_native``) on both sides, so the
posteriors, and the read-count Gibbs samples thinned from them, carry
the same bits.  The CLI runs use the gene panel of ``chip_smoke.py``'s
``write_dataset`` (7 isoforms x 4 haplotypes per gene) at 100 genes and
5,000 read pairs."""

import gzip

import numpy as np
import pytest
import torch

import rpvg_tpu.pipeline as ref_pipeline
from rpvg_tpu import sim
from rpvg_tpu.infer import posteriors as ref_post
from rpvg_tpu_torch import alignments, cli
from rpvg_tpu_torch.io import rpa
from rpvg_tpu_torch.infer import posteriors
from rpvg_tpu_torch.testing import counted, posterior_cluster_set

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SEED = 42
STAGED = {"RPVG_TPU_FUSED_NESTED": "0", "RPVG_TPU_FUSED_STRAINS": "0"}


@pytest.mark.parametrize("min_rel", [1e-8, 1e-3])
def test_cpu_pair_posteriors_bitwise_equal_to_reference(min_rel):
    clusters = posterior_cluster_set(200, seed=3)
    with counted() as counts:
        port = posteriors.diploid_posteriors_batched(clusters, min_rel, CPU)
    ref = ref_post.diploid_posteriors_batched(clusters, min_rel)
    assert counts["posteriors.scored.cpu"] == len(clusters)
    assert len(port) == len(ref) == 200
    for (p_groups, p_post), (r_groups, r_post) in zip(port, ref):
        assert [list(g) for g in p_groups] == [list(g) for g in r_groups]
        assert np.asarray(p_post).tobytes() == np.asarray(r_post).tobytes()


# ------------------------------------------------- the CLI, end to end


@pytest.fixture(scope="module")
def panel_files(tmp_path_factory):
    """100 genes x 7 isoforms x 4 haplotypes (panel seed 5) and 5,000
    multipath read pairs (read seed 17, abundance seed 7) as ``.rpa``."""
    work = tmp_path_factory.mktemp("cpu_route_panel")
    panel = sim.build_gene_panel(
        num_genes=100, isoforms_per_gene=7, num_haplotypes=4,
        exons_per_gene=10, exon_length=120, variant_sites=3, seed=5,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 5000, read_length=100, frag_mean=250, frag_sd=25, seed=17,
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
    return files


def _argv(files, model, prefix, extra):
    argv = [
        "-g", files["graph.json"], "-p", files["panel.json"], "-a", files["aln.rpa"],
        "-o", prefix, "-i", model, "-r", str(SEED), "-t", "4", "--score-not-qual",
        "--backend", "cpu", *extra,
    ]
    return argv + (["-f", files["info.tsv"]] if model == "haplotype-transcripts" else [])


def _outputs(prefix, model, gibbs):
    names = [".txt"] + (["_joint.txt"] if model == "haplotype-transcripts" else [])
    names += ["_gibbs.txt.gz"] if gibbs else []
    contents = {}
    for name in names:
        opener = gzip.open if name.endswith(".gz") else open
        with opener(prefix + name, "rb") as handle:
            contents[name] = handle.read()
    return contents


def _reference(files, model, prefix, env, monkeypatch, **fields):
    for key in STAGED:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    return ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=files["graph.json"], paths=files["panel.json"], alignments=files["aln.rpa"],
        output_prefix=prefix, inference_model=model,
        path_info=files["info.tsv"] if model == "haplotype-transcripts" else None,
        rng_seed=SEED, score_not_qual=True, threads=4, **fields,
    ))


def _differing_lines(port, ref):
    return sum(a != b for a, b in zip(port.splitlines(), ref.splitlines()))


def _posterior_bits(results):
    """Per cluster the group sets and the bytes of the posteriors: the
    files round them, the bits are the route's."""
    return [
        ([list(g) for g in r.estimates.path_group_sets],
         np.asarray(r.estimates.posteriors, dtype=np.float64).tobytes())
        for r in results
    ]


# (name, model, CLI flags, PipelineConfig fields, reference routes)
CLI_RUNS = [
    ("haplotype-transcripts-n8", "haplotype-transcripts", ("-n", "8"),
     {"num_gibbs_samples": 8}, (("staged", STAGED), ("defaults", {}))),
    ("haplotypes", "haplotypes", (), {}, (("defaults", {}),)),
    ("ind-hap-n8", "haplotype-transcripts", ("--ind-hap-inference", "-n", "8"),
     {"num_gibbs_samples": 8, "ind_hap_inference": True}, (("defaults", {}),)),
]


@pytest.mark.parametrize(
    "name,model,extra,fields,routes", CLI_RUNS, ids=[run[0] for run in CLI_RUNS]
)
def test_cpu_cli_byte_identical_to_reference(
    name, model, extra, fields, routes, panel_files, tmp_path, monkeypatch
):
    """The port's staged route (``RPVG_TPU_FUSED_NESTED=0``) writes the
    JAX package's bytes in every file, against its staged route and its
    defaults (the fused native routes), and its clusters carry the same
    posterior bits."""
    gibbs = "-n" in extra
    prefix = str(tmp_path / "port")
    for key, value in STAGED.items():
        monkeypatch.setenv(key, value)
    rc, stats = cli.run_cli(_argv(panel_files, model, prefix, extra))
    assert rc == 0
    port = _outputs(prefix, model, gibbs)
    port_bits = _posterior_bits(stats["results"])
    assert port[".txt"].count(b"\n") > 100
    if gibbs:
        assert port["_gibbs.txt.gz"].count(b"\n") > 100
    for mode, env in routes:
        ref_prefix = str(tmp_path / f"ref_{mode}")
        ref_stats = _reference(panel_files, model, ref_prefix, env, monkeypatch, **fields)
        ref = _outputs(ref_prefix, model, gibbs)
        for suffix in port:
            assert port[suffix] == ref[suffix], (
                f"{name} against the reference's {mode} route: {suffix} differs in "
                f"{_differing_lines(port[suffix], ref[suffix])} lines"
            )
        ref_bits = _posterior_bits(ref_stats["results"])
        assert len(port_bits) == len(ref_bits) > 100
        differing = sum(a != b for a, b in zip(port_bits, ref_bits))
        assert differing == 0, f"{name} against the reference's {mode} route: " \
            f"{differing} clusters' posteriors differ"
