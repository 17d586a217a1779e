"""``haplotypes`` and ``haplotype-transcripts`` at ploidy 1, 3 and 4 through
the port's CLI on the CPU, against in-process ``rpvg_tpu`` runs:
outputs within rtol 1e-6 / atol 1e-6 with identical rows
(``compare.py``, the reference's tolerance); ``--use-hap-gibbs`` at
ploidy 3 in distribution (the k-slot sampler draws from Philox, the JAX
package's from threefry): per cluster no further from the JAX package's
posteriors than a second JAX seed is, plus a margin."""

import os
import subprocess
import sys

import numpy as np
import pytest

import rpvg_tpu.pipeline as ref_pipeline
from rpvg_tpu import sim
from rpvg_tpu_torch import cli
from rpvg_tpu_torch.compare import compare_estimate_files

from test_torch_slice import _NO_JAX_RUN, REPO, one_torch_thread  # noqa: F401

SEED = 31


def _tv(a, b):
    return 0.5 * sum(abs(a.get(g, 0.0) - b.get(g, 0.0)) for g in set(a) | set(b))


def _as_dict(groups, posts):
    return {tuple(g): float(p) for g, p in zip(groups, posts)}


# ------------------------------------------------------ the slice, end to end


@pytest.fixture(scope="module")
def panel_files(tmp_path_factory):
    """A small gene panel (5 genes x 3 isoforms x 4 haplotypes) and 1,200
    multipath read pairs."""
    work = tmp_path_factory.mktemp("ploidy_panel")
    panel = sim.build_gene_panel(
        num_genes=5, isoforms_per_gene=3, num_haplotypes=4,
        exons_per_gene=5, exon_length=100, variant_sites=3, seed=61,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 1200, read_length=80, frag_mean=200, frag_sd=20, seed=63,
        abundances=sim.gene_abundances(panel, seed=67), multipath_dag=True,
    )
    files = {name: str(work / name) for name in ("graph.json", "panel.json", "aln.json", "info.tsv")}
    sim.write_alignment_json(records, files["aln.json"])
    panel.write_graph_json(files["graph.json"])
    panel.write_panel_json(files["panel.json"])
    panel.write_info_tsv(files["info.tsv"])
    files["pairs"] = 1200
    return files


def _argv(files, model, ploidy, prefix, extra=(), seed=SEED):
    argv = [
        "-g", files["graph.json"], "-p", files["panel.json"], "-a", files["aln.json"],
        "-o", prefix, "-i", model, "-y", str(ploidy), "-r", str(seed), "--score-not-qual",
        "-t", "2", "--backend", "cpu", *extra,
    ]
    return argv + (["-f", files["info.tsv"]] if model == "haplotype-transcripts" else [])


def _reference(files, model, ploidy, prefix, seed=SEED, **fields):
    return ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=files["graph.json"], paths=files["panel.json"], alignments=files["aln.json"],
        output_prefix=prefix, inference_model=model, ploidy=ploidy,
        path_info=files["info.tsv"] if model == "haplotype-transcripts" else None,
        rng_seed=seed, score_not_qual=True, threads=2, **fields,
    ))


@pytest.mark.parametrize(
    "model,ploidy",
    [("haplotypes", 3), ("haplotypes", 1), ("haplotype-transcripts", 3), ("haplotypes", 4),
     ("haplotype-transcripts", 4)],
    ids=["haplotypes-y3", "haplotypes-y1", "haplotype-transcripts-y3", "haplotypes-y4",
         "haplotype-transcripts-y4"],
)
def test_cli_matches_reference_pipeline(model, ploidy, panel_files, tmp_path):
    prefix, ref_prefix = str(tmp_path / "port"), str(tmp_path / "ref")
    rc, stats = cli.run_cli(_argv(panel_files, model, ploidy, prefix))
    assert rc == 0
    assert stats["group_engine"] == f"full enumeration, group size {ploidy}"
    assert stats["enumeration_fallback_clusters"] == 0
    _reference(panel_files, model, ploidy, ref_prefix)
    suffixes = (".txt", "_joint.txt") if model == "haplotype-transcripts" else (".txt",)
    for suffix in suffixes:
        report = compare_estimate_files(prefix + suffix, ref_prefix + suffix, 1e-6, 1e-6)
        assert report["rows"] > 10


def _cluster_posteriors(results):
    return [
        _as_dict(r.estimates.path_group_sets, r.estimates.posteriors)
        for r in results if r.estimates.path_group_sets
    ]


def test_cli_hap_gibbs_ploidy_3_matches_reference_in_distribution(panel_files, tmp_path):
    """Per cluster, the port's posteriors are no further from the JAX
    package's than a second JAX seed's are: the mean excess of the total
    variation is at most 0.01 + 3 standard errors (chip_smoke.py's bound
    across devices)."""
    rc, stats = cli.run_cli(
        _argv(panel_files, "haplotypes", 3, str(tmp_path / "port"), ("--use-hap-gibbs",))
    )
    assert rc == 0 and stats["group_engine"] == "posterior Gibbs, 3 slots"
    port = _cluster_posteriors(stats["results"])
    ref = _cluster_posteriors(
        _reference(panel_files, "haplotypes", 3, str(tmp_path / "ref"), use_hap_gibbs=True)["results"]
    )
    other = _cluster_posteriors(
        _reference(panel_files, "haplotypes", 3, str(tmp_path / "ref2"), seed=SEED + 1,
                   use_hap_gibbs=True)["results"]
    )
    assert len(port) == len(ref) == len(other) > 3
    excess = np.array([_tv(p, r) - _tv(o, r) for p, r, o in zip(port, ref, other)])
    se = excess.std(ddof=1) / np.sqrt(excess.size)
    assert excess.mean() <= 0.01 + 3 * se, (excess.mean(), se)
    for post in port:
        assert sum(post.values()) == pytest.approx(1.0)


def test_cli_nested_hap_gibbs_with_read_count_gibbs_at_ploidy_3(panel_files, tmp_path):
    """`haplotype-transcripts -f -y 3 --use-hap-gibbs -n 4` runs to the
    end with jax and the JAX package blocked; its posteriors sum to 1 per
    transcript of a cluster and its read counts to the input pairs (its draws differ from
    the JAX package's by design, so its subsets do too)."""
    from rpvg_tpu_torch.compare import read_gibbs_file

    prefix = str(tmp_path / "out")
    argv = _argv(panel_files, "haplotype-transcripts", 3, prefix, ("--use-hap-gibbs", "-n", "4"))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, *argv],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK 0" in proc.stdout
    with open(prefix + "_joint.txt") as handle:
        header, *rows = [line.rstrip("\n").split("\t") for line in handle]
    post = {}
    for row in rows:
        if row[0] == "Unknown":
            continue
        # Per transcript of a cluster: its haplotype groups' posteriors.
        key = (row[header.index("ClusterID")], row[0].rsplit("_na_h", 1)[0])
        post[key] = post.get(key, 0.0) + float(row[header.index("HaplotypingProbability")])
    assert len(post) > 3
    for key, total in post.items():
        assert total == pytest.approx(1.0, abs=1e-6), key
    with open(prefix + ".txt") as handle:
        header, *rows = [line.rstrip("\n").split("\t") for line in handle]
    reads = sum(float(row[header.index("ReadCount")]) for row in rows)
    assert reads == pytest.approx(panel_files["pairs"], rel=1e-3)
    _, gibbs_rows = read_gibbs_file(prefix + "_gibbs.txt.gz")
    assert gibbs_rows and all(len(v) == 4 for v in gibbs_rows.values())
