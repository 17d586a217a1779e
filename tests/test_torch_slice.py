"""The port's main path end to end on the CPU: golden files, an
in-process reference run, verbatim-copy drift, a run with jax blocked,
and the CLI on the configurations it once refused."""

import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import rpvg_tpu.infer.batched_models as ref_batched_models
import rpvg_tpu.infer.batching as ref_batching
import rpvg_tpu.infer.estimators as ref_estimators
import rpvg_tpu.infer.posteriors as ref_posteriors
import rpvg_tpu.infer.readcount_gibbs as ref_readcount_gibbs
import rpvg_tpu.parallel.multihost as ref_multihost
import rpvg_tpu.pipeline as ref_pipeline
import rpvg_tpu_torch.infer.batched_models as port_batched_models
import rpvg_tpu_torch.infer.batching as port_batching
import rpvg_tpu_torch.infer.estimators as port_estimators
import rpvg_tpu_torch.infer.posteriors as port_posteriors
import rpvg_tpu_torch.infer.readcount_gibbs as port_readcount_gibbs
import rpvg_tpu_torch.parallel.multihost as port_multihost
import rpvg_tpu_torch.pipeline as port_pipeline
from rpvg_tpu import sim
from rpvg_tpu_torch import cli
from rpvg_tpu_torch.compare import compare_estimate_files

from test_golden import GOLDEN_DIR, make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE_DIR = os.path.join(REPO, "rpvg_tpu_torch")
RTOL = 1e-6
ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread per test process.  The plain EM and
    pair-score loops run thousands of tiny torch ops; with several test
    workers on one host, every worker's thread pool would spin on every
    core and slow each file down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_inputs(panel, tmp_dir):
    graph = os.path.join(tmp_dir, "graph.json")
    paths = os.path.join(tmp_dir, "panel.json")
    panel.write_graph_json(graph)
    panel.write_panel_json(paths)
    return graph, paths


def _argv(graph, paths, aln, info, prefix, qual=False, backend="cpu", extra=()):
    argv = [
        "-g", graph, "-p", paths, "-a", aln, "-o", prefix,
        "-i", "haplotype-transcripts", "-f", info, "-r", "99", "--backend", backend,
        *extra,
    ]
    if not qual:
        argv.append("--score-not-qual")
    return argv


@pytest.mark.parametrize(
    "name,qual,gene_panel,dag",
    [
        ("haplotype-transcripts", False, False, False),
        ("haplotype-transcripts-qual", True, False, False),
        ("haplotype-transcripts-dag", True, True, True),
    ],
)
def test_cpu_slice_matches_golden(name, qual, gene_panel, dag, tmp_path, record_property):
    panel, aln, info = make_dataset(str(tmp_path), qual=qual, gene_panel=gene_panel, dag=dag)
    graph, paths = _write_inputs(panel, str(tmp_path))
    prefix = str(tmp_path / "out")
    assert cli.main(_argv(graph, paths, aln, info, prefix, qual=qual)) == 0
    for suffix in (".txt", "_joint.txt"):
        report = compare_estimate_files(
            prefix + suffix, os.path.join(GOLDEN_DIR, name + suffix), RTOL, ATOL
        )
        record_property(f"{suffix}_byte_identical", report["byte_identical"])
        print(f"{name}{suffix}: {report}")


def test_cpu_slice_matches_reference_pipeline(tmp_path):
    panel = sim.build_gene_panel(
        num_genes=8, isoforms_per_gene=4, num_haplotypes=4,
        exons_per_gene=6, exon_length=100, variant_sites=3, seed=41,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 2000, read_length=80, frag_mean=200, frag_sd=20, seed=43,
        abundances=sim.gene_abundances(panel, seed=47), multipath_dag=True,
    )
    aln = str(tmp_path / "aln.json")
    sim.write_alignment_json(records, aln)
    info = str(tmp_path / "info.tsv")
    panel.write_info_tsv(info)
    graph, paths = _write_inputs(panel, str(tmp_path))

    ref_prefix = str(tmp_path / "ref")
    ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=graph, paths=paths, alignments=aln, output_prefix=ref_prefix,
        inference_model="haplotype-transcripts", path_info=info, rng_seed=99,
        score_not_qual=True, threads=2,
    ))
    prefix = str(tmp_path / "port")
    assert cli.main(_argv(graph, paths, aln, info, prefix, extra=("-t", "2"))) == 0
    for suffix in (".txt", "_joint.txt"):
        report = compare_estimate_files(prefix + suffix, ref_prefix + suffix, RTOL, ATOL)
        assert report["rows"] > 10


def test_cpu_slice_probability_file_matches_reference(tmp_path):
    """-b is host code: the port writes the reference's probability file."""
    import gzip

    panel, aln, info = make_dataset(str(tmp_path))
    graph, paths = _write_inputs(panel, str(tmp_path))
    ref_prefix = str(tmp_path / "ref")
    ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=graph, paths=paths, alignments=aln, output_prefix=ref_prefix,
        inference_model="haplotype-transcripts", path_info=info, rng_seed=99,
        score_not_qual=True, write_probs=True,
    ))
    prefix = str(tmp_path / "port")
    assert cli.main(_argv(graph, paths, aln, info, prefix, extra=("-b",))) == 0
    with gzip.open(prefix + "_probs.txt.gz", "rt") as port, gzip.open(
        ref_prefix + "_probs.txt.gz", "rt"
    ) as ref:
        assert port.read() == ref.read()


@pytest.mark.parametrize("model", ["transcripts", "haplotype-transcripts"])
def test_cpu_single_end_matches_reference(model, tmp_path):
    """--single-end (with the prior fragment length) writes the
    reference's bytes."""
    panel = sim.build_gene_panel(
        num_genes=4, isoforms_per_gene=3, num_haplotypes=4,
        exons_per_gene=5, exon_length=100, variant_sites=3, seed=81,
    )
    records, _ = sim.simulate_single_reads(panel, 800, read_length=80, seed=83)
    aln = str(tmp_path / "se.json")
    sim.write_alignment_json(records, aln)
    info = str(tmp_path / "info.tsv")
    panel.write_info_tsv(info)
    graph, paths = _write_inputs(panel, str(tmp_path))
    ref_prefix = str(tmp_path / "ref")
    ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=graph, paths=paths, alignments=aln, output_prefix=ref_prefix,
        inference_model=model, path_info=info, rng_seed=99, score_not_qual=True,
        single_end=True, frag_mean=200.0, frag_sd=20.0,
    ))
    prefix = str(tmp_path / "port")
    argv = ["-g", graph, "-p", paths, "-a", aln, "-o", prefix, "-i", model, "-f", info,
            "-r", "99", "--score-not-qual", "--backend", "cpu", "--single-end",
            "-m", "200", "-d", "20"]
    assert cli.main(argv) == 0
    for suffix in output_suffixes(model):
        with open(prefix + suffix, "rb") as port, open(ref_prefix + suffix, "rb") as ref:
            port_bytes = port.read()
            assert port_bytes == ref.read()
        assert port_bytes.count(b"\n") > 10


def output_suffixes(model):
    return (".txt", "_joint.txt") if model == "haplotype-transcripts" else (".txt",)


# --------------------------------------------------------- drift guard

VERBATIM = [
    (port_pipeline, ref_pipeline, name)
    for name in (
        "PipelineConfig", "_mem_gb", "condense_alignment_paths", "FragmentIndex",
        "_NativeIndexerSession", "ColumnarFragmentIndex", "run_fragment_pass",
        "partition_fragments", "ClusterResult", "_build_cluster_path_infos",
        "_clusters_meta", "_run_native_matrix_build", "build_cluster_matrices_batched",
        "build_cluster_matrices_columnar", "build_cluster_probs",
        "_collapse_cluster_paths", "_is_gbwt_container", "load_inputs",
        "resolve_pre_fragment_dist", "iter_fragments", "build_finder",
        "submit_info_parse", "PipelineInputError",
        "_remove_partial_outputs", "compute_tpm_normalizer",
        "_write_hapjoint_columnar", "_gather_path_row_meta",
        "_write_abundance_columnar", "write_outputs",
    )
] + [
    (port_estimators, ref_estimators, name)
    for name in (
        "PathEstimator", "PathPosteriorEstimator", "PathGroupPosteriorEstimator",
        "PathAbundanceEstimator", "MinimumPathAbundanceEstimator",
        "NestedPathAbundanceEstimator", "make_estimator",
    )
] + [
    (port_batching, ref_batching, name)
    for name in (
        "em_postprocess", "native_em_available", "fuse_em_enabled", "_ceil_pow2", "_ceil_pow4",
        "run_native_em",
    )
] + [
    (port_batched_models, ref_batched_models, name)
    for name in (
        "_flat_group_spec", "_attach_gibbs_samples", "_native_combine_slots",
        "_task_matrix_bounds", "_section_task_matrices", "_merge_nested_columnar",
    )
] + [
    (port_posteriors, ref_posteriors, name)
    for name in (
        "_normalize_log_posteriors", "_pair_tensor_limit", "_ceil_pow2",
        "_ceil_pow4", "_diploid_select", "_native_diploid_select", "_diploid_posteriors_native",
        "gibbs_iteration_counts", "_native_pair_scores", "_posterior_gibbs_native",
        "_log_permutations_rows",
    )
] + [
    (port_readcount_gibbs, ref_readcount_gibbs, name)
    for name in ("_fold_low_abundance", "run_native_gibbs")
] + [
    (port_multihost, ref_multihost, name)
    for name in (
        "_merge_shard_indexes", "_shm_payload_min", "_spill_columnar_payload",
        "_load_spilled_payload", "_shard_worker", "_native_shard_merge",
        "_merge_columnar_shards", "_run_aranges",
    )
]


def _absolute_imports(source: str, module: str) -> str:
    """Resolve relative imports against ``module`` and map the port's
    package name onto the reference's, so a verbatim copy whose imports
    were made absolute compares equal to its original."""
    package = module.split(".")[:-1]

    def resolve(match):
        indent, dots, rest = match.groups()
        base = package[: len(package) - (len(dots) - 1)]
        return f"{indent}from {'.'.join(base + ([rest] if rest else []))} import"

    source = re.sub(r"^(\s*)from (\.+)([\w.]*) import", resolve, source, flags=re.M)
    return re.sub(r"^(\s*)from rpvg_tpu_torch\b", r"\1from rpvg_tpu", source, flags=re.M)


@pytest.mark.parametrize(
    "port_mod,ref_mod,name", VERBATIM, ids=[f"{p.__name__}.{n}" for p, _, n in VERBATIM]
)
def test_verbatim_copy_has_not_drifted(port_mod, ref_mod, name):
    port_src = _absolute_imports(inspect.getsource(getattr(port_mod, name)), port_mod.__name__)
    ref_src = _absolute_imports(inspect.getsource(getattr(ref_mod, name)), ref_mod.__name__)
    assert port_src == ref_src


def test_device_only_rewrite_has_not_drifted():
    """``run_pipeline_sharded`` is the JAX package's but for the device it
    takes and passes on."""
    port_src = _absolute_imports(
        inspect.getsource(port_multihost.run_pipeline_sharded), port_multihost.__name__
    )
    ref_src = _absolute_imports(
        inspect.getsource(ref_multihost.run_pipeline_sharded), ref_multihost.__name__
    )
    assert port_src.count("device") == 3  # the parameter, its type, the call
    stripped = port_src.replace(", device: torch.device", "").replace(", device,", ",")
    assert stripped == ref_src


def _strip_spans(source: str) -> str:
    """``source`` without its span lines: each ``with spans.`` line goes
    and its block moves out one level; every other line naming ``spans.``
    goes, with the blank line it leaves."""
    kept, blocks = [], []
    for line in source.splitlines(keepends=True):
        indent = len(line) - len(line.lstrip())
        while blocks and line.strip() and indent <= blocks[-1]:
            blocks.pop()
        if "spans." in line:
            if line.lstrip().startswith("with spans."):
                blocks.append(indent)
            continue
        kept.append(line[4 * len(blocks):] if line.strip() else line)
    return re.sub(r"\n\n\n+", "\n\n", "".join(kept))


def test_spanned_rewrite_has_not_drifted():
    """``collect_fragments`` is the JAX package's but for its spans and
    counters (the reader thread's blocks go through ``spans.each``)."""
    port_src = _absolute_imports(
        inspect.getsource(port_pipeline.collect_fragments), port_pipeline.__name__
    )
    ref_src = _absolute_imports(
        inspect.getsource(ref_pipeline.collect_fragments), ref_pipeline.__name__
    )
    assert "\n\n\n" not in ref_src
    for span in ("read", "wait", "project", "dump"):
        assert port_src.count(f'"rpvg.fragments.{span}"') == 1
    assert port_src.count("enumerate(blocks)") == 1
    stripped = _strip_spans(port_src.replace("enumerate(blocks)", "enumerate(reader.blocks())"))
    assert stripped == ref_src


def test_verbatim_constants_match():
    assert port_multihost._SHM_DIR == ref_multihost._SHM_DIR
    assert port_pipeline.FRAGMENT_BATCH_SIZE == ref_pipeline.FRAGMENT_BATCH_SIZE
    assert port_posteriors._PAIR_TENSOR_ELEMENT_LIMIT == ref_posteriors._PAIR_TENSOR_ELEMENT_LIMIT
    assert port_posteriors._FULL_ENUM_GROUP_LIMIT == ref_posteriors._FULL_ENUM_GROUP_LIMIT


# ---------------------------------------------------- jax-free operation

_NO_JAX_RUN = r"""
import importlib.machinery, sys

BLOCKED = ("jax", "jaxlib", "rpvg_tpu")

class NoJax(importlib.machinery.PathFinder):
    @classmethod
    def find_spec(cls, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            return None
        return importlib.machinery.PathFinder.find_spec(name, path, target)

sys.meta_path = [NoJax if f is importlib.machinery.PathFinder else f for f in sys.meta_path]
import rpvg_tpu_torch.cli as cli
rc = cli.main(sys.argv[1:])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("NO_JAX_OK", rc)
sys.exit(rc)
"""


def test_slice_runs_with_jax_blocked(tmp_path):
    """Stands in for the machine with the card, which has no jax; the
    JAX package is blocked too, since the port must not import it."""
    panel, aln, info = make_dataset(str(tmp_path))
    graph, paths = _write_inputs(panel, str(tmp_path))
    prefix = str(tmp_path / "out")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, *_argv(graph, paths, aln, info, prefix)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK 0" in proc.stdout
    report = compare_estimate_files(
        prefix + ".txt", os.path.join(GOLDEN_DIR, "haplotype-transcripts.txt"), RTOL, ATOL
    )
    assert report["rows"] > 0


def test_no_jax_import_in_package():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = []
    for root, _, files in os.walk(PACKAGE_DIR):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as handle:
                    if pattern.search(handle.read()):
                        offenders.append(path)
    assert not offenders


# ------------------------------------------------------------- the CLI


def test_cuda_backend_without_cuda_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    panel, aln, info = make_dataset(str(tmp_path))
    graph, paths = _write_inputs(panel, str(tmp_path))
    rc = cli.main(_argv(graph, paths, aln, info, str(tmp_path / "out"), backend="cuda"))
    err = [ln for ln in capsys.readouterr().err.splitlines() if ln.strip()]
    assert rc == 1
    assert len(err) == 1 and err[0].startswith("ERROR:") and "cuda" in err[0]
    assert not os.path.exists(str(tmp_path / "out.txt"))


@pytest.mark.parametrize(
    "extra,item",
    [
        (("--ind-hap-inference", "-y", "3"), 14),
        (("--ind-hap-inference", "--use-hap-gibbs"), 14),
        (("--multiprocess", "2", "-y", "3"), 16),
        (("--ind-hap-inference", "-n", "4"), 14),
        (("--multiprocess", "3"), 16),
        (("--ind-hap-inference",), 14),
        (("-i", "haplotypes", "--multiprocess", "2"), 16),
        (("--multiprocess", "2"), 16),
    ],
)
def test_unported_configuration_exits_1(extra, item, tmp_path):
    """The configurations the port refused with exit 1 until ROADMAP
    item ``item`` ported them now run on ``--backend cpu``: exit 0 and
    the ``.txt`` of an in-process ``rpvg_tpu`` run, byte for byte."""
    panel, aln, info = make_dataset(str(tmp_path), gene_panel=True)
    graph, paths = _write_inputs(panel, str(tmp_path))
    argv = ["-g", graph, "-p", paths, "-a", aln, "-o", str(tmp_path / "out"),
            "-i", "haplotype-transcripts", "-f", info, "--backend", "cpu", *extra,
            "-r", "99", "--score-not-qual"]
    assert cli.main(argv) == 0
    args = cli.build_parser().parse_args(argv)
    ref_prefix = str(tmp_path / "ref")
    ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=graph, paths=paths, alignments=aln, output_prefix=ref_prefix,
        inference_model=args.inference_model, path_info=info, rng_seed=99,
        score_not_qual=True, ploidy=args.ploidy, ind_hap_inference=args.ind_hap_inference,
        use_hap_gibbs=args.use_hap_gibbs, num_gibbs_samples=args.num_gibbs_samples,
    ))
    with open(str(tmp_path / "out.txt"), "rb") as port, open(ref_prefix + ".txt", "rb") as ref:
        port_bytes = port.read()
        assert port_bytes == ref.read()
    assert port_bytes.count(b"\n") > 5


def test_resolve_device():
    from rpvg_tpu_torch.device import DeviceUnavailableError, resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            resolve_device("cuda")
