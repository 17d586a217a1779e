"""The port's multi-process entry points on the CPU: the sharded fragment pass
in process, ``--multiprocess`` workers (forked), and a two-process Gloo
``run_pipeline_distributed``, each byte-identical to one process; the
columnar shard merges and the tmpfs spill as the JAX package's tests hold
them; and the failures that must end a run: a worker that dies, a Gloo
group that cannot form.  Every spawned process blocks jax and the JAX
package, and every wait on one has a time limit."""

import dataclasses
import glob
import gzip
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from rpvg_tpu_torch import sim
from rpvg_tpu_torch.fragments import FragmentLengthDist
from rpvg_tpu_torch.parallel import multihost
from rpvg_tpu_torch.pipeline import PipelineConfig, run_pipeline

from test_torch_slice import _NO_JAX_RUN, REPO, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
WAIT_S = 240

# The jax blocker of _NO_JAX_RUN, then a distributed run of one rank.
_BLOCK_JAX = _NO_JAX_RUN.split("import rpvg_tpu_torch.cli as cli")[0]
_DIST_RUN = _BLOCK_JAX + r"""
import json
import torch
from rpvg_tpu_torch.parallel.multihost import run_pipeline_distributed
from rpvg_tpu_torch.pipeline import PipelineConfig

job = json.loads(sys.argv[1])
run_pipeline_distributed(
    PipelineConfig(**job["config"]), torch.device("cpu"), job["address"],
    num_processes=job["n"], process_id=job["pid"], timeout_s=job["timeout"],
)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("DIST_OK", job["pid"])
"""


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A small gene panel (4 genes x 3 isoforms x 4 haplotypes) with 600
    multipath read pairs, as JSON lines and as an .rpa stream."""
    from rpvg_tpu_torch import alignments
    from rpvg_tpu_torch.io import rpa

    work = tmp_path_factory.mktemp("torch_multihost")
    panel = sim.build_gene_panel(
        num_genes=4, isoforms_per_gene=3, num_haplotypes=4,
        exons_per_gene=5, exon_length=100, variant_sites=3, seed=71,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 600, read_length=80, frag_mean=200, frag_sd=20, seed=73,
        abundances=sim.gene_abundances(panel, seed=77), multipath_dag=True,
    )
    files = {name: str(work / name) for name in
             ("graph.json", "panel.json", "aln.json", "info.tsv", "aln.rpa")}
    sim.write_alignment_json(records, files["aln.json"])
    parsed = [alignments.parse_multipath_alignment(r) for r in records]
    rpa.write_fragments(
        files["aln.rpa"], list(zip(parsed[0::2], parsed[1::2])),
        is_multipath=True, is_paired=True, frag_mean=200.0, frag_sd=20.0, block_size=32,
    )
    panel.write_graph_json(files["graph.json"])
    panel.write_panel_json(files["panel.json"])
    panel.write_info_tsv(files["info.tsv"])
    return files


def make_config(files, prefix, alignments="aln.json", **fields):
    defaults = dict(
        graph=files["graph.json"], paths=files["panel.json"],
        alignments=files[alignments], output_prefix=prefix,
        inference_model="haplotype-transcripts", path_info=files["info.tsv"],
        rng_seed=42, score_not_qual=True,
    )
    defaults.update(fields)
    return PipelineConfig(**defaults)


def _outputs(prefix):
    contents = {}
    for name in (".txt", "_joint.txt", "_gibbs.txt.gz", "_probs.txt.gz"):
        if os.path.exists(prefix + name):
            opener = gzip.open if name.endswith(".gz") else open
            with opener(prefix + name, "rb") as handle:
                contents[name] = handle.read()
    return contents


def _assert_same_outputs(prefix, base_prefix):
    got, want = _outputs(prefix), _outputs(base_prefix)
    assert sorted(got) == sorted(want) and ".txt" in got
    for name in want:
        assert got[name] == want[name], f"{name} differs"


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# ------------------------------------------------------ in-process shards


@pytest.mark.parametrize(
    "alignments,num_shards", [("aln.json", 2), ("aln.json", 4), ("aln.rpa", 3)],
    ids=["json-2", "json-4", "rpa-3"],
)
def test_sharded_matches_single_process(dataset, tmp_path, alignments, num_shards):
    base = str(tmp_path / "base")
    run_pipeline(make_config(dataset, base, alignments), CPU)
    prefix = str(tmp_path / "sharded")
    multihost.run_pipeline_sharded(make_config(dataset, prefix, alignments), num_shards, CPU)
    _assert_same_outputs(prefix, base)


# ------------------------------------------------------ worker processes


@pytest.mark.parametrize(
    "workers,threads,spill",
    [(1, 1, False), (2, 1, False), (4, 1, False), (1, 4, False), (1, 1, True), (2, 1, True)],
    ids=["1", "2", "4", "1-worker-4-threads", "1-tmpfs", "2-tmpfs"],
)
def test_multiprocess_matches_single_process(dataset, tmp_path, monkeypatch, workers, threads, spill):
    """1 worker adopts its dump; 2 and 4 go through the native merge;
    -t 4 --multiprocess 1 scans with four threads in its worker; with a
    1-byte threshold every payload crosses through tmpfs, and no spill
    file is left behind."""
    base = str(tmp_path / "base")
    run_pipeline(make_config(dataset, base, "aln.rpa", num_gibbs_samples=4), CPU)
    if spill:
        if not os.path.isdir("/dev/shm"):
            pytest.skip("no tmpfs")
        monkeypatch.setenv("RPVG_TPU_SHM_PAYLOAD_MIN", "1")
    prefix = str(tmp_path / "mp")
    config = make_config(dataset, prefix, "aln.rpa", num_gibbs_samples=4, threads=threads)
    stats = multihost.run_pipeline_multiprocess(config, workers, CPU)
    assert stats["fragment_scan_s"] > 0 and stats["merge_s"] >= 0
    _assert_same_outputs(prefix, base)
    assert glob.glob(f"/dev/shm/rpvg_shm_{os.getpid()}_*") == []


def test_multiprocess_cli_runs_with_jax_blocked(dataset, tmp_path):
    """`--multiprocess 2 --ind-hap-inference -n 4` through the CLI in an
    interpreter with jax and the JAX package blocked, so the forked
    workers never hold them either."""
    base = str(tmp_path / "base")
    run_pipeline(make_config(dataset, base, "aln.rpa", ind_hap_inference=True,
                             num_gibbs_samples=4, threads=2), CPU)
    prefix = str(tmp_path / "mp")
    argv = ["-g", dataset["graph.json"], "-p", dataset["panel.json"], "-a", dataset["aln.rpa"],
            "-o", prefix, "-i", "haplotype-transcripts", "-f", dataset["info.tsv"],
            "-r", "42", "--score-not-qual", "-t", "2", "--backend", "cpu",
            "--multiprocess", "2", "--ind-hap-inference", "-n", "4"]
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, *argv], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=str(tmp_path), timeout=WAIT_S,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK 0" in proc.stdout and "Merged 2 worker shards" in proc.stderr
    _assert_same_outputs(prefix, base)


def _dying_worker(args):
    os._exit(3)


def _raising_worker(args):
    raise RuntimeError("shard worker failed")


@pytest.mark.parametrize(
    "worker,error",
    [(_dying_worker, "BrokenProcessPool"), (_raising_worker, "RuntimeError")],
    ids=["dies", "raises"],
)
def test_failed_worker_fails_the_run(dataset, tmp_path, monkeypatch, worker, error):
    """No fallback to fewer processes: the run raises, writes no output
    and leaves no spill file."""
    monkeypatch.setattr(multihost, "_shard_worker", worker)
    monkeypatch.setenv("RPVG_TPU_SHM_PAYLOAD_MIN", "1")
    prefix = str(tmp_path / "mp")
    with pytest.raises(Exception) as info:
        multihost.run_pipeline_multiprocess(make_config(dataset, prefix, "aln.rpa"), 2, CPU)
    assert type(info.value).__name__ == error
    assert not os.path.exists(prefix + ".txt")
    assert glob.glob(f"/dev/shm/rpvg_shm_{os.getpid()}_*") == []


def test_multiprocess_cuda_without_cuda_fails(dataset, tmp_path, capsys):
    """--backend cuda --multiprocess 2 on a host without CUDA: the device
    is checked after the fork, and the run still exits 1 with an error
    line and no output."""
    from rpvg_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    prefix = str(tmp_path / "mp")
    argv = ["-g", dataset["graph.json"], "-p", dataset["panel.json"], "-a", dataset["aln.rpa"],
            "-o", prefix, "-i", "haplotype-transcripts", "-f", dataset["info.tsv"],
            "--score-not-qual", "--backend", "cuda", "--multiprocess", "2"]
    assert cli.main(argv) == 1
    err = [ln for ln in capsys.readouterr().err.splitlines() if ln.strip()]
    assert err[-1].startswith("ERROR:") and "cuda" in err[-1]
    assert not os.path.exists(prefix + ".txt")
    assert glob.glob(f"/dev/shm/rpvg_shm_{os.getpid()}_*") == []


# ------------------------------------------------------- torch.distributed


def test_distributed_matches_single_process(dataset, tmp_path):
    """Two Gloo processes reproduce the single-process outputs byte for
    byte: the estimates, the Gibbs samples and the '-b' blocks."""
    fields = dict(num_gibbs_samples=4, write_probs=True, threads=1)
    base = str(tmp_path / "base")
    run_pipeline(make_config(dataset, base, **fields), CPU)

    prefix = str(tmp_path / "dist")
    config = dataclasses.asdict(make_config(dataset, prefix, **fields))
    address = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _DIST_RUN,
             json.dumps({"config": config, "address": address, "n": 2, "pid": pid,
                         "timeout": WAIT_S})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=str(tmp_path),
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=WAIT_S))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for pid, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, err[-3000:]
        assert f"DIST_OK {pid}" in out
    _assert_same_outputs(prefix, base)
    assert {"_gibbs.txt.gz", "_probs.txt.gz"} <= set(_outputs(prefix))


def test_gloo_group_that_cannot_form_raises(dataset, tmp_path):
    """Rank 0 of a two-process group whose rank 1 never comes: the run
    raises once the timeout passes, and writes nothing."""
    prefix = str(tmp_path / "lonely")
    with pytest.raises(Exception):
        multihost.run_pipeline_distributed(
            make_config(dataset, prefix), CPU, f"localhost:{_free_port()}",
            num_processes=2, process_id=0, timeout_s=3,
        )
    assert not os.path.exists(prefix + ".txt")


# ------------------------------------------------- merges and the spill


def _shard(entries, hist, unaligned):
    # entries: list of (count, anchor, ids, payload_bytes)
    blob = bytearray()
    raw_bounds = [0]
    counts, anchors, id_bounds, all_ids = [], [], [0], []
    for count, anchor, ids, payload in entries:
        blob += int(count).to_bytes(8, "little") + payload
        raw_bounds.append(len(blob))
        counts.append(count)
        anchors.append(anchor)
        all_ids.extend(ids)
        id_bounds.append(len(all_ids))
    return (
        bytes(blob), np.array(counts, np.int64), np.array(anchors, np.int64),
        np.array(id_bounds, np.int64), np.array(all_ids, np.int64),
        np.array(raw_bounds, np.int64), np.array(hist, np.int64), unaligned,
    )


def _random_payloads():
    rng = np.random.default_rng(3)
    keys = [
        rng.integers(0, 256, size=rng.integers(12, 40)).astype(np.uint8).tobytes()
        for _ in range(200)
    ]
    payloads = []
    for s in range(3):
        picks = rng.choice(len(keys), size=150, replace=True)
        entries = [(int(rng.integers(1, 9)), int(k), list(range(k % 5)), keys[k]) for k in picks]
        payloads.append(_shard(entries, np.arange(4) * s, s))
    return payloads


def _columnar_merge_direct(monkeypatch):
    """Cross-shard duplicates sum their counts (rewritten into the blob),
    first-seen order wins, histograms and unaligned counts add."""
    s0 = _shard([(2, 7, [7, 9], b"AAA"), (1, 3, [3], b"BB")], [0, 1, 0], 1)
    s1 = _shard([(5, 7, [7, 9], b"AAA"), (4, 11, [], b"CCCC")], [0, 2, 1], 2)
    merged = multihost._merge_columnar_shards([s0, s1], FragmentLengthDist.from_normal(2, 1, 1), False)
    cols = merged.columnar
    assert merged.num_entries() == 3
    np.testing.assert_array_equal(cols.counts, [7, 1, 4])
    np.testing.assert_array_equal(cols.anchors, [7, 3, 11])
    data = np.frombuffer(cols.data, np.uint8)
    for e in range(3):
        start = int(cols.raw_bounds[e])
        assert int.from_bytes(bytes(data[start : start + 8]), "little") == int(cols.counts[e])
    assert bytes(data[int(cols.raw_bounds[0]) + 8 : int(cols.raw_bounds[1])]) == b"AAA"
    np.testing.assert_array_equal(cols.id_bounds, [0, 2, 3, 3])
    np.testing.assert_array_equal(cols.all_ids, [7, 9, 3])
    np.testing.assert_array_equal(merged.frag_length_counts, [0, 3, 1])
    assert merged.unaligned_count == 3


def _native_merge_matches_python_spec(monkeypatch):
    """The threaded C++ merge (the port's copy of the library) is
    byte-identical to the Python keying and gather."""
    from rpvg_tpu_torch import native

    if not native.native_available():
        pytest.skip("native toolchain unavailable")
    payloads = _random_payloads()
    pre = FragmentLengthDist.from_normal(2, 1, 1)
    nat = multihost._native_shard_merge(payloads, pre, False)
    assert nat is not None
    monkeypatch.setattr(multihost, "_native_shard_merge", lambda *a, **k: None)
    ref = multihost._merge_columnar_shards(payloads, pre, False)
    nc, rc = nat.columnar, ref.columnar
    assert bytes(nc.data) == bytes(rc.data)
    for attr in ("counts", "anchors", "id_bounds", "all_ids", "raw_bounds", "histogram"):
        np.testing.assert_array_equal(getattr(nc, attr), getattr(rc, attr))
    assert nc.unaligned == rc.unaligned


def _tmpfs_round_trip(monkeypatch):
    """Every payload array comes back exactly, the file is unlinked
    before use, and the data buffer is an ndarray (the single-shard adopt
    turns it into bytes)."""
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no tmpfs")
    monkeypatch.setenv("RPVG_TPU_SHM_PAYLOAD_MIN", "1")
    rng = np.random.default_rng(2)
    payload = (
        rng.integers(0, 256, 4096).astype(np.uint8).tobytes(),
        rng.integers(1, 5, 7).astype(np.int64), rng.integers(0, 9, 7).astype(np.int64),
        np.arange(8, dtype=np.int64), rng.integers(0, 9, 30).astype(np.int64),
        np.arange(8, dtype=np.int64) * 13, rng.integers(0, 4, 100).astype(np.int64), 5,
    )
    spilled = multihost._spill_columnar_payload(payload, shard=0)
    assert spilled is not None
    loaded = multihost._load_spilled_payload(spilled)
    assert not os.path.exists(spilled[0])
    assert isinstance(loaded[0], np.ndarray)
    assert np.asarray(loaded[0]).tobytes() == payload[0]
    for got, want in zip(loaded[1:7], payload[1:7]):
        assert np.array_equal(np.asarray(got), want)
    assert loaded[7] == 5


@pytest.mark.parametrize(
    "check", [_columnar_merge_direct, _native_merge_matches_python_spec, _tmpfs_round_trip],
    ids=["columnar-merge", "native-merge-vs-python", "tmpfs-round-trip"],
)
def test_shard_merge_and_spill(check, monkeypatch):
    check(monkeypatch)
