"""Entry points of the port (counterpart of ``__graft_entry__.py``).

:func:`entry` returns the flagship device computation, the batched EM
fixed point at the heart of every quantification model, with example
padded-cluster-batch inputs on a device.

:func:`dryrun_multidevice` runs the sharded steps and the batched
dispatches on n data shards and holds them against one shard: the mesh
step of ``parallel/mesh.py`` (data-parallel EM, model-parallel pair
scores, the TPM reduction) and the histogram reduction; the batched EM,
read-count Gibbs and diploid posterior dispatches; and the whole pipeline in
both scoring regimes with ``-n 3 -b`` and the giant-cluster shard route.
Unlike the JAX package's dry run it never falls back to the CPU: with
fewer CUDA devices than asked for it raises, unless the caller asks for
n virtual shards of one device (``virtual=True``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Union

import numpy as np
import torch

from rpvg_tpu_torch.device import DeviceUnavailableError, resolve_device
from rpvg_tpu_torch.parallel import autoshard


def _example_batch(B=4, R=64, C=16, dtype=np.float64):
    """``__graft_entry__._example_batch``'s draws in ``dtype``."""
    rng = np.random.default_rng(0)
    probs = rng.random((B, R, C)).astype(dtype)
    probs /= probs.sum(axis=2, keepdims=True)
    counts = rng.integers(1, 10, size=(B, R)).astype(dtype)
    col_masks = np.ones((B, C), dtype=dtype)
    return probs, counts, col_masks


def _em_forward(probs, counts, col_masks, max_em_its=100, max_rel_em_conv=0.001):
    """(B, C) abundance fractions of a padded batch: each cluster's
    extent (rows to its last nonzero count, columns to its last positive
    mask) packed as a ragged task and solved by
    ``em_cuda.em_fixed_point`` (the ragged kernel on a CUDA device, its
    plain version on the CPU); padded columns stay 0."""
    from rpvg_tpu_torch.infer.batching import pack_ragged
    from rpvg_tpu_torch.ops import em_cuda
    from rpvg_tpu_torch.ops.em_fused_cuda import cluster_extents

    extents = cluster_extents([(probs, counts, col_masks)])
    host_probs, host_counts = probs.cpu().numpy(), counts.cpu().numpy()
    tasks = pack_ragged(
        [(host_probs[b, :r, :c], host_counts[b, :r]) for b, (r, c) in enumerate(extents)],
        probs.device,
    )
    fracs, _ = em_cuda.em_fixed_point(tasks, max_em_its, max_rel_em_conv)
    out = torch.zeros_like(col_masks)
    starts = tasks.col_offsets.cpu().numpy()
    for b, (_, c) in enumerate(extents):
        out[b, :c] = fracs[starts[b] : starts[b] + c]
    return out


def _checked(device) -> torch.device:
    """``device`` as a torch.device; raises when it is CUDA and no CUDA
    device exists (never a fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        resolve_device("cuda")
    return device


def entry(device: Union[str, torch.device] = "cuda"):
    """(the EM callable, (probs (4, 64, 16), counts (4, 64), col_masks
    (4, 16)) in float64 on ``device``)."""
    device = _checked(device)
    return _em_forward, tuple(torch.from_numpy(a).to(device) for a in _example_batch())


@contextlib.contextmanager
def _env(**values):
    saved = {key: os.environ.get(key) for key in values}
    try:
        for key, value in values.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        autoshard.cache_clear()
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        autoshard.cache_clear()


def _sharded(device, n_devices, virtual):
    """The context of a leg on ``n_devices`` shards."""
    return autoshard.virtual_devices(device, n_devices) if virtual else contextlib.nullcontext()


def _one_shard():
    """The context of a leg on one device (the JAX package's switch)."""
    return _env(RPVG_TPU_AUTOSHARD="0")


def dryrun_multidevice(
    n_devices: int, device: Union[str, torch.device] = "cuda", virtual: bool = False
) -> Dict:
    """The multi-device dry run on ``n_devices`` data shards of
    ``device`` (counterpart of ``dryrun_multichip``): real devices, or
    with ``virtual=True`` n shards of ``device`` itself.  Raises
    :class:`DeviceUnavailableError` (before writing anything) when CUDA
    is asked for and missing, or fewer devices exist than asked for
    without ``virtual``.  Returns what it checked: per full-pipeline
    regime, whether every file was byte-identical to the one-shard run
    (on the CPU it must be; on CUDA a pair score's last bit may follow
    the batch cuBLAS is given, and then the files are held by
    ``compare.py``), and the giant clusters scored on the shards."""
    device = _checked(device)
    if not virtual:
        have = torch.cuda.device_count() if device.type == "cuda" else 1
        if have < n_devices:
            raise DeviceUnavailableError(
                f"dryrun_multidevice: {n_devices} {device.type} devices asked for, {have} "
                f"visible (pass virtual=True for {n_devices} shards of one device)"
            )
    from rpvg_tpu_torch.parallel.mesh import full_inference_step, make_mesh, psum_histogram

    with _sharded(device, n_devices, virtual):
        devices = autoshard.data_devices(device)
        if len(devices) < n_devices:
            raise DeviceUnavailableError(
                f"dryrun_multidevice: the data shards span {len(devices)} devices, need "
                f"{n_devices} (RPVG_TPU_AUTOSHARD=0?)"
            )
        devices = devices[:n_devices]
        model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
        mesh = make_mesh(devices, model=model)
        B = max(n_devices, 4)
        # The pair-scored path axis must divide the model axis.
        C = 8 * model + 1
        probs, counts, col_masks = _example_batch(B=B, R=32, C=C)
        inv_eff_lengths = np.full((B, C - 1), 1.0 / 100.0)
        noise = np.full(32, 0.01)
        log_freqs = np.zeros(C - 1)
        abundances, tpm, pair_ll = full_inference_step(mesh, max_em_its=50)(
            probs, counts, col_masks, inv_eff_lengths, noise, log_freqs
        )
        assert abundances.shape == (B, C) and torch.isfinite(abundances).all()
        assert np.isfinite(float(tpm))
        assert pair_ll.shape == (C - 1, C - 1)
        hist = psum_histogram(mesh)(np.ones((B, 16), dtype=np.float32))
        assert torch.equal(hist.cpu(), torch.full((16,), float(B)))

    _dryrun_batched_dispatches(n_devices, device, virtual)
    return _dryrun_full_pipeline(n_devices, device, virtual)


def _dryrun_batched_dispatches(n_devices: int, device: torch.device, virtual: bool) -> None:
    """The batched EM, read-count Gibbs and diploid posterior dispatches
    on the shards against one shard (the JAX package's dry run,
    ``__graft_entry__.py:102-179``): the EM and the Gibbs samples
    bitwise (each task and job is computed alone), the diploid groups
    identical and their posteriors within rtol 1e-10 (bitwise on the
    CPU).  The native CPU route is switched off so the plain versions
    shard too."""
    from rpvg_tpu_torch import prng
    from rpvg_tpu_torch.infer.batching import run_batched_em
    from rpvg_tpu_torch.infer.posteriors import diploid_posteriors_batched
    from rpvg_tpu_torch.infer.readcount_gibbs import run_batched_gibbs

    rng = np.random.default_rng(0)
    B = 2 * n_devices
    em_inputs = []
    for _ in range(B):
        R, C = 32, 9  # (R, P+1) noise-normalised cluster matrix
        probs = rng.random((R, C))
        probs /= probs.sum(axis=1, keepdims=True)
        counts = rng.integers(1, 6, size=R).astype(np.float64)
        em_inputs.append((probs, counts))
    gibbs_inputs = [
        (p, c, np.full(p.shape[1] - 1, 1.0 / (p.shape[1] - 1)), 0.5, float(c.sum()))
        for p, c in em_inputs
    ]
    keys = [prng.prng_key(i) for i in range(B)]
    dip_inputs = [(p[:, :-1], p[:, -1], c, [1] * (p.shape[1] - 1)) for p, c in em_inputs]

    def drive():
        return (
            run_batched_em(em_inputs, 100, 0.001, device),
            run_batched_gibbs(gibbs_inputs, keys, 4, 25, 1.0, device),
            diploid_posteriors_batched(dip_inputs, 1e-300, device),
        )

    with _env(RPVG_TPU_NATIVE_EM="0"):
        with _sharded(device, n_devices, virtual):
            assert autoshard.num_data_shards(device) >= n_devices
            sharded = drive()
        with _one_shard():
            single = drive()
    (s_em, s_gibbs, s_dip), (p_em, p_gibbs, p_dip) = sharded, single
    assert len(s_em) == len(s_gibbs) == len(s_dip) == B
    for (s_counts, s_noise), (p_counts, p_noise) in zip(s_em, p_em):
        assert np.array_equal(s_counts, p_counts) and s_noise == p_noise
    for s, p in zip(s_gibbs, p_gibbs):
        assert np.isfinite(s[1]).all() and all(np.array_equal(a, b) for a, b in zip(s, p))
    for (s_groups, s_post), (p_groups, p_post) in zip(s_dip, p_dip):
        assert s_groups == p_groups and np.isfinite(s_post).all()
        if device.type == "cpu":
            assert np.array_equal(s_post, p_post)
        np.testing.assert_allclose(s_post, p_post, rtol=1e-10, atol=0)


def _dryrun_full_pipeline(n_devices: int, device: torch.device, virtual: bool) -> Dict:
    """The whole pipeline (projection, clustering, probability matrices,
    batched inference with read-count Gibbs, writers) on the shards
    against one shard, in both scoring regimes (plain scores, and the
    reference's default quality-adjusted regime with sequencing errors),
    with ``-n 3 -b`` and the giant-cluster guard lowered
    (``RPVG_TPU_PAIR_TENSOR_LIMIT=256``) so that the giant-cluster shard
    route runs in the sharded leg: its execution is asserted.  The native
    CPU route is switched off so the plain versions shard too
    (``_dryrun_full_pipeline`` of the JAX package)."""
    import gzip
    import shutil
    import tempfile

    from rpvg_tpu_torch import sim
    from rpvg_tpu_torch.alignments import parse_multipath_alignment
    from rpvg_tpu_torch.compare import compare_estimate_files, compare_gibbs_files
    from rpvg_tpu_torch.pipeline import PipelineConfig, run_pipeline

    panel = sim.build_gene_panel(
        num_genes=12, isoforms_per_gene=4, num_haplotypes=4,
        exons_per_gene=6, exon_length=60, variant_sites=2, seed=5,
    )
    tmp = tempfile.mkdtemp(prefix="rpvg_torch_dryrun_")
    report = {"regimes": {}, "sharded_giant_clusters": 0}
    try:
        info_path = os.path.join(tmp, "info.tsv")
        panel.write_info_tsv(info_path)
        with _env(RPVG_TPU_NATIVE_EM="0", RPVG_TPU_PAIR_TENSOR_LIMIT="256"):
            for regime, with_errors in (("score", False), ("qual", True)):
                records, _ = sim.simulate_read_pairs(
                    panel, 600, read_length=60, frag_mean=150, frag_sd=12,
                    seed=9, abundances=sim.gene_abundances(panel, seed=3),
                    with_errors=with_errors, multipath_dag=with_errors,
                )
                alns = [
                    (parse_multipath_alignment(a), parse_multipath_alignment(b))
                    for a, b in zip(records[0::2], records[1::2])
                ]
                blobs = {}
                for label, leg in (("sharded", _sharded(device, n_devices, virtual)),
                                   ("single", _one_shard())):
                    prefix = os.path.join(tmp, f"out_{regime}_{label}")
                    with leg:
                        stats = run_pipeline(
                            PipelineConfig(
                                graph=panel.graph, paths=panel.paths_index,
                                alignments=alns, output_prefix=prefix,
                                inference_model="haplotype-transcripts",
                                path_info=info_path, threads=2, rng_seed=42,
                                score_not_qual=not with_errors,
                                frag_mean=150.0, frag_sd=12.0,
                                num_gibbs_samples=3, write_probs=True,
                            ),
                            device,
                        )
                    ran = stats["counters"].get("posteriors.sharded_pair_clusters", 0)
                    if label == "sharded":
                        assert ran > 0, (
                            f"the giant-cluster shard route never ran in the {regime} "
                            f"sharded leg"
                        )
                        report["sharded_giant_clusters"] += ran
                    else:
                        assert ran == 0
                    blobs[label] = {}
                    for sfx in (".txt", "_joint.txt", "_probs.txt.gz", "_gibbs.txt.gz"):
                        opener = gzip.open if sfx.endswith(".gz") else open
                        with opener(prefix + sfx, "rb") as handle:
                            blobs[label][sfx] = handle.read()
                identical = all(blob == blobs["single"][sfx] for sfx, blob in blobs["sharded"].items())
                if not identical:
                    if device.type != "cuda":
                        raise AssertionError(
                            f"the sharded pipeline's files differ from one shard's in the "
                            f"{regime} regime"
                        )
                    _hold_by_compare(tmp, regime, blobs, compare_estimate_files,
                                     compare_gibbs_files)
                report["regimes"][regime] = "byte-identical" if identical else "compare.py"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return report


def _hold_by_compare(tmp, regime, blobs, compare_estimate_files, compare_gibbs_files) -> None:
    """The CUDA fallback of the full-pipeline check: the estimate files
    equal under ``compare.py`` (identical rows, rtol 1e-6 / atol 1e-6),
    ``_probs.txt.gz`` (host output) byte-identical, the ``_gibbs.txt.gz``
    rows the same with every mean within 6 standard errors."""
    if blobs["sharded"]["_probs.txt.gz"] != blobs["single"]["_probs.txt.gz"]:
        raise AssertionError(f"_probs.txt.gz differs across shard counts in the {regime} regime")
    prefix = lambda label: os.path.join(tmp, f"out_{regime}_{label}")  # noqa: E731
    for sfx in (".txt", "_joint.txt"):
        compare_estimate_files(prefix("sharded") + sfx, prefix("single") + sfx, 1e-6, 1e-6)
    rep = compare_gibbs_files(prefix("sharded") + "_gibbs.txt.gz",
                              prefix("single") + "_gibbs.txt.gz", 6.0, same_rows=True)
    if rep["outside"] > max(4, rep["rows"] // 200):
        raise AssertionError(f"_gibbs.txt.gz differs across shard counts in the {regime} regime")
