"""Output writers: the six result file formats.

Column schemas and numeric formatting mirror the reference writers
(reference/src/threaded_output_writer.cpp): 8 significant digits
(C++ ostream setprecision semantics == printf %g), `Unknown` noise rows
absorbing unaligned reads, `.`-padded joint haplotype rows.
"""

from __future__ import annotations

import contextlib
import gzip
import math
import os
import queue
import threading
from typing import Dict, List, Optional, Sequence, TextIO

import numpy as np

from ..constants import OUT_PRECISION_DIGITS
from ..infer.estimates import PathClusterEstimates
from ..probabilities import PathInfo, ReadPathProbs


def fmt(value: float, digits: int = OUT_PRECISION_DIGITS) -> str:
    """C++ `ostream << setprecision(digits)` formatting.

    The float fast path is plain %g: for integral doubles below
    10**digits, %g prints the same digit string the int branch would
    (no exponent, no trailing point), so only int-typed inputs need it."""
    t = type(value)
    if t is float or t is np.float64:
        if value != value:
            return "nan"
        return "%.*g" % (digits, value)
    if value != value:
        return "nan"
    if isinstance(value, (int, np.integer)) or (
        isinstance(value, float) and value.is_integer() and abs(value) < 10**digits
    ):
        return str(int(value))
    return f"{value:.{digits}g}"


def fmt_array(values: np.ndarray, digits: int = OUT_PRECISION_DIGITS) -> np.ndarray:
    """Vectorised :func:`fmt` over a float array (C printf %g — the
    same algorithm CPython float formatting uses)."""
    return np.char.mod(f"%.{digits}g", np.asarray(values, dtype=np.float64))


def format_rows(
    prefixes: Sequence[str],
    columns: Sequence[np.ndarray],
    digits: int = OUT_PRECISION_DIGITS,
) -> Optional[str]:
    """'<prefix>\\t<num>...\\n' rows with every numeric cell %.<digits>g
    formatted — one native call (rpvg_format_rows) when the C++ library
    is present, else None (callers keep their numpy fallback).  snprintf
    %g and numpy's %g produce identical digit strings."""
    try:
        from ..native import format_rows_native
    except Exception:
        return None
    return format_rows_native(prefixes, columns, digits)


class AtomicTextHandle:
    """Crash-safe output file: bytes go to `<path>.tmp`, which is
    renamed over `path` only on a successful close.  A pipeline that
    dies mid-run therefore never leaves a partial, plausible-looking
    output — the reference never can (its writers only run after the
    unconditional host inference loop, src/threaded_output_writer.cpp),
    and an accelerator-backend failure must not make us worse.
    `discard()` abandons the tmp file (error path).

    With ``defer_publish=True`` a clean ``close()`` only STAGES the
    file (handle closed, tmp kept); the separate ``publish()`` call
    renames it.  The pipeline defers its early-closing writer-thread
    outputs this way so a later failure (e.g. in write_outputs) can
    still discard them — otherwise an output whose close was enqueued
    before the failure would already be published and un-removable."""

    def __init__(self, path: str, opener, defer_publish: bool = False):
        self.path = path
        self.tmp_path = path + ".tmp"
        self._handle = opener(self.tmp_path)
        self.write = self._handle.write  # hot path: direct delegation
        self._defer = defer_publish
        self._closed = False
        self._published = False
        self._discarded = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._handle.close()
        if not self._defer:
            self.publish()

    def publish(self) -> None:
        """Rename the staged tmp over the real name (idempotent; no-op
        after discard)."""
        if self._published or self._discarded:
            return
        if not self._closed:
            self.close()
            if not self._defer:
                return  # close() already published
        self._published = True
        os.replace(self.tmp_path, self.path)

    def discard(self) -> None:
        """Close WITHOUT publishing; remove the tmp file (no-op once
        published — the rename cannot be taken back here, callers sweep
        at a higher level)."""
        if self._discarded or self._published:
            return
        self._discarded = True
        if not self._closed:
            self._closed = True
            try:
                self._handle.close()
            except Exception:
                pass
        try:
            os.remove(self.tmp_path)
        except OSError:
            pass


class AsyncTextHandle:
    """Dedicated writer thread behind a bounded queue — the reference's
    ThreadedOutputWriter design (src/threaded_output_writer.cpp:8-37):
    gzip compression and disk writes run off the compute path (zlib
    releases the GIL while compressing).  `close()` drains and joins;
    `close_async()` enqueues the shutdown and returns immediately so the
    caller can overlap remaining compute, then `join()` before relying
    on the file.  Kill switch: RPVG_TPU_SYNC_WRITERS=1 (see _open)."""

    # Queue items are text chunks (typically one cluster block, ~1KB).
    # The capacity must comfortably exceed the block count of a large
    # run — a tight bound would stall the producer on gzip back-pressure
    # exactly where the overlap matters (blocks are enqueued BEFORE the
    # device half).  2^20 chunks of cluster-block size bounds buffered
    # text in the low GBs worst-case; real runs buffer megabytes.
    _MAX_CHUNKS = 1 << 20

    def __init__(self, handle: TextIO):
        self._handle = handle
        self._queue: queue.Queue = queue.Queue(maxsize=self._MAX_CHUNKS)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._drain, name="rpvg-writer", daemon=True
        )
        self._thread.start()

    def _drain(self) -> None:
        while True:
            chunk = self._queue.get()
            if chunk is None:
                break
            if chunk is _DISCARD:
                # Error-path shutdown: abandon instead of publishing.
                if self._exc is None:
                    self._exc = RuntimeError("writer discarded")
                break
            if self._exc is None:
                try:
                    self._handle.write(chunk)
                except BaseException as exc:  # re-raised on the caller side
                    self._exc = exc
        try:
            if self._exc is not None and hasattr(self._handle, "discard"):
                # A failed write stream must not rename a partial tmp
                # file over the real output (AtomicTextHandle).
                self._handle.discard()
            else:
                self._handle.close()
        except BaseException as exc:
            if self._exc is None:
                self._exc = exc

    def write(self, text: str) -> None:
        if self._exc is not None:
            raise self._exc
        self._queue.put(text)

    def close_async(self) -> None:
        self._queue.put(None)

    def discard(self) -> None:
        """Abandon the stream: the drain thread closes without
        publishing the tmp file (error-path shutdown).  Covers the
        drain-already-finished case too — after a ``close_async()`` the
        _DISCARD sentinel would land behind the close sentinel, so the
        underlying handle is discarded directly once the thread is
        joined (no-op when the handle already published, i.e. when it
        was not opened in deferred-publish mode)."""
        self._queue.put(_DISCARD)
        self._thread.join()
        if hasattr(self._handle, "discard"):
            try:
                self._handle.discard()
            except Exception:
                pass

    def publish(self) -> None:
        """Publish a deferred-publish underlying handle (join first so
        the staged tmp is complete)."""
        self.join()
        if hasattr(self._handle, "publish"):
            self._handle.publish()

    def join(self) -> None:
        self._thread.join()
        if self._exc is not None:
            raise self._exc

    def close(self) -> None:
        self.close_async()
        self.join()


# Sentinel enqueue that tells the drain thread to abandon the file.
_DISCARD = object()


def _handle_close_async(handle) -> None:
    """Start closing a writer handle without blocking (plain handles
    close immediately; AsyncTextHandle enqueues its shutdown)."""
    if isinstance(handle, AsyncTextHandle):
        handle.close_async()
    else:
        handle.close()


def _handle_join(handle) -> None:
    if isinstance(handle, AsyncTextHandle):
        handle.join()


def _handle_discard(handle) -> None:
    """Error-path shutdown: close without publishing (no partial
    outputs on disk), swallowing secondary failures."""
    try:
        if hasattr(handle, "discard"):
            handle.discard()
        else:
            handle.close()
    except Exception:
        pass


@contextlib.contextmanager
def atomic_open(path: str):
    """`with atomic_open(p) as h:` — crash-safe plain-text output: the
    body writes to `<p>.tmp`; a clean exit renames it over `p`, an
    exception abandons the tmp file (used by the native output
    composers in pipeline.py)."""
    handle = AtomicTextHandle(path, lambda p: open(p, "w"))
    try:
        yield handle
    except BaseException:
        handle.discard()
        raise
    handle.close()


def _open(path: str, async_ok: bool = False, defer_publish: bool = False):
    # Every output is written via AtomicTextHandle: `<path>.tmp` renamed
    # over `path` on successful close, so a mid-run crash never leaves a
    # partial output file under the real name.
    if path.endswith(".gz"):
        # BGZF blocks, matching the reference's HTSlib-compressed outputs
        # (src/threaded_output_writer.cpp:10): plain-gzip-readable but
        # blocked + EOF-marked.  Level 6 (zlib default): ~3x faster than
        # gzip-module default 9 for a few percent larger files.
        # Compression runs on a writer thread (AsyncTextHandle) unless
        # RPVG_TPU_SYNC_WRITERS=1.  RPVG_TPU_PLAIN_GZIP=1 kill switch.
        if os.environ.get("RPVG_TPU_PLAIN_GZIP") == "1":
            opener = lambda p: gzip.open(p, "wt", compresslevel=6)  # noqa: E731
        else:
            from .bgzf import BgzfTextWriter

            opener = lambda p: BgzfTextWriter(p, compresslevel=6)  # noqa: E731
        handle = AtomicTextHandle(path, opener, defer_publish=defer_publish)
        if async_ok and os.environ.get("RPVG_TPU_SYNC_WRITERS") != "1":
            return AsyncTextHandle(handle)
        return handle
    return AtomicTextHandle(path, lambda p: open(p, "w"), defer_publish=defer_publish)


class ProbabilityClusterWriter:
    """<prefix>_probs.txt.gz: '#'-delimited clusters with a path header
    line then `count noise prob:ids...` rows (reference :40-95)."""

    def __init__(self, prefix: str, prob_precision: float,
                 defer_publish: bool = False):
        self.handle = _open(prefix + ".txt.gz", async_ok=True,
                            defer_publish=defer_publish)
        self.digits = max(OUT_PRECISION_DIGITS, math.ceil(-math.log10(prob_precision)))

    def add_cluster(
        self, cluster_probs: Sequence[ReadPathProbs], cluster_paths: Sequence[PathInfo]
    ) -> None:
        block = format_probability_cluster_block(
            cluster_probs, cluster_paths, self.digits
        )
        if block:
            self.handle.write(block)

    def add_block(self, block: str) -> None:
        """Write a pre-formatted cluster block (native '-b' fast path)."""
        if block:
            self.handle.write(block)

    def close(self):
        self.handle.close()

    def close_async(self):
        """Start shutting down without blocking; `join()` before relying
        on the file (no-op split when the handle is synchronous)."""
        _handle_close_async(self.handle)

    def join(self):
        _handle_join(self.handle)

    def discard(self):
        """Error-path shutdown: abandon the file instead of publishing a
        partial probability listing."""
        _handle_discard(self.handle)

    def publish(self):
        """Publish a deferred-publish handle (join + rename)."""
        if hasattr(self.handle, "publish"):
            self.handle.publish()


def probability_block_header(cluster_paths: Sequence[PathInfo]) -> str:
    """The '#' delimiter + path header line of a probability block."""
    return (
        "#\n"
        + " ".join(
            f"{p.name},{p.length},{fmt(p.effective_length)}" for p in cluster_paths
        )
        + "\n"
    )


def format_probability_cluster_block(
    cluster_probs: Sequence[ReadPathProbs],
    cluster_paths: Sequence[PathInfo],
    digits: int,
) -> str:
    """One cluster's '#'-delimited probability block as text — shared by
    the in-process writer and the distributed runner (which formats on
    the owning process and ships blocks to process 0, reference
    src/threaded_output_writer.cpp:40-95)."""
    if not cluster_probs:
        return ""
    out = ["#"]
    out.append(
        " ".join(
            f"{p.name},{p.length},{fmt(p.effective_length)}" for p in cluster_paths
        )
    )
    for rpp in cluster_probs:
        row = [str(rpp.read_count), fmt(rpp.noise_prob, digits)]
        for prob, ids in rpp.path_probs:
            row.append(f"{fmt(prob, digits)}:" + ",".join(map(str, ids)))
        out.append(" ".join(row))
    return "\n".join(out) + "\n"


class ReadCountGibbsSamplesWriter:
    """<prefix>_gibbs.txt.gz: Name ClusterID ReadCountSample_i columns
    with zero-fill for unsampled subsets and a trailing `Unknown` noise
    row (reference :98-230)."""

    def __init__(self, prefix: str, num_gibbs_samples: int,
                 defer_publish: bool = False):
        self.handle = _open(prefix + ".txt.gz", async_ok=True,
                            defer_publish=defer_publish)
        self.num_samples = num_gibbs_samples
        self.noise_counts = np.zeros(num_gibbs_samples, dtype=np.float64)
        header = ["Name", "ClusterID"] + [
            f"ReadCountSample_{i + 1}" for i in range(num_gibbs_samples)
        ]
        self.handle.write("\t".join(header) + "\n")

    def add_samples(self, cluster_id: int, estimates: PathClusterEstimates) -> None:
        if not estimates.gibbs_read_count_samples:
            self.noise_counts += estimates.total_count
            return
        if not hasattr(self, "_prefixes"):
            self._prefixes: List[str] = []
            self._vecs: List[np.ndarray] = []

        # Per path: which sample-subset carries it, at which column; and
        # the sample-column window each subset occupies.
        path_sampling_index: Dict[int, Dict[int, int]] = {}
        col_starts: List[int] = []
        noise_idx = 0
        for s, samples in enumerate(estimates.gibbs_read_count_samples):
            col_starts.append(noise_idx)
            for noise_sample in samples.noise_samples:
                self.noise_counts[noise_idx] += noise_sample
                noise_idx += 1
            for j, pid in enumerate(samples.path_ids):
                path_sampling_index.setdefault(pid, {})[s] = j
        while noise_idx < self.num_samples:
            self.noise_counts[noise_idx] += estimates.total_count
            noise_idx += 1

        mats = [
            np.asarray(samples.abundance_samples, dtype=np.float64).reshape(
                len(samples.noise_samples), len(samples.path_ids)
            )
            if samples.path_ids
            else None
            for samples in estimates.gibbs_read_count_samples
        ]
        cid = str(cluster_id)
        for pid in sorted(path_sampling_index):
            vec = np.zeros(self.num_samples, dtype=np.float64)
            for s, j in path_sampling_index[pid].items():
                n_here = mats[s].shape[0]
                vec[col_starts[s] : col_starts[s] + n_here] = mats[s][:, j]
            self._prefixes.append(f"{estimates.paths[pid].name}\t{cid}")
            self._vecs.append(vec)

    def finish(self, unaligned_read_count: int) -> None:
        self.finish_async(unaligned_read_count)
        self.join()

    def finish_async(self, unaligned_read_count: int) -> None:
        """Enqueue all remaining writes and the close, returning without
        waiting for compression; `join()` before relying on the file."""
        # All sample values format in one native pass (unsampled slots
        # are zeros — %g prints them as '0', like the explicit fill).
        if getattr(self, "_prefixes", None):
            mat = np.vstack(self._vecs)
            text = format_rows(
                self._prefixes, [mat[:, k] for k in range(self.num_samples)]
            )
            if text is None:
                text = "".join(
                    prefix + "\t" + "\t".join(fmt(float(v)) for v in vec) + "\n"
                    for prefix, vec in zip(self._prefixes, self._vecs)
                )
            self.handle.write(text)
        row = ["Unknown", "0"] + [
            fmt(c + unaligned_read_count) for c in self.noise_counts
        ]
        self.handle.write("\t".join(row) + "\n")
        _handle_close_async(self.handle)

    def close_async(self) -> None:
        """Shutdown without the finish() rows (error-path cleanup)."""
        _handle_close_async(self.handle)

    def join(self) -> None:
        _handle_join(self.handle)

    def discard(self) -> None:
        """Error-path shutdown: abandon the file instead of publishing a
        sample table missing its rows and Unknown trailer."""
        _handle_discard(self.handle)

    def publish(self) -> None:
        """Publish a deferred-publish handle (join + rename)."""
        if hasattr(self.handle, "publish"):
            self.handle.publish()


class JointHaplotypeEstimatesWriter:
    """<prefix>.txt for the haplotypes model: Name_1..Name_ploidy
    ClusterID HaplotypingProbability (reference :233-280)."""

    def __init__(self, prefix: str, ploidy: int, min_posterior: float):
        self.handle = _open(prefix + ".txt")
        self.ploidy = ploidy
        self.min_posterior = min_posterior
        header = [f"Name_{i + 1}" for i in range(ploidy)] + ["ClusterID", "HaplotypingProbability"]
        self.handle.write("\t".join(header) + "\n")

    def add_estimates(self, cluster_id: int, estimates: PathClusterEstimates) -> None:
        for group_set, posterior in zip(estimates.path_group_sets, estimates.posteriors):
            if posterior < self.min_posterior:
                continue
            names = [estimates.paths[p].name for p in group_set]
            names += ["."] * (self.ploidy - len(group_set))
            self.handle.write(
                "\t".join(names + [str(cluster_id), fmt(posterior)]) + "\n"
            )

    def close(self):
        self.handle.close()


class AbundanceEstimatesWriter:
    """<prefix>.txt: Name ClusterID Length EffectiveLength ReadCount TPM
    (reference :283-343)."""

    def __init__(self, prefix: str, total_transcript_count: float):
        self.handle = _open(prefix + ".txt")
        self.total_transcript_count = total_transcript_count
        self.noise_count = 0.0
        self.handle.write("Name\tClusterID\tLength\tEffectiveLength\tReadCount\tTPM\n")

    def add_estimates(self, cluster_id: int, estimates: PathClusterEstimates) -> None:
        if not estimates.path_group_sets:
            self.noise_count += estimates.noise_count
            return
        firsts = [g[0] for g in estimates.path_group_sets]
        effs = np.array(
            [estimates.paths[p].effective_length for p in firsts], dtype=np.float64
        )
        counts = np.asarray(estimates.abundances, dtype=np.float64)[: len(firsts)]
        cid = str(cluster_id)
        if not hasattr(self, "_rows"):
            self._rows = []
            self._effs = []
            self._counts = []
        for path in firsts:
            info = estimates.paths[path]
            self._rows.append(f"{info.name}\t{cid}\t{info.length}")
        self._effs.append(effs)
        self._counts.append(counts)
        self.noise_count += estimates.noise_count

    def finish(self, unaligned_read_count: int) -> None:
        # Numeric columns are buffered per cluster and formatted in one
        # vectorised pass — per-cluster np.char.mod dispatch dominated
        # the output phase at benchmark scale.
        if getattr(self, "_rows", None):
            effs = np.concatenate(self._effs)
            counts = np.concatenate(self._counts)
            with np.errstate(divide="ignore", invalid="ignore"):
                tpms = np.where(
                    effs > 0, counts / effs / self.total_transcript_count * 1e6, 0.0
                )
            text = format_rows(self._rows, [effs, counts, tpms])
            if text is None:
                eff_s, count_s, tpm_s = fmt_array(effs), fmt_array(counts), fmt_array(tpms)
                text = "".join(
                    f"{head}\t{e}\t{c}\t{t}\n"
                    for head, e, c, t in zip(self._rows, eff_s, count_s, tpm_s)
                )
            self.handle.write(text)
        self.handle.write(
            f"Unknown\t0\t0\t0\t{fmt(self.noise_count + unaligned_read_count)}\t0\n"
        )
        self.handle.close()


class HaplotypeAbundanceEstimatesWriter:
    """<prefix>.txt for haplotype-transcripts: adds HaplotypeProbability,
    marginalising group sets per path (reference :346-432)."""

    def __init__(self, prefix: str, ploidy: int, total_transcript_count: float):
        self.handle = _open(prefix + ".txt")
        self.ploidy = ploidy
        self.total_transcript_count = total_transcript_count
        self.noise_count = 0.0
        self.handle.write(
            "Name\tClusterID\tLength\tEffectiveLength\tHaplotypeProbability\tReadCount\tTPM\n"
        )

    def add_estimates(self, cluster_id: int, estimates: PathClusterEstimates) -> None:
        # Buffer only references; the group-set marginalisation and all
        # numeric work run in ONE vectorised pass at finish.
        if not hasattr(self, "_rows"):
            self._rows = []
            self._buf = []
            self._total_paths = 0
        cid = str(cluster_id)
        for info in estimates.paths:
            self._rows.append(f"{info.name}\t{cid}\t{info.length}")
        self._buf.append((self._total_paths, estimates))
        self._total_paths += len(estimates.paths)
        self.noise_count += estimates.noise_count

    def finish(self, unaligned_read_count: int) -> None:
        # Buffered columns formatted in one vectorised pass (see
        # AbundanceEstimatesWriter.finish).  Marginalisation semantics
        # per set: every slot's abundance adds to its path; the
        # posterior adds once per distinct path (slots are sorted, so
        # "first or different from previous" marks distinct).
        if getattr(self, "_rows", None):
            buf = self._buf
            effs = np.fromiter(
                (p.effective_length for _, est in buf for p in est.paths),
                np.float64, self._total_paths,
            )
            ab_idx = np.fromiter(
                (
                    base + p
                    for base, est in buf
                    for gs in est.path_group_sets
                    for p in gs
                ),
                np.int64,
            )
            ab_vals = np.fromiter(
                (a for _, est in buf for a in est.abundances), np.float64,
                ab_idx.size,
            )
            hap_pairs = [
                (base + p, post)
                for base, est in buf
                for gs, post in zip(est.path_group_sets, est.posteriors)
                for j, p in enumerate(gs)
                if j == 0 or p != gs[j - 1]
            ]
            read_counts = np.zeros(self._total_paths)
            np.add.at(read_counts, ab_idx, ab_vals)
            hap_probs = np.zeros(self._total_paths)
            if hap_pairs:
                hp = np.asarray(hap_pairs, dtype=np.float64)
                np.add.at(hap_probs, hp[:, 0].astype(np.int64), hp[:, 1])
            with np.errstate(divide="ignore", invalid="ignore"):
                tpms = np.where(
                    effs > 0,
                    read_counts / effs / self.total_transcript_count * 1e6,
                    0.0,
                )
            text = format_rows(self._rows, [effs, hap_probs, read_counts, tpms])
            if text is None:
                eff_s = fmt_array(effs)
                hap_s = fmt_array(hap_probs)
                count_s = fmt_array(read_counts)
                tpm_s = fmt_array(tpms)
                text = "".join(
                    f"{head}\t{e}\t{h}\t{c}\t{t}\n"
                    for head, e, h, c, t in zip(
                        self._rows, eff_s, hap_s, count_s, tpm_s
                    )
                )
            self.handle.write(text)
        self.handle.write(
            f"Unknown\t0\t0\t0\t0\t{fmt(self.noise_count + unaligned_read_count)}\t0\n"
        )
        self.handle.close()


class JointHaplotypeAbundanceEstimatesWriter:
    """<prefix>_joint.txt: per-group-set rows with per-slot
    ReadCount/TPM columns (reference :434-546)."""

    def __init__(self, prefix: str, ploidy: int, min_posterior: float, total_transcript_count: float):
        self.handle = _open(prefix + ".txt")
        self.ploidy = ploidy
        self.min_posterior = min_posterior
        self.total_transcript_count = total_transcript_count
        self.noise_counts = np.zeros(ploidy)
        header = [f"Name_{i + 1}" for i in range(ploidy)]
        header += ["ClusterID", "HaplotypingProbability"]
        for i in range(ploidy):
            header += [f"ReadCount_{i + 1}", f"TPM_{i + 1}"]
        self.handle.write("\t".join(header) + "\n")

    def add_estimates(self, cluster_id: int, estimates: PathClusterEstimates) -> None:
        # Buffer per-set references; numeric formatting happens in one
        # vectorised pass at finish.
        if not hasattr(self, "_buf"):
            self._buf = []  # (names, cid, posterior, counts, effs)
        abundance_it = iter(estimates.abundances)
        cid = str(cluster_id)
        for group_set, posterior in zip(estimates.path_group_sets, estimates.posteriors):
            slot_counts = [next(abundance_it) for _ in group_set]
            if posterior < self.min_posterior:
                continue
            infos = [estimates.paths[p] for p in group_set]
            self._buf.append(
                (
                    [info.name for info in infos],
                    cid,
                    posterior,
                    slot_counts,
                    [info.effective_length for info in infos],
                )
            )
        self.noise_counts += estimates.noise_count / self.noise_counts.size

    def finish(self, unaligned_read_count: int) -> None:
        buf = getattr(self, "_buf", [])
        if buf:
            posts = fmt_array(np.fromiter((b[2] for b in buf), np.float64, len(buf)))
            counts = np.fromiter(
                (c for b in buf for c in b[3]), np.float64
            )
            effs = np.fromiter((e for b in buf for e in b[4]), np.float64, counts.size)
            with np.errstate(divide="ignore", invalid="ignore"):
                tpms = np.where(
                    effs > 0, counts / effs / self.total_transcript_count * 1e6, 0.0
                )
            count_s = fmt_array(counts)
            tpm_s = fmt_array(tpms)
            pad = self.ploidy
            pieces = []
            k = 0
            for (names, cid, _, slot_counts, _), post_s in zip(buf, posts):
                row = names + ["."] * (pad - len(names)) + [cid, post_s]
                for _ in slot_counts:
                    row.append(count_s[k])
                    row.append(tpm_s[k])
                    k += 1
                for _ in range(pad - len(slot_counts)):
                    row += ["0", "0"]
                pieces.append("\t".join(row))
            pieces.append("")
            self.handle.write("\n".join(pieces))
        row = ["Unknown"] * self.ploidy + ["0", "0"]
        for noise in self.noise_counts:
            row += [fmt(noise + unaligned_read_count / self.noise_counts.size), "0"]
        self.handle.write("\t".join(row) + "\n")
        self.handle.close()
