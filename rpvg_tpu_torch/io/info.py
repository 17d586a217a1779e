"""Haplotype/transcript info file parser (`vg rna --write-info` TSV),
plain or gzip/bgzip compressed.

Behavioural contract: reference parseHaplotypeTranscriptInfo
(reference/src/main.cpp:239-353).  Columns (new format):
Name, Length, Transcript, Haplotypes (comma-separated); the old format
carries an extra Reference column before Haplotypes, detected from the
header line.

The new-format fast path extracts the three used columns with ONE
whole-buffer split + stride slicing (the 68k-line whole-transcriptome
info file parses ~3x faster than a per-line split); any structural
irregularity (ragged rows, blank lines, CR line endings, old format)
falls back to the per-line loop with identical results.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Tuple

from ..probabilities import PathInfo

_EMPTY_FS = frozenset()


def _fast_columns(
    body: str, num_cols: int
) -> Optional[Tuple[List[str], List[str], List[str]]]:
    """(names, transcripts, haplotypes) via one split over the whole
    new-format body, or None when the layout is not perfectly uniform."""
    if not body or "\r" in body or "\n\n" in body:
        return None
    if body.endswith("\n"):
        body = body[:-1]
        if not body:
            return None
    num_rows = body.count("\n") + 1
    # The total-count check alone accepts ragged rows whose field counts
    # happen to balance (e.g. a 3-field row plus a 5-field row) and
    # silently column-shifts; every row must carry num_cols - 1 tabs.
    # (A whole-body tab count is implied by the flat count, so the check
    # has to be per row.)
    expected_tabs = num_cols - 1
    if any(line.count("\t") != expected_tabs for line in body.split("\n")):
        return None
    # Per-row tab uniformity forces the flat count, so no second check.
    flat = body.replace("\n", "\t").split("\t")
    return flat[0::num_cols], flat[2::num_cols], flat[3::num_cols]


def parse_haplotype_transcript_info(
    filename: str, parse_haplotype_ids: bool, use_transcript_names: bool
) -> Dict[str, PathInfo]:
    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "rt") as handle:
        header = handle.readline()
        body = handle.read()

    cols = header.rstrip("\n").split("\t")
    assert cols[0] == "Name", f"unexpected info header: {header!r}"
    is_old_format = "Reference" in header
    hap_field = 4 if is_old_format else 3

    transcript_id_index: Dict[str, int] = {}
    haplotype_id_index: Dict[str, int] = {}
    tid_setdefault = transcript_id_index.setdefault
    hid_setdefault = haplotype_id_index.setdefault

    # Haplotype strings repeat heavily across paths (the panel has far
    # fewer distinct haplotype sets than paths), so the id-set/count for
    # each distinct string is computed once.
    hap_cache: Dict[str, tuple] = {}
    hap_cache_get = hap_cache.get

    def hap_entry(haplotypes: str) -> tuple:
        # Cache miss only — the hit is the callers' inlined dict get.
        if parse_haplotype_ids:
            source_ids = frozenset(
                hid_setdefault(hap, len(haplotype_id_index))
                for hap in haplotypes.split(",")
            )
            cached = (source_ids, len(source_ids))
        else:
            cached = (_EMPTY_FS, haplotypes.count(",") + 1)
        hap_cache[haplotypes] = cached
        return cached

    fast = None if is_old_format or len(cols) != 4 else _fast_columns(body, 4)
    if fast is not None:
        names, transcripts, haps = fast
        infos = []
        append = infos.append
        for name, transcript, haplotypes in zip(names, transcripts, haps):
            # Match the fallback's .rstrip() on the haplotypes field so
            # trailing whitespace never mints a distinct haplotype id.
            haplotypes = haplotypes.rstrip()
            cached = hap_cache_get(haplotypes) or hap_entry(haplotypes)
            append(
                PathInfo(
                    transcript if use_transcript_names else name,
                    tid_setdefault(transcript, len(transcript_id_index)),
                    cached[1],
                    cached[0],
                )
            )
        info = dict(zip(names, infos))
        if len(info) != len(names):
            seen = set()
            for name in names:
                assert name not in seen, f"duplicate path name {name}"
                seen.add(name)
        return info

    info: Dict[str, PathInfo] = {}
    for line in body.split("\n"):
        fields = line.split("\t")
        if len(fields) <= hap_field:
            assert not line.strip(), f"malformed info line: {line!r}"
            continue
        name = fields[0]
        transcript = fields[2]
        haplotypes = fields[hap_field].rstrip()

        assert name not in info, f"duplicate path name {name}"
        cached = hap_cache_get(haplotypes) or hap_entry(haplotypes)
        info[name] = PathInfo(
            transcript if use_transcript_names else name,
            tid_setdefault(transcript, len(transcript_id_index)),
            cached[1],
            cached[0],
        )

    return info
