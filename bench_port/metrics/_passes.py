"""Per-pass means of the pipeline's own timings (``run_pipeline``'s
``stats``, host clock; every phase boundary of the inference waits for
the device)."""


def mean(record, value) -> float:
    return sum(value(p) for p in record.passes) / len(record.passes)


def phases(record, *keys) -> float:
    return mean(record, lambda p: sum(p["phase_seconds"].get(k, 0.0) for k in keys))
