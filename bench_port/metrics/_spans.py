"""Per-pass means of the program's own spans (``rpvg_tpu_torch.spans``,
host clock): the window's runs are the program's last
``len(record.passes)`` finished runs, one ``run_pipeline`` call each."""


def self_mean(record, *names):
    """The self seconds of the spans ``names``, summed within a run and
    averaged over the window's runs; None where the program keeps no
    spans or a run lacks one of them."""
    try:
        from rpvg_tpu_torch import spans
    except ImportError:
        return None
    runs = spans.recent_runs(len(record.passes))
    if not runs:
        return None
    total = 0.0
    for run in runs:
        found = run["spans"]
        if any(name not in found for name in names):
            return None
        total += sum(found[name]["self_s"] for name in names)
    return total / len(runs)
