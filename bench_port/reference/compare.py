"""Estimate files against the reference's rows.

The numbers compared, each the worst over every row of both files:

* ``rows_differ``: rows whose path name, ClusterID, Length or
  EffectiveLength (as printed) differ, or that one side lacks, and
  joint rows of another ClusterID (an exact comparison);
* ``hap_prob_gap``: the largest absolute gap of a haplotype
  probability (``HaplotypeProbability`` of the ``.txt``,
  ``HaplotypingProbability`` of the joint file; a joint row one side
  lacks counts with probability 0 there);
* ``read_count_gap``: the largest gap of a read count (either file,
  the ``Unknown`` rows included) over the larger of the reference's
  count and one read;
* ``tpm_gap``: the same for TPM, over the larger of the reference's TPM
  and the TPM of one read on that path.

The files print 8 significant digits, so a gap under about 5e-9 is
rounding."""

from __future__ import annotations

from typing import Dict, Tuple

from bench_port.reference.haplotype_transcripts import Expected


def read_txt(path: str):
    rows = {}
    unknown = None
    with open(path) as handle:
        header = handle.readline().rstrip("\n").split("\t")
        if header != ["Name", "ClusterID", "Length", "EffectiveLength", "HaplotypeProbability",
                      "ReadCount", "TPM"]:
            raise ValueError(f"{path}: unexpected header {header}")
        for line in handle:
            f = line.rstrip("\n").split("\t")
            if f[0] == "Unknown":
                unknown = float(f[5])
                continue
            rows[f[0]] = (int(f[1]), int(f[2]), f[3], float(f[4]), float(f[5]), float(f[6]))
    return rows, unknown


def read_joint(path: str, ploidy: int):
    rows = {}
    unknown = None
    with open(path) as handle:
        handle.readline()
        for line in handle:
            f = line.rstrip("\n").split("\t")
            names = tuple(n for n in f[:ploidy] if n != ".")
            rest = f[ploidy:]
            counts = [float(x) for x in rest[2::2]]
            tpms = [float(x) for x in rest[3::2]]
            if names and names[0] == "Unknown":
                unknown = counts
                continue
            rows[names] = (int(rest[0]), float(rest[1]), counts[: len(names)], tpms[: len(names)])
    return rows, unknown


def _count_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1.0)


def compare(prefix: str, want: Expected, ploidy: int) -> Dict[str, float]:
    """The numbers compared, for the files ``<prefix>.txt`` and
    ``<prefix>_joint.txt``."""
    rows, unknown = read_txt(prefix + ".txt")
    joint, unknown_joint = read_joint(prefix + "_joint.txt", ploidy)
    gaps = {"rows_differ": 0, "hap_prob_gap": 0.0, "read_count_gap": 0.0, "tpm_gap": 0.0}

    def worst(key, value):
        gaps[key] = max(gaps[key], value)

    # TPM of one read on a path, from the reference's own normaliser.
    one_read_tpm = {
        name: 1e6 / exp[2] / want.tpm_normaliser if exp[2] > 0 and want.tpm_normaliser > 0 else 0.0
        for name, exp in want.paths.items()
    }

    for name in set(rows) | set(want.paths):
        got, exp = rows.get(name), want.paths.get(name)
        if got is None or exp is None or got[:3] != (exp[0], exp[1], "%.8g" % exp[2]):
            gaps["rows_differ"] += 1
            continue
        worst("hap_prob_gap", abs(got[3] - exp[3]))
        worst("read_count_gap", _count_gap(got[4], exp[4]))
        unit = one_read_tpm[name]
        if unit > 0:
            worst("tpm_gap", abs(got[5] - exp[5]) / max(abs(exp[5]), unit))
        elif got[5] != exp[5]:
            gaps["tpm_gap"] = float("inf")
    worst("read_count_gap", _count_gap(unknown if unknown is not None else float("inf"), want.unknown))

    for names in set(joint) | set(want.joint):
        got, exp = joint.get(names), want.joint.get(names)
        worst("hap_prob_gap", abs((got[1] if got else 0.0) - (exp[1] if exp else 0.0)))
        if got is None or exp is None:
            continue
        if got[0] != exp[0]:
            gaps["rows_differ"] += 1
        for c_got, c_exp in zip(got[2], exp[2]):
            worst("read_count_gap", _count_gap(c_got, c_exp))
        for name, t_got, t_exp, c_exp in zip(names, got[3], exp[3], exp[2]):
            unit = one_read_tpm.get(name, 0.0) or 1.0
            worst("tpm_gap", abs(t_got - t_exp) / max(abs(t_exp), unit))
    if unknown_joint is None or len(unknown_joint) != len(want.unknown_joint):
        gaps["rows_differ"] += 1
    else:
        for c_got, c_exp in zip(unknown_joint, want.unknown_joint):
            worst("read_count_gap", _count_gap(c_got, c_exp))
    return {k: int(v) if k == "rows_differ" else float(v) for k, v in gaps.items()}


def write_estimates(rows: Expected, prefix: str, ploidy: int) -> None:
    """``rows`` as the port writes them (``<prefix>.txt``,
    ``<prefix>_joint.txt``, 8 significant digits): the control takes
    the program's place through these files."""
    def g(x):
        return "%.8g" % x

    with open(prefix + ".txt", "w") as out:
        out.write("Name\tClusterID\tLength\tEffectiveLength\tHaplotypeProbability\tReadCount\tTPM\n")
        for name, (cid, length, eff, hap, count, tpm) in rows.paths.items():
            out.write(f"{name}\t{cid}\t{length}\t{g(eff)}\t{g(hap)}\t{g(count)}\t{g(tpm)}\n")
        out.write(f"Unknown\t0\t0\t0\t0\t{g(rows.unknown)}\t0\n")
    with open(prefix + "_joint.txt", "w") as out:
        header = [f"Name_{i + 1}" for i in range(ploidy)] + ["ClusterID", "HaplotypingProbability"]
        for i in range(ploidy):
            header += [f"ReadCount_{i + 1}", f"TPM_{i + 1}"]
        out.write("\t".join(header) + "\n")
        for names, (cid, post, counts, tpms) in rows.joint.items():
            row = list(names) + ["."] * (ploidy - len(names)) + [str(cid), g(post)]
            for c, t in zip(counts, tpms):
                row += [g(c), g(t)]
            row += ["0", "0"] * (ploidy - len(names))
            out.write("\t".join(row) + "\n")
        row = ["Unknown"] * ploidy + ["0", "0"]
        for c in rows.unknown_joint:
            row += [g(c), "0"]
        out.write("\t".join(row) + "\n")


def judge(gaps: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {name: {"value": gaps[name], "limit": limits[name]} for name in limits}
    return all(gaps[name] <= limit for name, limit in limits.items()), checks
