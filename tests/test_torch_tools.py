"""The port's input-conversion tools (``python -m rpvg_tpu_torch.tools``)
against the JAX package's: ``json-to-rpa`` writes the same ``.rpa``
bytes, with ``jax`` and ``rpvg_tpu`` blocked (the card's host has no
jax), and ``gamp-to-json`` decodes a binary ``.gamp`` into the same
lines."""

import os
import subprocess
import sys

import pytest

from rpvg_tpu import sim
from rpvg_tpu import tools as ref_tools
from rpvg_tpu.io.gam import write_gam_dicts
from rpvg_tpu_torch import tools

from test_torch_slice import REPO

_NO_JAX_TOOL = r"""
import importlib.machinery, sys

BLOCKED = ("jax", "jaxlib", "rpvg_tpu")

class NoJax(importlib.machinery.PathFinder):
    @classmethod
    def find_spec(cls, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            return None
        return importlib.machinery.PathFinder.find_spec(name, path, target)

sys.meta_path = [NoJax if f is importlib.machinery.PathFinder else f for f in sys.meta_path]
import runpy
sys.argv = ["rpvg_tpu_torch.tools", *sys.argv[1:]]
try:
    runpy.run_module("rpvg_tpu_torch.tools", run_name="__main__")
except SystemExit as stop:
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NO_JAX_OK", stop.code)
    raise
"""


def _records(tmp_path, multipath):
    panel = sim.build_gene_panel(
        num_genes=6, isoforms_per_gene=3, num_haplotypes=4,
        exons_per_gene=5, exon_length=100, variant_sites=3, seed=71,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 400, read_length=80, frag_mean=200, frag_sd=20, seed=73,
        abundances=sim.gene_abundances(panel, seed=79), as_multipath=multipath,
        multipath_dag=multipath, with_qualities=True,
    )
    return records


def _read(path):
    with open(path, "rb") as handle:
        return handle.read()


@pytest.mark.parametrize(
    "flags", [(), ("--single-path", "--single-end")], ids=["multipath-pairs", "single-path-single-end"]
)
def test_json_to_rpa_with_jax_blocked_writes_reference_bytes(flags, tmp_path):
    records = _records(tmp_path, multipath=not flags)
    src = str(tmp_path / "aln.json")
    sim.write_alignment_json(records, src)
    ref_out, port_out = str(tmp_path / "ref.rpa"), str(tmp_path / "port.rpa")
    assert ref_tools.main(["json-to-rpa", src, ref_out, *flags]) == 0
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_TOOL, "json-to-rpa", src, port_out, *flags],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=REPO),
        cwd=str(tmp_path), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK 0" in proc.stdout
    assert os.path.getsize(ref_out) > 10000
    assert _read(port_out) == _read(ref_out)


@pytest.mark.parametrize("multipath", [True, False], ids=["gamp", "gam-single-path"])
def test_gamp_to_json_matches_reference_lines(multipath, tmp_path):
    records = _records(tmp_path, multipath=multipath)
    src = str(tmp_path / ("aln.gamp" if multipath else "aln.gam"))
    write_gam_dicts(src, records, is_multipath=multipath)
    flags = () if multipath else ("--single-path",)
    ref_out, port_out = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    assert ref_tools.main(["gamp-to-json", src, ref_out, *flags]) == 0
    assert tools.main(["gamp-to-json", src, port_out, *flags]) == 0
    port_lines = _read(port_out).splitlines()
    assert len(port_lines) == len(records)
    assert port_lines == _read(ref_out).splitlines()
