"""Nothing the benchmark runs loads jax or the JAX package, compared by
whole top-level module names (``rpvg_tpu_torch`` is not ``rpvg_tpu``),
and the reference loads nothing of the port either."""

import json
import subprocess
import sys
import textwrap

from bench_port.tests.conftest import DATA, ROOT

BLOCKER = textwrap.dedent("""
    import importlib.abc, json, sys
    BLOCKED = set(sys.argv[1].split(","))

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[2])
""")


def _run(body, blocked, *args, timeout=300):
    code = BLOCKER + textwrap.dedent(body) + textwrap.dedent("""
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    out = subprocess.run([sys.executable, "-c", code, ",".join(blocked), ROOT, *args],
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = _run("""
        import importlib, runpy
        from bench_port import harness, inputs, trace, bounds
        for m in harness.benchmark()["end_to_end"] + harness.benchmark()["per_layer"]:
            importlib.import_module("bench_port.metrics." + m["name"])
        import rpvg_tpu_torch.pipeline, rpvg_tpu_torch.ops.em_cuda, rpvg_tpu_torch.device
        runpy.run_path(sys.argv[2] + "/bench_port/run.py", run_name="bench_port_run")
    """, ["jax", "jaxlib", "flax", "rpvg_tpu"])
    assert not loaded & {"jax", "jaxlib", "flax", "rpvg_tpu"}
    assert "rpvg_tpu_torch" in loaded


def test_reference_loads_neither_jax_nor_the_port(tmp_path):
    loaded = _run("""
        import json, os
        from bench_port import inputs
        from bench_port.reference import compare, haplotype_transcripts as ht
        from bench_port.reference.fragment_pass import Workers
        inputs.CACHE_DIR = sys.argv[4]
        config = json.load(open(os.path.join(sys.argv[3], "configs", "tiny_diploid.json")))
        traffic = json.load(open(os.path.join(sys.argv[3], "traffic", "sample3k.json")))
        traffic["reads"]["pairs"] = 300
        files = inputs.prepare(config, traffic, 3)
        if __name__ == "__main__":
            with Workers(files, config["run"], 1) as pool:
                rows = ht.expected(ht.cluster(files, pool), config["run"], pool)
            assert rows.paths
    """, ["jax", "jaxlib", "flax", "rpvg_tpu", "rpvg_tpu_torch"], DATA, str(tmp_path))
    assert not loaded & {"jax", "jaxlib", "flax", "rpvg_tpu", "rpvg_tpu_torch", "torch"}


def test_reference_shares_no_module_with_the_generator_or_the_port():
    loaded = _run("""
        import importlib, pkgutil, bench_port.reference as ref
        for info in pkgutil.iter_modules(ref.__path__):
            importlib.import_module("bench_port.reference." + info.name)
        print(json.dumps(sorted(m for m in sys.modules if m.startswith("bench_port."))))
        sys.exit(0)
    """, ["jax", "jaxlib", "flax", "rpvg_tpu", "rpvg_tpu_torch", "torch"])
    assert "bench_port.reference.fragment_pass" in loaded
    assert not {m for m in loaded if m.startswith("bench_port.frozen")}
