"""One cell of the port's benchmark: set-up, the measured window, the
traced run's readings, the check against the plain reference and the
result line.

Everything the harness runs is found by name:

* ``configs/<config>.json``: the deployment (pantranscriptome and run
  settings) and the reference module that judges it;
* ``traffic/<traffic>.json``: the sample's reads and expression profile,
  and options added to the run;
* ``limits/<config>.<traffic>.json``: the limit of each number compared;
* ``metrics/<metric>.py``: one reader per metric of ``BENCHMARK.json``,
  ``read(record)`` returning a number or None.

The window drives ``rpvg_tpu_torch.pipeline.run_pipeline`` once per
pass, each pass reading the sample's ``.rpa`` and writing every estimate
file under a fresh prefix; the graph and path index stay resident (the
loaded objects go into the pipeline's configuration) with the built
kernels.  The window ends with the pass that crosses ``--seconds``.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
BANNED_MODULES = ("jax", "jaxlib", "flax", "rpvg_tpu")
REFERENCE_WORKERS = 7


def load_json(path: str) -> dict:
    with open(path) as handle:
        return json.load(handle)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclass
class Cell:
    workload: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    chips: int = 1


def find_cell(workload: str, bench: Optional[dict] = None, base: str = BENCH_DIR) -> Cell:
    """The cell ``<config>.<traffic>`` from its files under ``base``."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"{workload}: no such workload in BENCHMARK.json")
    config = load_json(os.path.join(base, "configs", entry["config"] + ".json"))
    traffic = load_json(os.path.join(base, "traffic", entry["traffic"] + ".json"))
    limits = load_json(os.path.join(base, "limits", workload + ".json"))["limits"]
    return Cell(workload, config, traffic, limits, int(entry["chips"]))


def metric_names(bench: dict, workload: str, traced: bool) -> List[tuple]:
    """(name, unit) of the metrics a run of the cell reports: its
    end-to-end metrics untraced, its per-layer metrics traced."""
    out = []
    for m in bench["per_layer" if traced else "end_to_end"]:
        if workload in m.get("workloads", [workload]):
            out.append((m["name"], m["unit"]))
    return out


@dataclass
class Record:
    """What a run measured; the metric readers read it."""

    setup_s: float
    load_s: float
    window_s: float
    pairs: int                       # read pairs of all passes of the window
    passes: List[dict]               # per pass: the pipeline's timings
    window_peak_bytes: int
    trace: Optional[object] = None   # trace.TraceSummary of a traced run
    em_launches: List[tuple] = field(default_factory=list)  # (task shapes, iterations)


def read_metric(name: str, record: Record) -> Optional[float]:
    return importlib.import_module(f"bench_port.metrics.{name}").read(record)


def pipeline_config(cell: Cell, files: Dict[str, str], graph, paths_index):
    """The pipeline's configuration of the cell, with the resident graph
    and path index in place of their files."""
    from rpvg_tpu_torch.pipeline import PipelineConfig

    run = cell.config["run"]
    options = {**run.get("options", {}), **cell.traffic.get("options", {})}
    return PipelineConfig(
        graph=graph, paths=paths_index, alignments=files["reads"],
        inference_model=run["inference_model"], threads=run["threads"],
        rng_seed=run["rng_seed"], score_not_qual=run["score_not_qual"],
        path_info=files["info"], ploidy=run["ploidy"], min_hap_prob=run["min_hap_prob"],
        max_em_its=run["max_em_its"], max_rel_em_conv=run["max_rel_em_conv"], **options,
    )


PASS_KEYS = ("fragment_pass_seconds", "matrix_seconds", "output_seconds", "wall_seconds",
             "em_tasks", "num_fragment_lists", "num_clusters")


def run_pass(pconfig, device, prefix: str) -> dict:
    """One pass of the pipeline; its timings, without the estimates."""
    from rpvg_tpu_torch.pipeline import run_pipeline

    stats = run_pipeline(replace(pconfig, output_prefix=prefix), device)
    kept = {key: stats[key] for key in PASS_KEYS if key in stats}
    kept["phase_seconds"] = dict(stats.get("phase_seconds", {}))
    return kept


# Calls into each layer that a traced run wraps in a span of its own:
# (module, attribute, span name).
LAYER_SPANS = (
    ("rpvg_tpu_torch.pipeline", "build_finder", "bench.build_finder"),
    ("rpvg_tpu_torch.pipeline", "collect_fragments", "bench.fragment_pass"),
    ("rpvg_tpu_torch.pipeline", "run_inference_phases", "bench.inference"),
    ("rpvg_tpu_torch.pipeline", "build_cluster_matrices_columnar", "bench.cluster_matrices"),
    ("rpvg_tpu_torch.pipeline", "write_outputs", "bench.outputs"),
    ("rpvg_tpu_torch.infer.batched_models", "native_subset_collapse_multi", "bench.subset_matrices"),
    ("rpvg_tpu_torch.infer.batched_models", "_group_posteriors_batched", "bench.posteriors"),
    ("rpvg_tpu_torch.infer.batched_models", "run_batched_em_packed", "bench.em"),
    ("rpvg_tpu_torch.infer.batched_models", "_nested_gibbs", "bench.gibbs"),
)


def install_spans(spans=LAYER_SPANS) -> Callable[[], None]:
    """Wrap each call of ``spans`` in ``torch.profiler.record_function``;
    returns the function that puts the originals back."""
    import torch

    undo = []
    for module_name, attribute, span in spans:
        module = importlib.import_module(module_name)
        original = getattr(module, attribute)

        def wrapped(*args, _original=original, _span=span, **kwargs):
            with torch.profiler.record_function(_span):
                return _original(*args, **kwargs)

        setattr(module, attribute, wrapped)
        undo.append((module, attribute, original))

    def restore():
        for module, attribute, original in undo:
            setattr(module, attribute, original)

    return restore


class EmLaunchRecorder:
    """Wraps ``em_cuda.em_fixed_point``: while ``on``, keeps each call's
    task shapes and the iterations it returned (a device tensor, read
    after the window)."""

    def __init__(self):
        from rpvg_tpu_torch.ops import em_cuda

        self.module = em_cuda
        self.original = em_cuda.em_fixed_point
        self.on = False
        self.launches: List[tuple] = []

        def recorded(tasks, max_em_its, max_rel_em_conv):
            fracs, iters = self.original(tasks, max_em_its, max_rel_em_conv)
            if self.on:
                self.launches.append((tasks.shapes.copy(), iters))
            return fracs, iters

        em_cuda.em_fixed_point = recorded

    def results(self) -> List[tuple]:
        return [(shapes, iters.cpu().numpy()) for shapes, iters in self.launches]

    def restore(self) -> None:
        self.module.em_fixed_point = self.original


def output_digest(prefix: str, suffixes) -> str:
    digest = hashlib.sha256()
    for suffix in suffixes:
        with open(prefix + suffix, "rb") as handle:
            digest.update(handle.read())
    return digest.hexdigest()


def check_outputs(cell: Cell, files: Dict[str, str], prefixes: List[str],
                  workers: int = REFERENCE_WORKERS):
    """(correct, {number: {"value", "limit"}}, passes whose files fail):
    every pass's estimate files against the plain reference, each
    distinct content compared once."""
    from bench_port.reference import compare

    reference = importlib.import_module(f"bench_port.reference.{cell.config['reference']}")
    ploidy = int(cell.config["run"]["ploidy"])
    by_digest: Dict[str, List[str]] = {}
    for prefix in prefixes:
        by_digest.setdefault(output_digest(prefix, (".txt", "_joint.txt")), []).append(prefix)
    want = expected_rows(cell, files, reference, workers)
    worst = None
    failed = 0
    for group in by_digest.values():
        gaps = compare.compare(group[0], want, ploidy)
        ok, _ = compare.judge(gaps, cell.limits)
        failed += 0 if ok else len(group)
        worst = gaps if worst is None else {k: max(worst[k], gaps[k]) for k in gaps}
    correct, checks = compare.judge(worst, cell.limits)
    return correct and failed == 0, checks, failed


def _code_digest(*packages: str) -> str:
    digest = hashlib.sha256()
    for package in packages:
        directory = os.path.join(BENCH_DIR, package)
        for name in sorted(os.listdir(directory)):
            if name.endswith(".py"):
                with open(os.path.join(directory, name), "rb") as handle:
                    digest.update(name.encode() + handle.read())
    return digest.hexdigest()


def expected_rows(cell: Cell, files: Dict[str, str], reference, workers: int):
    """The reference's rows for these inputs: worked out on ``workers``
    processes, or read back from the cache where a run on the same panel,
    pool of pairs, settings and reference code left them."""
    import pickle

    from bench_port import inputs
    from bench_port.reference.fragment_pass import Workers

    # Keyed by the pool, not the sample: the rows do not follow the
    # order the pairs come in.
    key = hashlib.sha256(json.dumps(
        [os.path.basename(os.path.dirname(files["panel"])), os.path.basename(files["pool"]),
         cell.config["run"], cell.config["reference"], _code_digest("reference")],
        sort_keys=True).encode()).hexdigest()[:20]
    path = os.path.join(inputs.CACHE_DIR, f"expected-{key}.pickle")
    if os.path.exists(path):
        with open(path, "rb") as handle:
            log("reference rows from the cache")
            return pickle.load(handle)
    t0 = time.perf_counter()
    with Workers(files, cell.config["run"], workers) as pool:
        clusters = reference.cluster(files, pool)
        t1 = time.perf_counter()
        want = reference.expected(clusters, cell.config["run"], pool)
    log(f"reference: fragment pass and clusters {t1 - t0:.1f} s, estimates "
        f"{time.perf_counter() - t1:.1f} s")
    os.makedirs(inputs.CACHE_DIR, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=inputs.CACHE_DIR, delete=False) as handle:
        pickle.dump(want, handle)
    os.replace(handle.name, path)
    return want


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def stop_helpers() -> None:
    """Stop, and wait for, the process that ``multiprocessing`` starts to
    track the pools' semaphores (it would otherwise end only after this
    process has)."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def banned_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED_MODULES))


def log(message: str) -> None:
    print(f"[bench_port] {message}", file=sys.stderr, flush=True)


def run_window(run_once: Callable[[int], object], seconds: float,
               clock: Callable[[], float] = time.perf_counter):
    """Whole passes until one ends at or after ``seconds`` from the
    start: (what each pass returned, the seconds from the start to the
    end of the last pass)."""
    results = []
    t0 = clock()
    while True:
        results.append(run_once(len(results)))
        elapsed = clock() - t0
        if elapsed >= seconds:
            return results, elapsed


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             metrics: List[tuple], workers: int = REFERENCE_WORKERS) -> dict:
    """Set-up, window, readings and check of one run; the result line's
    object."""
    import torch

    from bench_port import inputs, trace
    from rpvg_tpu_torch.pipeline import PipelineConfig, load_inputs

    on_cuda = device.type == "cuda"
    files = inputs.prepare_apart(cell.config, cell.traffic, seed)
    t_load = time.perf_counter()
    graph, paths_index = load_inputs(PipelineConfig(graph=files["graph"], paths=files["panel"]))
    load_s = time.perf_counter() - t_load
    pconfig = pipeline_config(cell, files, graph, paths_index)
    out_dir = tempfile.mkdtemp(prefix="bench_port_out_")
    restore_spans = recorder = None
    try:
        if traced:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
            # A process's first profiler session costs seconds of set-up.
            with profile(activities=activities):
                torch.ones(1, device=device).add_(1)
            restore_spans = install_spans()
            recorder = EmLaunchRecorder()
        run_pass(pconfig, device, os.path.join(out_dir, "warm"))
        if on_cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s (panel load {load_s:.3f} s)")

        session = None
        if traced:
            session = profile(activities=activities)
            session.__enter__()
            recorder.on = True
        prefixes = []

        def one_pass(i):
            prefixes.append(os.path.join(out_dir, f"pass{i}"))
            with torch.profiler.record_function(trace.PASS_SPAN):
                return run_pass(pconfig, device, prefixes[-1])

        passes, window_s = run_window(one_pass, seconds)
        window_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
        summary = None
        if traced:
            recorder.on = False
            session.__exit__(None, None, None)
            trace_path = os.path.join(out_dir, "trace.json")
            session.export_chrome_trace(trace_path)
            summary = trace.summarize(trace.read_trace(trace_path))
            os.remove(trace_path)
            del session
        record = Record(
            setup_s=setup_s, load_s=load_s, window_s=window_s,
            pairs=len(passes) * int(cell.traffic["reads"]["pairs"]), passes=passes,
            window_peak_bytes=window_peak, trace=summary,
            em_launches=recorder.results() if recorder else [],
        )
        walls = sorted(p["wall_seconds"] for p in passes)
        log(f"window {window_s:.3f} s, {len(passes)} passes; pass wall min {walls[0]:.3f} "
            f"median {walls[len(walls) // 2]:.3f} max {walls[-1]:.3f} s")
        values = {}
        for name, unit in metrics:
            value = read_metric(name, record)
            if value is not None:
                values[name] = {"value": value, "unit": unit}
        memory_peak = max(setup_peak, window_peak) if on_cuda else 0
        # The program's state is freed before the reference runs.
        del pconfig, graph, paths_index
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        correct, checks, failed = check_outputs(cell, files, prefixes, workers)
        log(f"reference check {time.perf_counter() - t_check:.3f} s")
    finally:
        if restore_spans is not None:
            restore_spans()
        if recorder is not None:
            recorder.restore()
        shutil.rmtree(out_dir, ignore_errors=True)

    result = {
        "correct": bool(correct),
        "attempted": len(passes),
        "failed": failed,
        "metrics": values,
        "device": {
            "platform": "gpu" if on_cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": [[name, seconds] for name, seconds in summary.device_ops],
            "idle_gaps": [[name, seconds] for name, seconds in summary.idle_gaps],
        }
    result["checks"] = checks
    return result
