"""Command-line interface of the port (counterpart of ``rpvg_tpu/cli.py``),
with the JAX package's option surface.

``--backend`` names the device of the inference phases: ``cuda`` (the
default) or ``cpu``.  ``cuda`` without a CUDA device is an error; there is
no fallback.  ``--multiprocess N`` (N > 1) runs the fragment pass in N
worker processes, forked before this process touches CUDA (the workers
run host code only); the device is checked after the fork.

    python -m rpvg_tpu_torch.cli -g graph.json -p panel.json -a aln.json \\
        -o out -i haplotype-transcripts -f info.tsv --backend cuda
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

from rpvg_tpu_torch.pipeline import PipelineConfig, PipelineInputError, run_pipeline


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="rpvg-tpu-torch",
        description=(
            "rpvg_tpu_torch — infers path posterior probabilities and abundances "
            "from variation graph read alignments (PyTorch / CUDA engine)"
        ),
    )

    required = parser.add_argument_group("required")
    required.add_argument(
        "-g", "--graph", required=True,
        help="graph filename (.xg container or vg-Graph JSON)",
    )
    required.add_argument(
        "-p", "--paths", required=True,
        help="path panel index filename (.gbwt container or panel JSON)",
    )
    required.add_argument(
        "-a", "--alignments", required=True,
        help="alignment filename (.gam/.gamp binary, JSON lines, or .rpa)",
    )
    required.add_argument("-o", "--output-prefix", required=True, help="output filename prefix")
    required.add_argument(
        "-i",
        "--inference-model",
        required=True,
        choices=["haplotypes", "transcripts", "strains", "haplotype-transcripts"],
    )

    general = parser.add_argument_group("general")
    general.add_argument("-t", "--threads", type=int, default=1)
    general.add_argument("-r", "--rng-seed", type=int, default=None)
    general.add_argument(
        "--multiprocess",
        type=int,
        default=0,
        metavar="N",
        help="run the fragment pass across N worker processes",
    )
    general.add_argument(
        "--backend",
        default="cuda",
        choices=["cuda", "cpu"],
        help="device of the inference phases (default cuda; never falls back)",
    )

    alignment = parser.add_argument_group("alignment")
    alignment.add_argument(
        "-e", "--strand-specific", default="unstranded", choices=["unstranded", "fr", "rf"]
    )
    alignment.add_argument("-u", "--single-path", action="store_true")
    alignment.add_argument("-s", "--single-end", action="store_true")
    alignment.add_argument("-l", "--long-reads", action="store_true")
    alignment.add_argument("--score-not-qual", action="store_true")

    fragment = parser.add_argument_group("fragment")
    fragment.add_argument("-m", "--frag-mean", type=float, default=None)
    fragment.add_argument("-d", "--frag-sd", type=float, default=None)
    fragment.add_argument("--max-num-sd-frag", type=int, default=10)

    probability = parser.add_argument_group("probability")
    probability.add_argument("-b", "--write-probs", action="store_true")
    probability.add_argument("--max-par-offset", type=int, default=4)
    probability.add_argument("--max-score-diff", type=int, default=20)
    probability.add_argument("--filt-best-score", type=float, default=0.9)
    probability.add_argument("--use-allelic-mapq", action="store_true")
    probability.add_argument("--min-noise-prob", type=float, default=1e-4)
    probability.add_argument("--prob-precision", type=float, default=1e-8)
    probability.add_argument("--path-node-cluster", action="store_true")

    haplotyping = parser.add_argument_group("haplotyping")
    haplotyping.add_argument("-y", "--ploidy", type=int, default=2)
    haplotyping.add_argument("-f", "--path-info", default=None)
    haplotyping.add_argument("--min-hap-prob", type=float, default=0.001)
    haplotyping.add_argument("--ind-hap-inference", action="store_true")
    haplotyping.add_argument("--use-hap-gibbs", action="store_true")

    quantification = parser.add_argument_group("quantification")
    quantification.add_argument("-n", "--num-gibbs-samples", type=int, default=0)
    quantification.add_argument("--max-em-its", type=int, default=10000)
    quantification.add_argument("--max-rel-em-conv", type=float, default=0.001)
    quantification.add_argument("--gibbs-thin-its", type=int, default=25)

    return parser


def run_cli(argv: Optional[List[str]] = None) -> Tuple[int, Optional[Dict]]:
    """Parse, validate and run; returns (exit code, pipeline stats or
    None when the run did not happen)."""
    args = build_parser().parse_args(argv)

    if args.frag_mean is None != args.frag_sd is None:
        print("ERROR: both --frag-mean and --frag-sd must be given.", file=sys.stderr)
        return 1, None
    if args.inference_model == "haplotype-transcripts" and args.path_info is None:
        print(
            "ERROR: --path-info is required for haplotype-transcripts inference.",
            file=sys.stderr,
        )
        return 1, None
    if args.ploidy == 0:
        print("ERROR: --ploidy cannot be 0.", file=sys.stderr)
        return 1, None

    import time

    rng_seed = args.rng_seed if args.rng_seed is not None else int(time.time())
    config = PipelineConfig(
        graph=args.graph,
        paths=args.paths,
        alignments=args.alignments,
        output_prefix=args.output_prefix,
        inference_model=args.inference_model,
        threads=args.threads,
        rng_seed=rng_seed,
        library_type=args.strand_specific,
        single_path=args.single_path,
        single_end=args.single_end,
        long_reads=args.long_reads,
        score_not_qual=args.score_not_qual,
        frag_mean=args.frag_mean,
        frag_sd=args.frag_sd,
        max_num_sd_frag=args.max_num_sd_frag,
        write_probs=args.write_probs,
        max_par_offset=args.max_par_offset,
        max_score_diff=args.max_score_diff,
        filt_best_score=args.filt_best_score,
        use_allelic_mapq=args.use_allelic_mapq,
        min_noise_prob=args.min_noise_prob,
        prob_precision=args.prob_precision,
        path_node_cluster=args.path_node_cluster,
        ploidy=args.ploidy,
        path_info=args.path_info,
        min_hap_prob=args.min_hap_prob,
        ind_hap_inference=args.ind_hap_inference,
        use_hap_gibbs=args.use_hap_gibbs,
        num_gibbs_samples=args.num_gibbs_samples,
        max_em_its=args.max_em_its,
        max_rel_em_conv=args.max_rel_em_conv,
        gibbs_thin_its=args.gibbs_thin_its,
    )
    from rpvg_tpu_torch.device import DeviceUnavailableError, resolve_device

    import torch

    multiprocess = args.multiprocess > 1
    try:
        # With --multiprocess the workers fork before this process touches
        # CUDA at all: run_pipeline_multiprocess checks the device after
        # the fork.
        device = torch.device(args.backend) if multiprocess else resolve_device(args.backend)
    except DeviceUnavailableError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1, None

    from rpvg_tpu_torch import __version__

    print(f"Running rpvg_tpu_torch ({__version__}) on {device}", file=sys.stderr)
    print(f"Random number generator seed: {rng_seed}", file=sys.stderr)
    try:
        if multiprocess:
            from rpvg_tpu_torch.parallel.multihost import run_pipeline_multiprocess

            stats = run_pipeline_multiprocess(config, args.multiprocess, device)
        else:
            stats = run_pipeline(config, device)
    except (PipelineInputError, DeviceUnavailableError) as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1, None
    return 0, stats


def main(argv: Optional[List[str]] = None) -> int:
    return run_cli(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
