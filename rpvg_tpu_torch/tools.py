"""Utility commands: input conversion.

Usage:
    python -m rpvg_tpu.tools json-to-rpa in.json[.gz] out.rpa [--single-path] [--single-end]

Converts protobuf-JSON alignment lines (`vg view -a` output) into the
binary .rpa container the native engine streams directly.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rpvg-tpu-tools")
    sub = parser.add_subparsers(dest="command", required=True)

    convert = sub.add_parser("json-to-rpa", help="convert protobuf-JSON alignments to .rpa")
    convert.add_argument("input", help="JSON-lines alignment file (optionally .gz)")
    convert.add_argument("output", help="output .rpa path")
    convert.add_argument("--single-path", action="store_true", help="GAM-style single-path records")
    convert.add_argument("--single-end", action="store_true", help="not interleaved pairs")

    gam = sub.add_parser(
        "gamp-to-json",
        help="decode a binary vg .gam/.gamp into protobuf-JSON lines",
    )
    gam.add_argument("input", help="binary .gam/.gamp file")
    gam.add_argument("output", help="output JSON-lines path")
    gam.add_argument(
        "--vg-proto",
        default=None,
        help="optional vg.proto schema; default is the vendored vg schema",
    )
    gam.add_argument("--single-path", action="store_true")

    args = parser.parse_args(argv)

    if args.command == "gamp-to-json":
        import base64
        import json

        from .io.gam import stream_gam_dicts

        def jsonable(value):
            if isinstance(value, bytes):
                return base64.b64encode(value).decode()
            if isinstance(value, dict):
                return {k: jsonable(v) for k, v in value.items()}
            if isinstance(value, list):
                return [jsonable(v) for v in value]
            return value

        with open(args.output, "w") as handle:
            for record in stream_gam_dicts(
                args.input, args.vg_proto, is_multipath=not args.single_path
            ):
                handle.write(json.dumps(jsonable(record)) + "\n")
        print(f"wrote {args.output}", file=sys.stderr)
        return 0

    if args.command == "json-to-rpa":
        from .io.rpa import convert_json

        convert_json(
            args.input,
            args.output,
            is_multipath=not args.single_path,
            is_paired=not args.single_end,
        )
        print(f"wrote {args.output}", file=sys.stderr)
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
