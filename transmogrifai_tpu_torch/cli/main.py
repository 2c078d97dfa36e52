"""CLI argument parsing and dispatch (counterpart of
``transmogrifai_tpu.cli.main``): ``gen`` writes a project, ``serve``
serves a saved model on the port's ``ModelServer`` (over HTTP, or over a
JSONL file of rows with ``--score-jsonl``).  ``lint``, ``trace`` and
``pod`` raise ``NotImplementedError`` naming their ROADMAP Queue A items.

Reference: ``cli/CommandParser.scala:82-124`` (gen: --input, --id,
--response, --overwrite, the project name) and ``CliExec.scala``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

from .generator import generate_project
from .schema import ProblemKind, ProblemSchema

__all__ = ["main", "build_parser"]

#: subcommands of the JAX package's CLI that wait for their features
_NOT_PORTED = {"lint": ("the pipeline static analyzer", "6.8"),
               "trace": ("the trace summarizer", "6.5.5"),
               "pod": ("the local pod launcher", "6.7")}


def _parse_overrides(pairs) -> Dict[str, str]:
    out = {}
    for p in pairs or ():
        if "=" not in p:
            raise SystemExit(f"--feature-type expects col=Type, got {p!r}")
        col, tname = p.split("=", 1)
        out[col] = tname
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "transmogrifai_tpu_torch",
        description="TransmogrifAI (PyTorch/CUDA port) command line")
    sub = p.add_subparsers(dest="command", required=True)
    gen = sub.add_parser("gen", help="generate a new AutoML project")
    gen.add_argument("name", help="project name (e.g. Titanic)")
    gen.add_argument("--input", required=True,
                     help="sample CSV/JSONL used to infer the schema")
    gen.add_argument("--id", required=True, dest="id_field",
                     help="id column name")
    gen.add_argument("--response", required=True,
                     help="response column name")
    gen.add_argument("--kind", choices=[k.value for k in ProblemKind],
                     default=None,
                     help="override the inferred problem kind")
    gen.add_argument("--feature-type", action="append", metavar="COL=TYPE",
                     help="override an inferred semantic type "
                          "(e.g. Age=Real); repeatable")
    gen.add_argument("--columns", default=None,
                     help="comma-separated column names for headerless CSVs")
    gen.add_argument("--dest", default=".", help="output directory")
    gen.add_argument("--overwrite", action="store_true")

    for name, (what, item) in _NOT_PORTED.items():
        sub.add_parser(name, add_help=False,
                       help=f"{what} (not ported: ROADMAP Queue A item "
                            f"{item})")

    srv = sub.add_parser(
        "serve", help="serve a persisted model (micro-batched scoring)")
    srv.add_argument("--model", required=True,
                     help="persisted model directory (OpWorkflowModel.save)")
    srv.add_argument("--name", default="default", help="registry model name")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8080)
    srv.add_argument("--device", default=None,
                     help="torch device (default: the CUDA card)")
    srv.add_argument("--max-batch", type=int, default=64,
                     help="micro-batch row cap (largest shape bucket)")
    srv.add_argument("--max-latency-ms", type=float, default=5.0,
                     help="coalescing window before a partial batch runs")
    srv.add_argument("--max-queue-rows", type=int, default=1024,
                     help="bounded queue depth; beyond it requests shed 503")
    srv.add_argument("--deadline-ms", type=float, default=None,
                     help="default per-request deadline while queued")
    srv.add_argument("--warmup-json", default=None, metavar="JSON",
                     help="one raw row as JSON scored once at startup")
    srv.add_argument("--score-jsonl", default=None, metavar="FILE",
                     help="offline mode: score a JSONL file of rows, print "
                          "one JSON result per line, and exit (no HTTP)")
    return p


def _run_serve(args) -> int:
    from ..serving import ModelServer, ShedResult

    warmup_row = json.loads(args.warmup_json) if args.warmup_json else None
    rows = None
    if args.score_jsonl:
        with open(args.score_jsonl) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        if rows and warmup_row is None:
            warmup_row = dict(rows[0])
    server = ModelServer.from_path(
        args.model, name=args.name, device=args.device,
        max_batch=args.max_batch, max_latency_ms=args.max_latency_ms,
        max_queue_rows=args.max_queue_rows,
        default_deadline_ms=args.deadline_ms, warmup_row=warmup_row)
    if rows is not None:
        with server:
            for i in range(0, len(rows), args.max_batch):
                for res in server.score(rows[i:i + args.max_batch]):
                    if isinstance(res, ShedResult):
                        res = res.to_json()
                    print(json.dumps(res, default=str))
            print(json.dumps(server.snapshot(), default=str),
                  file=sys.stderr)
        return 0
    from ..serving.http import serve_forever

    server.start()
    print(f"serving {args.name!r} ({args.model}) on "
          f"http://{args.host}:{args.port} — POST /score, GET /metrics")
    try:
        serve_forever(server, args.host, args.port)
    finally:
        server.stop()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] and argv[0] in _NOT_PORTED:
        what, item = _NOT_PORTED[argv[0]]
        raise NotImplementedError(
            f"`{argv[0]}`: {what} is not ported yet (ROADMAP Queue A item "
            f"{item})")
    args = build_parser().parse_args(argv)
    if args.command == "gen":
        schema = ProblemSchema.from_file(
            args.name, args.input, args.response, args.id_field,
            overrides=_parse_overrides(args.feature_type), kind=args.kind,
            columns=args.columns.split(",") if args.columns else None)
        written = generate_project(schema, args.dest,
                                   overwrite=args.overwrite)
        print(f"{schema.kind.value} project {schema.name!r}: "
              f"{len(written)} files")
        for rel in sorted(written):
            print(f"  {written[rel]}")
        return 0
    if args.command == "serve":
        return _run_serve(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
