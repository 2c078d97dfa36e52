"""Project-generator CLI (counterpart of ``transmogrifai_tpu.cli``):
``python -m transmogrifai_tpu_torch gen ...`` infers the problem kind and
each column's feature type from a sample file and writes a runnable
project; ``serve`` serves a saved model.

Reference: the ``op gen`` codegen tool (cli/src/main/scala/com/salesforce/
op/cli/: CommandParser, CliExec, gen/ProblemSchema.scala,
gen/ProblemKind.scala, templates/simple/).
"""
from .schema import ProblemKind, ProblemSchema, infer_problem_kind  # noqa: F401
from .generator import generate_project  # noqa: F401
from .main import main  # noqa: F401

__all__ = ["ProblemKind", "ProblemSchema", "infer_problem_kind",
           "generate_project", "main"]
