"""The workflow engine (counterpart of ``transmogrifai_tpu.workflow``):
``OpWorkflow``/``OpWorkflowModel`` and the runner's entry points."""
from .workflow import OpWorkflow, OpWorkflowModel  # noqa: F401
from .runner import (OpApp, OpParams, OpWorkflowRunner,  # noqa: F401
                     OpWorkflowRunnerResult, RunType)
