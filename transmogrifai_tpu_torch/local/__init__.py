"""Local scoring of saved workflow models (counterpart of
``transmogrifai_tpu.local``)."""
from .scorer import load_model_local, score_function, score_function_batch

__all__ = ["score_function", "score_function_batch", "load_model_local"]
