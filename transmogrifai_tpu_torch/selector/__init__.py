"""Model selection (counterpart of ``transmogrifai_tpu.selector``): the
binary model selector with cross-validation, its splitters and the
grid-batched candidate groups."""
