"""Model selection (counterpart of ``transmogrifai_tpu.selector``): the
binary, multiclass and regression model selectors, their validators and
splitters, and the
grid-batched candidate groups."""
