"""Model selection (counterpart of ``transmogrifai_tpu.selector``): the
binary, multiclass and regression model selectors, their validators and
splitters, the grid-batched candidate groups, random-search grids and the
two-selector combiner."""
from .model_selector import (  # noqa: F401
    ModelSelector, SelectedModel, BinaryClassificationModelSelector,
    MultiClassificationModelSelector, RegressionModelSelector,
    DefaultSelectorParams, RandomParamBuilder, grid,
)
from .combiner import SelectedModelCombiner, SelectedCombinerModel  # noqa: F401
from .splitters import DataSplitter, DataBalancer, DataCutter  # noqa: F401
from .validators import OpCrossValidation, OpTrainValidationSplit  # noqa: F401
