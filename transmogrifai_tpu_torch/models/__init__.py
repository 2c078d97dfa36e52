"""The port's model stages (counterpart of ``transmogrifai_tpu.models``):
the estimators a selector grid or a workflow names."""
from .classification import (  # noqa: F401
    OpLogisticRegression, OpLinearSVC, OpNaiveBayes,
)
from .mlp import (  # noqa: F401
    OpMultilayerPerceptronClassifier, MLPClassificationModel,
)
from .regression import (  # noqa: F401
    OpLinearRegression, OpGeneralizedLinearRegression, GLMModel,
    IsotonicRegressionCalibrator, IsotonicRegressionModel,
)
from .trees import (  # noqa: F401
    OpRandomForestClassifier, OpRandomForestRegressor,
    OpGBTClassifier, OpGBTRegressor,
    OpDecisionTreeClassifier, OpDecisionTreeRegressor,
    OpXGBoostClassifier, OpXGBoostRegressor,
)
from .prediction import (  # noqa: F401
    PredictionBatch, PredictorEstimator, PredictorModel,
)
