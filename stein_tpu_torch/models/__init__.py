from .distributions import (
    gamma_log_prob,
    normal_log_prob,
    sigmoid_cross_entropy_with_logits,
)
from .linear_regression import LinearRegressionModel
from .bayesian_nn import BayesianNNModel
from .logistic_regression import LogisticRegressionModel

__all__ = ["gamma_log_prob", "normal_log_prob",
           "sigmoid_cross_entropy_with_logits", "LinearRegressionModel",
           "BayesianNNModel", "LogisticRegressionModel"]
