from .distributions import gamma_log_prob, normal_log_prob
from .linear_regression import LinearRegressionModel
from .bayesian_nn import BayesianNNModel

__all__ = ["gamma_log_prob", "normal_log_prob", "LinearRegressionModel",
           "BayesianNNModel"]
