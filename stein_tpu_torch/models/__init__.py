from .distributions import normal_log_prob
from .linear_regression import LinearRegressionModel

__all__ = ["normal_log_prob", "LinearRegressionModel"]
