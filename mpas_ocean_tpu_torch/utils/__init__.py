from .errors import ErrorMeasures, error_measures

__all__ = ["ErrorMeasures", "error_measures"]
