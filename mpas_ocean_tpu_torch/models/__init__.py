from .state import PrognosticVars

__all__ = ["PrognosticVars"]
