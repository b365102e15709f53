from .forcing import (
    RHO0,
    Forcing,
    forcing_from_numpy,
    forcing_tendency,
    forcing_to_numpy,
    make_forcing,
)
from .state import PrognosticVars

__all__ = ["RHO0", "Forcing", "PrognosticVars", "forcing_from_numpy", "forcing_tendency",
           "forcing_to_numpy", "make_forcing"]
