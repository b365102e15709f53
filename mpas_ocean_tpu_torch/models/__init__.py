from .forcing import (
    RHO0,
    Forcing,
    forcing_from_numpy,
    forcing_tendency,
    forcing_to_numpy,
    make_forcing,
)
from .state import PrognosticVars
from .tracers import (
    apply_tracer_update,
    make_tracers,
    total_tracer_content,
    tracer_concentration,
)

__all__ = ["RHO0", "Forcing", "PrognosticVars", "apply_tracer_update", "forcing_from_numpy",
           "forcing_tendency", "forcing_to_numpy", "make_forcing", "make_tracers",
           "total_tracer_content", "tracer_concentration"]
