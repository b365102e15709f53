from .forcing import (
    RHO0,
    Forcing,
    forcing_from_numpy,
    forcing_tendency,
    forcing_to_numpy,
    make_forcing,
)
from .state import PrognosticVars
from .stratification import (
    Stratification,
    baroclinic_wave_speeds,
    make_stratification,
    montgomery_potential,
    stratification_from_numpy,
    stratification_to_numpy,
)
from .tracers import (
    apply_tracer_update,
    make_tracers,
    total_tracer_content,
    tracer_concentration,
)

__all__ = ["RHO0", "Forcing", "PrognosticVars", "Stratification", "apply_tracer_update",
           "baroclinic_wave_speeds", "forcing_from_numpy", "forcing_tendency", "forcing_to_numpy",
           "make_forcing", "make_stratification", "make_tracers", "montgomery_potential",
           "stratification_from_numpy", "stratification_to_numpy", "total_tracer_content",
           "tracer_concentration"]
