from .inertial_gravity_wave import InertialGravityWave
from .internal_wave import InternalWave
from .kelvin_wave import KelvinWave

__all__ = ["InertialGravityWave", "InternalWave", "KelvinWave"]
