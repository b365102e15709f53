from .inertial_gravity_wave import InertialGravityWave
from .kelvin_wave import KelvinWave

__all__ = ["InertialGravityWave", "KelvinWave"]
