from .inertial_gravity_wave import InertialGravityWave

__all__ = ["InertialGravityWave"]
