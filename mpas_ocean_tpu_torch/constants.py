"""Physical constants (counterpart of mpas_ocean_tpu/constants.py).

The reference hardcodes g = 9.80616 inside its pressure-gradient kernel
(reference: src/ocn/Tendencies/normalVelocity/pressure_gradient.jl:63).
"""

GRAVITY = 9.80616
