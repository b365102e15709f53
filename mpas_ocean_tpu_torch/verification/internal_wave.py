"""Analytic two-layer internal (baroclinic) gravity wave.

Counterpart of mpas_ocean_tpu/verification/internal_wave.py, in numpy: the
verification case of the layered stratification (models/stratification.py).
A flat-surface interface perturbation on a non-rotating periodic plane
excites the first baroclinic normal mode of the two-layer column, a
standing wave at omega = c1 k with

    c1^2 = g' H1 H2 / (H1 + H2),     g' = g (rho2 - rho1) / rho0

(the reduced-gravity result; the exact modal speed, which
``baroclinic_wave_speeds`` returns and ``c1`` uses, differs at O(g'/g)).
The layer thicknesses evolve in antisymmetry:

    h1(x, t) =  H1 + A sin(k x) cos(omega t)
    h2(x, t) =  H2 - A sin(k x) cos(omega t)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import GRAVITY
from ..models.forcing import RHO0
from ..models.stratification import baroclinic_wave_speeds

__all__ = ["InternalWave"]


@dataclass(frozen=True)
class InternalWave:
    """Two-layer standing internal wave on a periodic [0, lx) plane: lx in
    km (one wavelength), resting depths h1 and h2 [m], densities rho1 < rho2
    [kg/m^3], perturbation amplitude [m]."""

    lx: float = 320.0
    h1: float = 100.0
    h2: float = 300.0
    rho1: float = 1025.0
    rho2: float = 1026.0
    rho0: float = RHO0
    amplitude: float = 1.0
    g: float = GRAVITY

    @property
    def k(self) -> float:
        return 2.0 * np.pi / (self.lx * 1e3)

    @property
    def g_prime(self) -> float:
        return self.g * (self.rho2 - self.rho1) / self.rho0

    @property
    def c1(self) -> float:
        """The first baroclinic speed (the exact modal value)."""
        return float(baroclinic_wave_speeds([self.rho1, self.rho2], [self.h1, self.h2],
                                            rho0=self.rho0, g=self.g)[1])

    @property
    def omega(self) -> float:
        return self.c1 * self.k

    @property
    def period(self) -> float:
        return 2.0 * np.pi / self.omega

    def exact_thickness(self, x_cell, t: float) -> np.ndarray:
        """(nCells, 2) layer thicknesses of the standing mode at time t."""
        x = np.asarray(x_cell, dtype=np.float64)
        mode = self.amplitude * np.sin(self.k * x) * np.cos(self.omega * t)
        return np.stack([self.h1 + mode, self.h2 - mode], axis=1)

    def densities(self) -> list:
        return [self.rho1, self.rho2]

    def initial_state(self, mesh, n_vert_levels: int = 2):
        """(ssh, layer_thickness, normal_velocity) numpy arrays at t = 0."""
        if n_vert_levels != 2:
            raise ValueError("the two-layer internal wave needs 2 levels")
        horz = mesh.horz if hasattr(mesh, "horz") else mesh
        h = self.exact_thickness(np.asarray(horz.cells.x), 0.0)
        ssh = h.sum(axis=1) - (self.h1 + self.h2)
        u = np.zeros((horz.n_edges, 2))
        return ssh, h, u
