"""Analytic coastal Kelvin wave in a channel (wall at y=0, periodic in x).

The reference's CPU-vs-GPU headline benchmark runs a coastal Kelvin wave
(reference: README.MD:45-50, 64x64 mesh / 100 levels); the analytic solution
of the linearized rotating shallow-water equations with a southern wall is

    eta(x, y, t) = eta0 * exp(-y / Lr) * cos(k (x - c t))
    u = (c / H) * eta,   v = 0,        c = sqrt(g H),  Lr = c / f0

(the wave propagates with the wall on its right for f0 > 0).

Counterpart of mpas_ocean_tpu/verification/kelvin_wave.py (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import GRAVITY


@dataclass(frozen=True)
class KelvinWave:
    g: float = GRAVITY
    f0: float = 1e-4
    eta0: float = 1.0
    bottom_depth: float = 1000.0
    lx: float = 10000.0  # km (channel length; one wavelength by default)
    n_wavelengths: int = 1

    @property
    def c(self) -> float:
        return np.sqrt(self.g * self.bottom_depth)

    @property
    def rossby_radius(self) -> float:
        return self.c / self.f0

    @property
    def k(self) -> float:
        return self.n_wavelengths * 2.0 * np.pi / (self.lx * 1e3)

    def exact_ssh(self, x, y, t: float) -> np.ndarray:
        return (
            self.eta0
            * np.exp(-np.asarray(y) / self.rossby_radius)
            * np.cos(self.k * (np.asarray(x) - self.c * t))
        )

    def exact_normal_velocity(self, x_edge, y_edge, angle_edge, t: float):
        u = (self.c / self.bottom_depth) * self.exact_ssh(x_edge, y_edge, t)
        return u * np.cos(np.asarray(angle_edge))  # v = 0

    def initial_state(self, horz, n_vert_levels: int = 1):
        ssh = self.exact_ssh(np.asarray(horz.cells.x), np.asarray(horz.cells.y), 0.0)
        h = np.repeat(
            ((ssh + self.bottom_depth) / n_vert_levels)[:, None], n_vert_levels, axis=1
        )
        u = self.exact_normal_velocity(
            np.asarray(horz.edges.x),
            np.asarray(horz.edges.y),
            np.asarray(horz.edges.angle_edge),
            0.0,
        )
        # enforce the wall condition exactly on boundary edges
        u = u * np.asarray(horz.edges.edge_mask)
        return ssh, h, np.repeat(u[:, None], n_vert_levels, axis=1)
