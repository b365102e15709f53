"""Analytic inertial-gravity-wave solution of the linearized rotating
shallow-water equations on a doubly periodic plane.

(reference: src/inertialGravityWave.jl and the mirrored Python class in
src/compare.py:12-130; parameters match the polaris test case the reference
artifact meshes come from.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import GRAVITY


@dataclass(frozen=True)
class InertialGravityWave:
    """Plane-wave solution eta = eta0 cos(kx x + ky y - omega t).

    lx is in km (as in the reference, inertialGravityWave.jl:13); kx/ky are
    converted to 1/m internally (``:16-17``).
    """

    g: float = GRAVITY
    f0: float = 1e-4
    npx: float = 2.0
    npy: float = 2.0
    eta0: float = 1.0
    bottom_depth: float = 1000.0
    lx: float = 10000.0  # km
    ly: float = field(default=None)  # km; defaults to sqrt(3)/2 * lx

    def __post_init__(self):
        if self.ly is None:
            object.__setattr__(self, "ly", np.sqrt(3.0) / 2.0 * self.lx)

    @property
    def kx(self) -> float:
        return self.npx * 2.0 * np.pi / (self.lx * 1e3)

    @property
    def ky(self) -> float:
        return self.npy * 2.0 * np.pi / (self.ly * 1e3)

    @property
    def omega(self) -> float:
        return np.sqrt(
            self.f0**2 + self.g * self.bottom_depth * (self.kx**2 + self.ky**2)
        )

    def exact_ssh(self, x_cell, y_cell, t: float) -> np.ndarray:
        """(reference: inertialGravityWave.jl:38-45)"""
        return self.eta0 * np.cos(self.kx * x_cell + self.ky * y_cell - self.omega * t)

    def exact_velocity(self, x, y, t: float):
        """Cartesian (u, v) of the exact solution."""
        phase = self.kx * x + self.ky * y - self.omega * t
        amp = self.eta0 * self.g / (self.omega**2 - self.f0**2)
        u = amp * (
            self.omega * self.kx * np.cos(phase) - self.f0 * self.ky * np.sin(phase)
        )
        v = amp * (
            self.omega * self.ky * np.cos(phase) + self.f0 * self.kx * np.sin(phase)
        )
        return u, v

    def exact_normal_velocity(self, x_edge, y_edge, angle_edge, t: float) -> np.ndarray:
        """(u, v) projected onto the edge normal
        (reference: inertialGravityWave.jl:47-64)."""
        u, v = self.exact_velocity(x_edge, y_edge, t)
        return u * np.cos(angle_edge) + v * np.sin(angle_edge)

    def initial_state(self, mesh, n_vert_levels: int = 1):
        """Initial (ssh, layer_thickness, normal_velocity) arrays at t=0,
        the way polaris builds the reference's initial_state.nc."""
        h = mesh.cells if hasattr(mesh, "cells") else mesh.horz.cells
        e = mesh.edges if hasattr(mesh, "edges") else mesh.horz.edges
        ssh = self.exact_ssh(np.asarray(h.x), np.asarray(h.y), 0.0)
        thickness = np.repeat(
            ((ssh + self.bottom_depth) / n_vert_levels)[:, None], n_vert_levels, axis=1
        )
        u = self.exact_normal_velocity(
            np.asarray(e.x), np.asarray(e.y), np.asarray(e.angle_edge), 0.0
        )
        normal_velocity = np.repeat(u[:, None], n_vert_levels, axis=1)
        return ssh, thickness, normal_velocity
