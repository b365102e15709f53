"""Area-weighted error norms for operator/solution verification.

Mirrors the reference's `ErrorMeasures` (reference: test/utilities.jl:13-32):
L_inf = |diff|_inf / |analytic|_inf, L_two = |diff * area|_2 / |analytic * area|_2,
with the integration weight depending on where the field lives:
cell -> areaCell, vertex -> areaTriangle, edge -> 0.5 * dcEdge * dvEdge.
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ErrorMeasures:
    L_two: float
    L_inf: float


def _area_for(mesh, location: str) -> np.ndarray:
    if location == "cell":
        return np.asarray(mesh.cells.area_cell)
    if location == "vertex":
        return np.asarray(mesh.duals.area_triangle)
    if location == "edge":
        return 0.5 * np.asarray(mesh.edges.dc_edge) * np.asarray(mesh.edges.dv_edge)
    raise ValueError(f"unknown location {location!r}")


def error_measures(numeric, analytic, mesh, location: str) -> ErrorMeasures:
    """Compute relative area-weighted L2 and relative L_inf error norms.

    ``numeric``/``analytic`` have shape (nElem,) or (nElem, nVertLevels);
    the area weight broadcasts over the level axis.
    """
    numeric = np.asarray(numeric)
    analytic = np.asarray(analytic)
    diff = analytic - numeric
    area = _area_for(mesh, location)
    if numeric.ndim == 2:
        area = area[:, None]

    L_inf = np.max(np.abs(diff)) / np.max(np.abs(analytic))
    L_two = np.linalg.norm(diff * area) / np.linalg.norm(analytic * area)
    return ErrorMeasures(L_two=float(L_two), L_inf=float(L_inf))
