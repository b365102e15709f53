"""Prognostic state container (counterpart of the ``PrognosticVars`` of
mpas_ocean_tpu/models/shallow_water.py; reference:
src/ocn/PrognosticVars.jl:6-57)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PrognosticVars:
    """Prognostic state at one time level, unstructured layout.

    ``tracers`` holds the optional tracer concentrations (temperature,
    salinity or passive fields; models/tracers.py), None when the run
    carries none."""

    ssh: torch.Tensor  # (nCells,)
    layer_thickness: torch.Tensor  # (nCells, K)
    normal_velocity: torch.Tensor  # (nEdges, K)
    tracers: torch.Tensor | None = None  # (nCells, nTracers, K)

    def to(self, device) -> "PrognosticVars":
        return PrognosticVars(
            ssh=self.ssh.to(device),
            layer_thickness=self.layer_thickness.to(device),
            normal_velocity=self.normal_velocity.to(device),
            tracers=None if self.tracers is None else self.tracers.to(device),
        )
