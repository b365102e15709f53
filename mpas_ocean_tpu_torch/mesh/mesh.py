"""Mesh wrapper: horizontal + vertical (counterpart of
mpas_ocean_tpu/mesh/mesh.py; reference: src/infra/MPASMesh/MPASMesh.jl:19-24)."""

from __future__ import annotations

from dataclasses import dataclass

from .horz_mesh import HorzMesh
from .vert_mesh import VerticalMesh


@dataclass(frozen=True)
class Mesh:
    horz: HorzMesh
    vert: VerticalMesh

    @property
    def cells(self):
        return self.horz.cells

    @property
    def duals(self):
        return self.horz.duals

    @property
    def edges(self):
        return self.horz.edges

    @property
    def n_cells(self) -> int:
        return self.horz.n_cells

    @property
    def n_edges(self) -> int:
        return self.horz.n_edges

    @property
    def n_vertices(self) -> int:
        return self.horz.n_vertices

    @property
    def n_vert_levels(self) -> int:
        return self.vert.n_vert_levels
