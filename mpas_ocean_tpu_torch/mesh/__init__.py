from .cull import cull_cells
from .horz_mesh import DualCells, Edges, HorzMesh, PrimaryCells
from .mesh import Mesh
from .planar_hex import planar_hex_mesh
from .vert_mesh import VerticalMesh, make_vertical_mesh
from .voronoi import build_planar_trisk_mesh

__all__ = [
    "DualCells",
    "Edges",
    "HorzMesh",
    "Mesh",
    "PrimaryCells",
    "VerticalMesh",
    "build_planar_trisk_mesh",
    "cull_cells",
    "make_vertical_mesh",
    "planar_hex_mesh",
]
