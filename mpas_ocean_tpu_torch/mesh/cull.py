"""Cell culling: carve land/walls out of a periodic mesh.

Counterpart of mpas_ocean_tpu/mesh/cull.py (numpy only), on the port's
host-side mesh dataclasses, with the same arrays bit for bit.

MPAS builds bounded domains (channels, coastlines) by *culling* cells from
a periodic parent mesh; edges left with a single live cell become solid
boundaries where the normal velocity is held at zero. The reference only
handles fully periodic meshes (VertMesh.jl:50-57 errors otherwise) but its
legacy field inventory reserves boundary masks for exactly this
(src/infra/Mesh.jl:24-157 boundaryCell/boundaryEdge, meshMarkBoundaries!).

Here culling produces a standard HorzMesh whose padded/masked connectivity
already encodes the boundary conditions the operators need:
  * boundary edges get edge_mask = 0  -> velocity tendency zeroed (wall)
  * a boundary edge's missing cell is remapped to its live cell -> gradient
    and interpolation across the wall degenerate to benign no-ops
  * sign/weight/mask slots referencing culled elements are zeroed -> all
    reductions simply skip them
"""

from __future__ import annotations

import numpy as np

from .horz_mesh import DualCells, Edges, HorzMesh, PrimaryCells

__all__ = ["cull_cells"]


def cull_cells(horz: HorzMesh, keep_cells: np.ndarray) -> HorzMesh:
    """Return a new mesh containing only ``keep_cells`` (bool mask)."""
    keep_cells = np.asarray(keep_cells, dtype=bool)
    c, d, e = horz.cells, horz.duals, horz.edges

    coe = np.asarray(e.cells_on_edge)
    keep_edge = keep_cells[coe].any(axis=1)
    boundary_edge = keep_cells[coe].sum(axis=1) == 1
    voe = np.asarray(e.vertices_on_edge)
    keep_vertex = np.zeros(horz.n_vertices, dtype=bool)
    keep_vertex[voe[keep_edge]] = True

    # old -> new index maps (culled -> 0; masked out by zeroed signs)
    def idx_map(keep):
        new = np.zeros(len(keep), dtype=np.int64)
        new[keep] = np.arange(keep.sum())
        return new

    cmap, emap, vmap = idx_map(keep_cells), idx_map(keep_edge), idx_map(keep_vertex)
    n_cells = int(keep_cells.sum())
    n_edges = int(keep_edge.sum())
    n_vertices = int(keep_vertex.sum())

    # --- edges --------------------------------------------------------
    coe_k = coe[keep_edge]
    live0 = keep_cells[coe_k[:, 0]]
    # boundary edges: put the live cell in both slots
    c0 = np.where(live0, coe_k[:, 0], coe_k[:, 1])
    c1 = np.where(keep_cells[coe_k[:, 1]], coe_k[:, 1], c0)
    c1 = np.where(live0, c1, c0)
    cells_on_edge = np.stack([cmap[c0], cmap[c1]], axis=1).astype(np.int32)

    eoe = np.asarray(e.edges_on_edge)[keep_edge]
    w = np.asarray(e.weights_on_edge)[keep_edge]
    eoe_alive = keep_edge[eoe]
    weights_on_edge = np.where(eoe_alive, w, 0.0)
    edges_on_edge = np.where(eoe_alive, emap[eoe], 0).astype(np.int32)

    edge_mask = np.asarray(e.edge_mask)[keep_edge].copy()
    edge_mask[boundary_edge[keep_edge]] = 0.0

    edges = Edges(
        n_edges=n_edges,
        max_edges2=e.max_edges2,
        x=np.asarray(e.x)[keep_edge],
        y=np.asarray(e.y)[keep_edge],
        z=np.asarray(e.z)[keep_edge],
        f=np.asarray(e.f)[keep_edge],
        cells_on_edge=cells_on_edge,
        vertices_on_edge=vmap[voe[keep_edge]].astype(np.int32),
        n_edges_on_edge=eoe_alive.sum(axis=1).astype(np.int32),
        edges_on_edge=edges_on_edge,
        weights_on_edge=weights_on_edge,
        dv_edge=np.asarray(e.dv_edge)[keep_edge],
        dc_edge=np.asarray(e.dc_edge)[keep_edge],
        angle_edge=np.asarray(e.angle_edge)[keep_edge],
        edge_mask=edge_mask,
    )

    # --- cells --------------------------------------------------------
    eoc = np.asarray(c.edges_on_cell)[keep_cells]
    slot_ok = (np.asarray(c.edge_mask_on_cell)[keep_cells] > 0) & keep_edge[eoc]
    new_eoc = np.where(slot_ok, emap[eoc], 0).astype(np.int32)
    cell_ids = np.arange(n_cells)[:, None]
    edge_sign_on_cell = np.where(
        slot_ok,
        np.where(cells_on_edge[new_eoc, 0] == cell_ids, -1.0, 1.0),
        0.0,
    )
    coc = np.asarray(c.cells_on_cell)[keep_cells]
    coc_ok = slot_ok & keep_cells[coc]
    voc = np.asarray(c.vertices_on_cell)[keep_cells]
    voc_ok = slot_ok & keep_vertex[voc]

    cells = PrimaryCells(
        n_cells=n_cells,
        max_edges=c.max_edges,
        x=np.asarray(c.x)[keep_cells],
        y=np.asarray(c.y)[keep_cells],
        z=np.asarray(c.z)[keep_cells],
        f=np.asarray(c.f)[keep_cells],
        area_cell=np.asarray(c.area_cell)[keep_cells],
        n_edges_on_cell=np.asarray(c.n_edges_on_cell)[keep_cells],
        edges_on_cell=new_eoc,
        vertices_on_cell=np.where(voc_ok, vmap[voc], 0).astype(np.int32),
        cells_on_cell=np.where(coc_ok, cmap[coc], 0).astype(np.int32),
        edge_sign_on_cell=edge_sign_on_cell,
        edge_mask_on_cell=slot_ok.astype(edge_sign_on_cell.dtype),
        kite_areas_on_cell=np.where(
            slot_ok, np.asarray(c.kite_areas_on_cell)[keep_cells], 0.0
        ),
    )

    # --- vertices -----------------------------------------------------
    eov = np.asarray(d.edges_on_vertex)[keep_vertex]
    eov_ok = keep_edge[eov]
    vert_ids = np.arange(n_vertices)[:, None]
    new_eov = np.where(eov_ok, emap[eov], 0).astype(np.int32)
    edge_sign_on_vertex = np.where(
        eov_ok,
        np.where(
            edges.vertices_on_edge[new_eov, 0] == vert_ids, -1.0, 1.0
        ),
        0.0,
    )
    cov = np.asarray(d.cells_on_vertex)[keep_vertex]
    cov_ok = keep_cells[cov]

    duals = DualCells(
        n_vertices=n_vertices,
        vertex_degree=d.vertex_degree,
        x=np.asarray(d.x)[keep_vertex],
        y=np.asarray(d.y)[keep_vertex],
        z=np.asarray(d.z)[keep_vertex],
        f=np.asarray(d.f)[keep_vertex],
        area_triangle=np.asarray(d.area_triangle)[keep_vertex],
        edges_on_vertex=new_eov,
        cells_on_vertex=np.where(cov_ok, cmap[cov], 0).astype(np.int32),
        edge_sign_on_vertex=edge_sign_on_vertex,
        kite_areas_on_vertex=np.where(
            cov_ok, np.asarray(d.kite_areas_on_vertex)[keep_vertex], 0.0
        ),
    )

    return HorzMesh(
        cells=cells,
        duals=duals,
        edges=edges,
        lx=horz.lx,
        ly=horz.ly,
        on_sphere=horz.on_sphere,
        sphere_radius=horz.sphere_radius,
    )
