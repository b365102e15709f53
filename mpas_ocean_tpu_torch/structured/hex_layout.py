"""Structured (lattice) layout for uniform periodic hex meshes.

Counterpart of mpas_ocean_tpu/structured/hex_layout.py: the bijection
between the unstructured mesh and the parity-plane lattice, including the
edge-orientation sign flips, plus the machine-extracted Coriolis stencil
and the two vertex stencils of the nonlinear core (kite cell->vertex
average, edge endpoints). Host-side numpy, with the same numpy body as the
JAX package so both build identical layouts.

Structured layout ("parity planes"):
  cells    (2, ny2, nx, ...)      plane p = row j % 2, unit m = j // 2
  edges    (3, 2, ny2, nx, ...)   family E / NE / NW owned by their cell,
                                  canonical normals at 0 / 60 / 120 degrees
  vertices (2, 2, ny2, nx, ...)   A = vertex between NE and NW edges,
                                  B = vertex between E and NE edges

Neighbor algebra (periodic):
  E(c)  = same plane, i+1                W = i-1
  plane0: NE = plane1[m, i],   NW = plane1[m, i-1]
  plane1: NE = plane0[m+1,i+1], NW = plane0[m+1, i]
  plane0: SE = plane1[m-1, i], SW = plane1[m-1, i-1]
  plane1: SE = plane0[m, i+1], SW = plane0[m, i]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

E, NE, NW = 0, 1, 2  # edge families
A, B = 0, 1  # vertex kinds

__all__ = ["CoriolisTerm", "HexLayout", "A", "B", "E", "NE", "NW"]


def _neighbor(j: np.ndarray, i: np.ndarray, fam: int, nx: int, ny: int):
    """(j, i) of the canonical-direction neighbor across edge family fam."""
    if fam == E:
        return j, (i + 1) % nx
    odd = j % 2
    if fam == NE:
        return (j + 1) % ny, (i + odd) % nx
    if fam == NW:
        return (j + 1) % ny, (i - 1 + odd) % nx
    raise ValueError(fam)


@dataclass
class CoriolisTerm:
    """One static roll-multiply-add of the tangential reconstruction:
    out[family f_out, plane p_out] += w * shift(u[f_in, p_in], dm, di)."""

    f_out: int
    p_out: int
    f_in: int
    p_in: int
    dm: int
    di: int
    w: float


class HexLayout:
    """Bijection uniform-hex unstructured mesh <-> structured lattice."""

    def __init__(self, horz, nx: int, ny: int):
        if ny % 2:
            raise ValueError("ny must be even")
        if horz.n_cells != nx * ny or horz.n_edges != 3 * nx * ny:
            raise ValueError("mesh is not an nx-by-ny uniform hex mesh")
        if nx < 5 or ny < 6:
            # the stencil extractor probes representative interior cells at
            # j0 = 2 + parity, i0 = 2 without periodic wrap; below this size
            # the extracted (dm, di) could silently wrap and be wrong
            raise ValueError(
                f"HexLayout requires nx >= 5 and ny >= 6 (got {nx}x{ny}): "
                "stencil extraction probes interior cells without wrap"
            )
        self.nx, self.ny, self.ny2 = nx, ny, ny // 2
        self.horz = horz

        n_cells = horz.n_cells
        # generator cells are row-major: id = j * nx + i (planar_hex.py)
        cid = np.arange(n_cells)
        j, i = cid // nx, cid % nx
        dc = float(np.asarray(horz.edges.dc_edge)[0])
        x = np.asarray(horz.cells.x)
        y = np.asarray(horz.cells.y)
        expect_x = (i + 0.5 * (j % 2)) * dc
        expect_y = j * (dc * np.sqrt(3.0) / 2.0)
        if not (
            np.allclose(x, expect_x, atol=1e-6 * dc)
            and np.allclose(y, expect_y, atol=1e-6 * dc)
        ):
            raise ValueError("cells are not in generator row-major hex order")
        self.dc = dc

        # edge_of[cell, fam] = global edge id; flip = +1 if the stored
        # normal already points in the family's canonical direction
        eoc = np.asarray(horz.cells.edges_on_cell)
        coe = np.asarray(horz.edges.cells_on_edge)
        edge_of = np.empty((n_cells, 3), dtype=np.int64)
        for fam in (E, NE, NW):
            jn, in_ = _neighbor(j, i, fam, nx, ny)
            nbr = jn * nx + in_
            # the unique shared edge of cell and its neighbor
            cand = eoc[cid]  # (n, 6)
            hit = (coe[cand, 0] == nbr[:, None]) | (coe[cand, 1] == nbr[:, None])
            hit &= (coe[cand, 0] == cid[:, None]) | (coe[cand, 1] == cid[:, None])
            if not (hit.sum(1) == 1).all():
                raise ValueError("not a uniform hex topology")
            edge_of[:, fam] = cand[np.arange(n_cells), hit.argmax(1)]
        self.edge_of = edge_of
        self.edge_flip = np.where(
            coe[edge_of, 0] == cid[:, None], 1.0, -1.0
        )  # (n_cells, 3)

        # owner cell + family of every edge (inverse map)
        self.edge_owner = np.empty(horz.n_edges, dtype=np.int64)
        self.edge_family = np.empty(horz.n_edges, dtype=np.int64)
        self.edge_owner[edge_of.ravel()] = np.repeat(cid, 3)
        self.edge_family[edge_of.ravel()] = np.tile(np.arange(3), n_cells)

        # vertex_of[cell, kind]: A between NE and NW edges, B between NE
        # and E edges
        voe = np.asarray(horz.edges.vertices_on_edge)
        vertex_of = np.empty((n_cells, 2), dtype=np.int64)
        for kind, (f1, f2) in ((A, (NE, NW)), (B, (NE, E))):
            v1 = voe[edge_of[:, f1]]  # (n, 2)
            v2 = voe[edge_of[:, f2]]
            shared = np.where(
                (v1[:, 0:1] == v2).any(1, keepdims=True), v1[:, 0:1], v1[:, 1:2]
            )[:, 0]
            vertex_of[:, kind] = shared
        self.vertex_of = vertex_of

        # owner cell + kind of every vertex (inverse map)
        self.vertex_owner = np.empty(horz.n_vertices, dtype=np.int64)
        self.vertex_kind = np.empty(horz.n_vertices, dtype=np.int64)
        self.vertex_owner[vertex_of.ravel()] = np.repeat(cid, 2)
        self.vertex_kind[vertex_of.ravel()] = np.tile(np.arange(2), n_cells)

        self.coriolis_terms = self._extract_coriolis_stencil()
        self.vertex_cell_terms = self._extract_vertex_cell_stencil()
        self.edge_vertex_terms = self._extract_edge_vertex_stencil()

    # ---- field conversion ------------------------------------------------
    def cells_to_struct(self, field: np.ndarray) -> np.ndarray:
        """(nCells, ...) -> (2, ny2, nx, ...)"""
        nx, ny2 = self.nx, self.ny2
        out = np.asarray(field).reshape(ny2, 2, nx, *np.shape(field)[1:])
        return np.moveaxis(out, 1, 0)

    def cells_from_struct(self, field: np.ndarray) -> np.ndarray:
        out = np.moveaxis(np.asarray(field), 0, 1)
        return out.reshape(self.ny2 * 2 * self.nx, *out.shape[3:])

    def edges_to_struct(self, field: np.ndarray, sign: bool = False) -> np.ndarray:
        """(nEdges, ...) -> (3, 2, ny2, nx, ...); sign=True flips
        orientation-sensitive (velocity-like) fields to canonical."""
        field = np.asarray(field)
        per_cell = field[self.edge_of]  # (nCells, 3, ...)
        if sign:
            per_cell = (
                per_cell
                * self.edge_flip.reshape(
                    self.edge_flip.shape + (1,) * (field.ndim - 1)
                )
            ).astype(field.dtype, copy=False)
        per_cell = np.moveaxis(per_cell, 1, 0)  # (3, nCells, ...)
        return np.stack([self.cells_to_struct(pf) for pf in per_cell])

    def edges_from_struct(self, field: np.ndarray, sign: bool = False) -> np.ndarray:
        field = np.asarray(field)
        n_edges = self.horz.n_edges
        out = np.empty((n_edges,) + field.shape[4:], dtype=field.dtype)
        for fam in range(3):
            flat = self.cells_from_struct(field[fam])  # (nCells, ...)
            if sign:
                flat = (
                    flat
                    * self.edge_flip[:, fam].reshape((-1,) + (1,) * (flat.ndim - 1))
                ).astype(field.dtype, copy=False)
            out[self.edge_of[:, fam]] = flat
        return out

    def vertices_to_struct(self, field: np.ndarray) -> np.ndarray:
        """(nVertices, ...) -> (2, 2, ny2, nx, ...), kind first."""
        field = np.asarray(field)
        per_cell = np.moveaxis(field[self.vertex_of], 1, 0)  # (2, nCells, ...)
        return np.stack([self.cells_to_struct(pf) for pf in per_cell])

    def vertices_from_struct(self, field: np.ndarray) -> np.ndarray:
        field = np.asarray(field)
        n_vertices = self.horz.n_vertices
        out = np.empty((n_vertices,) + field.shape[4:], dtype=field.dtype)
        for kind in range(2):
            out[self.vertex_of[:, kind]] = self.cells_from_struct(field[kind])
        return out

    def _cell_offset(self, c0: int, cg: int):
        """(p_in, dm, di) of cell cg relative to representative cell c0
        (both interior, no periodic wrap)."""
        nx = self.nx
        j0, i0 = c0 // nx, c0 % nx
        jg, ig = cg // nx, cg % nx
        dj, di_ = jg - j0, ig - i0
        p_in = (j0 + dj) % 2
        dm = (j0 + dj) // 2 - j0 // 2
        return int(p_in), int(dm), int(di_)

    # ---- vertex stencils (nonlinear dynamics) ----------------------------
    def _extract_vertex_cell_stencil(self) -> tuple:
        """Kite-area cell->vertex average as static rolls: terms
        (kind, p_out, p_in, dm, di, w) with w the normalized kite weight
        (1/3 each on a uniform lattice; checked to sum to 1)."""
        cov = np.asarray(self.horz.duals.cells_on_vertex)
        kite = np.asarray(self.horz.duals.kite_areas_on_vertex, dtype=np.float64)
        terms = []
        for kind in (A, B):
            for parity in (0, 1):
                c0 = (2 + parity) * self.nx + 2
                v0 = self.vertex_of[c0, kind]
                w = kite[v0]
                wsum = w.sum()
                if not wsum > 0:
                    raise ValueError("a vertex of the lattice has no kite area")
                total = 0.0
                for s in range(cov.shape[1]):
                    if w[s] == 0.0:
                        continue
                    p_in, dm, di_ = self._cell_offset(c0, cov[v0, s])
                    terms.append((kind, parity, p_in, dm, di_, float(w[s] / wsum)))
                    total += w[s] / wsum
                if abs(total - 1.0) >= 1e-12:
                    raise ValueError("the kite weights are not a partition of unity")
        return tuple(terms)

    def _extract_edge_vertex_stencil(self) -> tuple:
        """The edge's two vertex endpoints as static rolls: terms
        (f_out, p_out, kind, p_in, dm, di), two per (family, parity)."""
        voe = np.asarray(self.horz.edges.vertices_on_edge)
        terms = []
        for fam in (E, NE, NW):
            for parity in (0, 1):
                c0 = (2 + parity) * self.nx + 2
                e0 = self.edge_of[c0, fam]
                for vg in voe[e0]:
                    kind = int(self.vertex_kind[vg])
                    p_in, dm, di_ = self._cell_offset(c0, int(self.vertex_owner[vg]))
                    terms.append((fam, parity, kind, p_in, dm, di_))
        return tuple(terms)

    # ---- Coriolis stencil extraction ------------------------------------
    def _extract_coriolis_stencil(self) -> list[CoriolisTerm]:
        """Machine-derive the 10-term tangential-reconstruction stencil per
        (family, parity) class from the unstructured weightsOnEdge."""
        horz = self.horz
        nx = self.nx
        eoe = np.asarray(horz.edges.edges_on_edge)
        w = np.asarray(horz.edges.weights_on_edge)
        n_eoe = np.asarray(horz.edges.n_edges_on_edge)

        terms: list[CoriolisTerm] = []
        for fam in (E, NE, NW):
            for parity in (0, 1):
                # representative cell well inside the lattice
                j0, i0 = 2 + parity, 2
                c0 = j0 * nx + i0
                e0 = self.edge_of[c0, fam]
                if self.edge_flip[c0, fam] != 1.0:
                    raise ValueError("interior representative must be canonical")
                w_scale = np.abs(w[e0, : n_eoe[e0]]).max()
                for s in range(n_eoe[e0]):
                    g = eoe[e0, s]
                    wg = w[e0, s]
                    if abs(wg) <= 1e-12 * w_scale:
                        # the cell-opposite edge's TRiSK weight is zero on
                        # uniform hexagons up to f64 roundoff in the kite-area
                        # sums; dropping those taps leaves 60 of 72 terms
                        continue
                    cg = self.edge_owner[g]
                    fg = self.edge_family[g]
                    jg, ig = cg // nx, cg % nx
                    dj, di_ = jg - j0, ig - i0
                    if self.edge_flip[cg, fg] != 1.0:
                        raise ValueError("stencil edge is not canonical")
                    p_in = (j0 + dj) % 2
                    dm = (j0 + dj) // 2 - j0 // 2
                    terms.append(
                        CoriolisTerm(
                            f_out=fam,
                            p_out=parity,
                            f_in=int(fg),
                            p_in=int(p_in),
                            dm=int(dm),
                            di=int(di_),
                            w=float(wg),
                        )
                    )
        return terms
