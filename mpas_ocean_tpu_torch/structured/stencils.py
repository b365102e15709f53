"""Fixed neighbour tables of the parity-plane lattice (counterpart of the
``_NEIGHBOR`` / ``_INCOMING`` tables of
mpas_ocean_tpu/structured/conv_model.py:31-45).

Edge channels are ``family * 2 + parity`` (6); cell planes are the parity
(2). A tap ``(plane_in, dm, di)`` reads the plane at ``(m + dm, i + di)``,
periodic.
"""

from .hex_layout import E, NE, NW

# neighbour cell across each owned edge: (plane_in, dm, di) per
# (family, parity_out)
NEIGHBOR = {
    (E, 0): (0, 0, 1),
    (E, 1): (1, 0, 1),
    (NE, 0): (1, 0, 0),
    (NE, 1): (0, 1, 1),
    (NW, 0): (1, 0, -1),
    (NW, 1): (0, 1, 0),
}

# incoming-edge taps of the divergence at cell plane p:
# (edge_channel_in, dm, di), entered with sign -1; the outgoing edges are the
# cell's own three channels (f * 2 + p, 0, 0)
INCOMING = {
    0: [(E * 2 + 0, 0, -1), (NE * 2 + 1, -1, -1), (NW * 2 + 1, -1, 0)],
    1: [(E * 2 + 1, 0, -1), (NE * 2 + 0, 0, 0), (NW * 2 + 0, 0, 1)],
}


def transpose_coriolis_terms(terms) -> tuple:
    """The transpose of a Coriolis stencil: a term (f_out, p_out, f_in, p_in,
    dm, di, w) adds w * x[f_in, p_in] at (m + dm, i + di) to out[f_out, p_out]
    at (m, i), so its transpose adds w * y[f_out, p_out] at (m - dm, i - di)
    to x[f_in, p_in] at (m, i). Packed by ``kernels.fe_step.pack_stencil``,
    it is the table the adjoint kernel gathers with."""
    return tuple(
        (f_in, p_in, f_out, p_out, -dm, -di, w)
        for (f_out, p_out, f_in, p_in, dm, di, w) in terms
    )
