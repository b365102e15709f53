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


# The curl at the vertex planes (model.curl_on_vertex), one term (kind, p,
# channel_in, dm, di, sign) per u read, in the model's order:
# curl_A(p) = u_NE - u_E(NW) - u_NW, curl_B(p) = u_E + u_NW(E) - u_NE, each
# times dc / A_tri. Vertex plane kind * 2 + p; edge channel family * 2 + parity.
CURL_TERMS = (
    (0, 0, NE * 2, 0, 0, 1), (0, 0, E * 2 + 1, 0, -1, -1), (0, 0, NW * 2, 0, 0, -1),
    (0, 1, NE * 2 + 1, 0, 0, 1), (0, 1, E * 2, 1, 0, -1), (0, 1, NW * 2 + 1, 0, 0, -1),
    (1, 0, E * 2, 0, 0, 1), (1, 0, NW * 2, 0, 1, 1), (1, 0, NE * 2, 0, 0, -1),
    (1, 1, E * 2 + 1, 0, 0, 1), (1, 1, NW * 2 + 1, 0, 1, 1), (1, 1, NE * 2 + 1, 0, 0, -1),
)


def _by_output(terms, key) -> tuple:
    return tuple(sorted(terms, key=key))  # stable: the forward order within an output


def transpose_curl_terms(terms=CURL_TERMS) -> tuple:
    """The curl's transpose, grouped by edge channel: (channel, kind, p, dm,
    di, sign) adds sign * y[kind, p] at (m + dm, i + di) to x[channel] at
    (m, i), y a vertex field (csrc/nl_adjoint.cuh, hex_vadj::curl_t)."""
    return _by_output(((ch, kind, p, -dm, -di, s) for (kind, p, ch, dm, di, s) in terms),
                      lambda t: t[0])


def transpose_kite_terms(vertex_cell_terms) -> tuple:
    """The kite average's transpose (model.cell_to_vertex_kite), grouped by
    cell plane: the kite tap t = (kind, p_out, p_in, dm, di, w) becomes
    (p_in, kind, p_out, -dm, -di, t), which adds w_t * y[kind, p_out] at
    (m - dm, i - di) to x[p_in] at (m, i); on a channel w_t is kite plane t
    at the vertex (csrc/nl_adjoint.cuh, hex_vadj::kite_t)."""
    return _by_output(((p_in, kind, p_out, -dm, -di, t)
                       for t, (kind, p_out, p_in, dm, di, _) in enumerate(vertex_cell_terms)),
                      lambda t: t[0])


def transpose_endpoint_terms(edge_vertex_terms) -> tuple:
    """The endpoint mean's transpose (model.vertex_to_edge_mean, without its
    factor 1/2), grouped by vertex plane: (f_out, p_out, kind, p_in, dm, di)
    becomes (kind, p_in, f_out, p_out, -dm, -di), which adds y[f_out, p_out]
    at (m - dm, i - di) to x[kind, p_in] at (m, i) (csrc/nl_adjoint.cuh,
    hex_vadj::ev_t)."""
    return _by_output(((kind, p_in, f_out, p_out, -dm, -di)
                       for (f_out, p_out, kind, p_in, dm, di) in edge_vertex_terms),
                      lambda t: t[0] * 2 + t[1])
