"""The core's step on halo-padded windows, and its q-step superstep.

Counterpart of mpas_ocean_tpu/structured/sharded.py:44-62,156-342
(``_sh``, ``_interior``, ``_flux_thickness``, ``_step_slab`` with the wall
masks, the momentum forcing (``_apply_forcing``, :134-153), the tracers
with their cell mask (:294-340) and the layered stratification (``strat_w``,
:242-257)), of
sharded.py:345-597 for the nonlinear core (``_derived_slab``,
``_nl_continuity``, ``_apply_slab_nonlinear``, ``_step_slab_nl``) and of
pallas_model.py:791-849 (``_reach``, ``_window_steps`` with ``masks_full``
and ``fv_full``), for the forward Euler (FE) and forward-backward (FB)
steppers.

The JAX windows are whole rows, padded in m and wrapped periodically in i
(``_roll_nx``). The port's windows are tiles padded in both m and i, so the
wrap becomes an i-halo: a window that spans all nx columns and is padded
periodically in i gives the JAX interior.

Fields carry a channel axis and any leading batch axes, with ssh, f_edge,
the wall mask, rts and the vertex constants kept as trailing singletons as
in the JAX slabs: ssh and rts (..., 2, R, C, 1), h (..., 2, R, C, K), u,
f_edge and the mask (..., 6, R, C, K or 1), the vertex constants (..., 4 or
20, R, C, 1) (``fused_model.nl_setup``), edge channel ``family * 2 +
parity``, vertex channel ``kind * 2 + parity``. The mask and the vertex
constants are windowed as f_edge is, and so is the forcing: ``forc`` =
(wind (..., 6, R, C, 1), level indices (..., 12, R, C, 1) int = [top x 6;
bottom x 6] of ``fused_model.forcing_setup``, r_lin, Cd, lambda), or in
place of the indices the dense one-hot level masks (..., 12, R, C, K) in
the state dtype (the sharded per-step path's, which differentiates them, as
sharded._apply_forcing takes dense masks). Tracers
ride as planes [t * 2 + parity] (..., 2 nT, R, C, K), as the kernels take
them (``fused_model.tracer_planes``), with the cell mask (..., 2, R, C, 1)
of a channel windowed as rts.
"""

from __future__ import annotations

import torch

from ..constants import GRAVITY
from ..models.forcing import forcing_core, level_onehot
from .hex_layout import E, NE, NW
from .stencils import (
    INCOMING,
    NEIGHBOR,
    transpose_coriolis_terms,
    transpose_curl_terms,
    transpose_endpoint_terms,
    transpose_kite_terms,
)

__all__ = ["adjoint_stencil_reach", "apply_forcing", "derived_ring", "derived_slab",
           "nl_adjoint_rings", "nl_continuity", "nl_momentum", "pressure", "reach",
           "stencil_reach", "step_slab", "step_slab_nl", "tracer_update", "window_steps"]


def reach(fb: bool, nonlinear: bool = False) -> int:
    """Halo rows a step consumes per side (pallas_model._reach): 1 for the
    linear FE; 2 for the linear FB, whose pressure gradient reads the fresh
    ssh one ring out, and for the nonlinear FE, whose derived fields (flux,
    KE, edge PV) are computed on a 1-padded window; 3 for the nonlinear FB,
    whose fresh thickness needs that flux one ring further out."""
    if nonlinear:
        return 3 if fb else 2
    return 2 if fb else 1


def _continuity_taps():
    """(dm, di) of every cell that a cell's continuity update reads: the
    neighbours across its owned edges, and each incoming edge's two cells."""
    taps = [(dm, di) for (_, dm, di) in NEIGHBOR.values()]
    for p in (0, 1):
        for ch, dm, di in INCOMING[p]:
            _, dmn, din = NEIGHBOR[divmod(ch, 2)]
            taps += [(dm, di), (dm + dmn, di + din)]
    return taps


def _max_reach(taps) -> tuple[int, int]:
    return max(abs(dm) for dm, _ in taps), max(abs(di) for _, di in taps)


def _sums(a, b):
    return [(x + z, y + w) for x, y in a for z, w in b]


def _grad_taps():
    return [(0, 0)] + [(dm, di) for (_, dm, di) in NEIGHBOR.values()]


def _derived_taps(nl_terms):
    """(dm, di) of every state value that a site's derived fields read: the
    flux's neighbour cells, KE's incoming edges, and for the edge PV each
    endpoint vertex's curl edges and kite cells."""
    vc_terms, ev_terms = nl_terms
    vertex = [(0, 0), (0, -1), (1, 0), (0, 1)] + [(t[3], t[4]) for t in vc_terms]
    return (_continuity_taps() + [(0, 0)]
            + _sums([(t[4], t[5]) for t in ev_terms], vertex))


def derived_ring(terms, fb: bool) -> tuple[int, int]:
    """(rows, columns) per side of the ring around a window's interior on
    which the nonlinear step computes its derived fields (flux, F q_e, q_e,
    KE): what the interior's momentum and continuity read of them (the flux
    at the incoming edges, KE across the owned ones, the Coriolis taps of
    the two tangential passes), and under FB the flux that the fresh
    thickness reads on the interior plus the ring of the pressure gradient.
    Each stage computes on a region padded alike on every side, so the
    stages' reaches add: (1, 2) for FE, (2, 2) for FB on the hex lattice."""
    inc = [(0, 0)] + [(dm, di) for p in (0, 1) for (_, dm, di) in INCOMING[p]]
    rm, rc = _max_reach(inc + _grad_taps() + [(t[4], t[5]) for t in terms])
    if fb:
        (gm, gc), (im, ic) = _max_reach(_grad_taps()), _max_reach(inc)
        rm, rc = max(rm, gm + im), max(rc, gc + ic)
    return rm, rc


def stencil_reach(terms, fb: bool, nl_terms=None) -> tuple[int, int]:
    """(rows, columns) a step consumes per side, from the neighbour,
    incoming-edge and Coriolis tables: the halo a window needs per step.
    FB chains the pressure gradient (the neighbour table) onto the
    continuity update of the fresh ssh. With ``nl_terms`` = (vertex_cell_terms,
    edge_vertex_terms) the nonlinear step's: the derived fields' reach added
    to their ring's (``derived_ring``; (2, 4) for FE, (3, 4) for FB on the hex
    lattice, the rows of pallas_model._reach)."""
    if nl_terms is not None:
        (rm, rc), (am, ac) = derived_ring(terms, fb), _max_reach(_derived_taps(nl_terms))
        return rm + am, rc + ac
    grad = [(dm, di) for (_, dm, di) in NEIGHBOR.values()]
    cont = _continuity_taps()
    taps = cont + grad + [(t[4], t[5]) for t in terms]
    if fb:
        taps += [(a + c, b + d) for a, b in grad for c, d in cont]
    return _max_reach(taps)


def adjoint_stencil_reach(terms, nl_terms=None) -> tuple[int, int]:
    """(rows, columns) one reverse step reads per side, from the same tables
    (structured/adjoint.py): G = gh + gs at the neighbours across the owned
    edges and at the incoming edges' own cells, u and gu at the incoming
    edges (u * dG and S_e = sum_k gu_e), both of which ``_continuity_taps``
    lists, and the transposed Coriolis taps. With ``nl_terms`` =
    (vertex_cell_terms, edge_vertex_terms) the nonlinear reverse's primal
    window (``nl_adjoint_rings``)."""
    if nl_terms is not None:
        return nl_adjoint_rings(terms, nl_terms)[-1]
    taps = _continuity_taps() + [(t[4], t[5]) for t in transpose_coriolis_terms(terms)]
    return max(abs(dm) for dm, _ in taps), max(abs(di) for _, di in taps)


def _grown(*reaches) -> tuple[int, int]:
    return sum(r[0] for r in reaches), sum(r[1] for r in reaches)


def _widest(*reaches) -> tuple[int, int]:
    return max(r[0] for r in reaches), max(r[1] for r in reaches)


def nl_adjoint_rings(terms, nl_terms):
    """The rings (rows, columns) per side around a tile on which the
    nonlinear reverse step (structured/adjoint.structured_nl_adjoint_step,
    in gather form: each site computes its own cotangent) computes its
    stages, from the tables: (C, B, A, window). D, on the tile, reads dF at
    the own and incoming edges, dKE across the owned ones, the curl's and
    the kite's transposes of the vertex cotangents (C's ring); C, the vertex
    cotangents from dq_e through the endpoint mean's transpose (B's ring);
    B, dq_e, dF and dKE from F and q_e through the Coriolis taps and their
    transposes (A's ring); A, F and q_e from the state through the derived
    taps (the window). The cotangent reaches B's ring grown by the
    transposed taps and the continuity taps, inside the window. (1, 1),
    (2, 2), (3, 4), (4, 6) on the hex lattice (csrc/nl_adjoint.cuh)."""
    vc_terms, ev_terms = nl_terms
    own = [(0, 0)] + _grad_taps() + [(dm, di) for p in (0, 1) for (_, dm, di) in INCOMING[p]]
    vert = [(t[3], t[4]) for t in transpose_curl_terms()] + [
        (t[3], t[4]) for t in transpose_kite_terms(vc_terms)]
    ring_c = _max_reach([(0, 0)] + vert)
    ring_b = _widest(_max_reach(own), _grown(ring_c, _max_reach(
        [(t[4], t[5]) for t in transpose_endpoint_terms(ev_terms)])))
    tangential = [(t[4], t[5]) for t in terms] + [
        (t[4], t[5]) for t in transpose_coriolis_terms(terms)]
    ring_a = _grown(ring_b, _max_reach(tangential))
    cot = _grown(ring_b, _max_reach(tangential + own))
    window = _widest(_grown(ring_a, _max_reach(_derived_taps(nl_terms))), cot,
                     _grown(ring_c, _max_reach(vert)))
    return ring_c, ring_b, ring_a, window


def _sh(x, dm: int, di: int, reg):
    """out[m, i] = x[r0 + m + dm, c0 + i + di] over the region
    reg = (r0, r1, c0, c1) of a padded plane (..., R, C, K)."""
    r0, r1, c0, c1 = reg
    return x[..., r0 + dm : r1 + dm, c0 + di : c1 + di, :]


def _interior(x, reg):
    return _sh(x, 0, 0, reg)


def _flux_thickness(h, u, rts, dt, s_div, reg):
    """Continuity update on the region ``reg`` of padded planes: the
    thickness flux u * (h_nbr + h) / 2 out through the owned edges and in
    through the incoming ones (read one ring around ``reg``), then h' and
    ssh' = sum_k h' - rts. Returns (h', ssh') stacked over parity."""
    h_new, ssh_new = [], []
    for p in (0, 1):
        hc = _interior(h[..., p, :, :, :], reg)
        total = None
        for fam in (E, NE, NW):
            pin, dm, di = NEIGHBOR[(fam, p)]
            he = 0.5 * (_sh(h[..., pin, :, :, :], dm, di, reg) + hc)
            fl = _interior(u[..., fam * 2 + p, :, :, :], reg) * he
            total = fl if total is None else total + fl
        for ch, dm, di in INCOMING[p]:
            pn, dmn, din = NEIGHBOR[divmod(ch, 2)]
            he = 0.5 * (_sh(h[..., pn, :, :, :], dm + dmn, di + din, reg)
                        + _sh(h[..., ch % 2, :, :, :], dm, di, reg))
            total = total - _sh(u[..., ch, :, :, :], dm, di, reg) * he
        hp = hc - (dt * s_div) * total
        h_new.append(hp)
        ssh_new.append(hp.sum(-1, keepdim=True) - _interior(rts[..., p, :, :, :], reg))
    return h_new, ssh_new


def apply_forcing(un, u, h, forc, dt, c, reg):
    """un + dt F for edge channel c on the region ``reg``: the forcing
    ``forc`` (module docstring; sharded._apply_forcing) of the old u on the
    old h_edge, integer level indices expanded to one-hot masks
    (``level_onehot``), dense masks taken as they are."""
    wind, idx, dlin, dquad, rayl = forc
    fam, p = divmod(c, 2)
    pin, dm, di = NEIGHBOR[(fam, p)]
    he = 0.5 * (_sh(h[..., pin, :, :, :], dm, di, reg) + _interior(h[..., p, :, :, :], reg))
    u_i = _interior(u[..., c, :, :, :], reg)
    top, bot = (_interior(idx[..., o + c, :, :, :], reg) for o in (0, 6))
    if not idx.is_floating_point():
        top, bot = level_onehot(top, u_i), level_onehot(bot, u_i)
    return un + dt * forcing_core(u_i, he, _interior(wind[..., c, :, :, :], reg), top, bot,
                                  dlin, dquad, rayl)


def tracer_update(h, u, tr, h_new, dt, inv_dc, s_div, kappa, upwind, reg, mask=None,
                  cmask=None):
    """The tracers' new concentrations over the region ``reg`` (sharded.
    _step_slab, :294-340): per tracer t and parity p, the tracer edge flux
    G = F T_e - kappa h_e m (T_n - T_p) / dc of the old state on the cell's
    three owned edges and its three incoming ones, T_e = (T_n + T_p) / 2 -
    (upwind / 2) sign(F) (T_n - T_p), F = u h_e; the content h T - dt
    (dv / A) (sum of the owned G - sum of the incoming G); divided by the
    fresh h' (``h_new``, a list of two planes over ``reg``), or on a channel
    (``cmask``, padded as rts) by 1 on culled cells, times the mask. ``tr``
    holds planes [t * 2 + p]; kappa = 0 and upwind = 0 skip their terms.
    Returns the planes over ``reg`` as a list."""
    def plane(x, c):
        return x[..., c, :, :, :]

    out = []
    for t in range(tr.shape[-4] // 2):
        def g_edge(ch, dm, di):
            """G of edge channel ch at the region shifted by (dm, di)."""
            pn, dmn, din = NEIGHBOR[divmod(ch, 2)]
            p = ch % 2
            he = 0.5 * (_sh(plane(h, pn), dm + dmn, di + din, reg) + _sh(plane(h, p), dm, di, reg))
            flux = _sh(plane(u, ch), dm, di, reg) * he
            tn = _sh(plane(tr, 2 * t + pn), dm + dmn, di + din, reg)
            tp = _sh(plane(tr, 2 * t + p), dm, di, reg)
            te = 0.5 * (tn + tp)
            if upwind:
                te = te - (0.5 * upwind) * torch.sign(flux) * (tn - tp)
            g = flux * te
            if kappa:
                diff = kappa * he
                if mask is not None:
                    diff = diff * _sh(plane(mask, ch), dm, di, reg)
                g = g - diff * ((tn - tp) * inv_dc)
            return g

        for p in (0, 1):
            total = None
            for fam in (E, NE, NW):
                g = g_edge(fam * 2 + p, 0, 0)
                total = g if total is None else total + g
            for ch, dm, di in INCOMING[p]:
                total = total - g_edge(ch, dm, di)
            content = (_interior(plane(h, p), reg) * _interior(plane(tr, 2 * t + p), reg)
                       - (dt * s_div) * total)
            if cmask is None:
                out.append(content / h_new[p])
            else:
                cm = _interior(plane(cmask, p), reg)
                out.append(content / torch.where(cm > 0, h_new[p], torch.ones_like(h_new[p]))
                           * cm)
    return out


def pressure(pg_ssh, pg_h, dt, strat_w):
    """(planes, scale) of the pressure gradient (sharded._step_slab,
    :242-257): the ssh planes and -g dt, or with ``strat_w`` (K, K) each
    parity's Montgomery potential g ssh + h @ W on the same padded planes
    and -dt. ``pg_ssh`` and ``pg_h`` are lists of the two parities'
    planes."""
    if strat_w is None:
        return pg_ssh, -GRAVITY * dt
    return [GRAVITY * pg_ssh[p] + torch.matmul(pg_h[p], strat_w) for p in (0, 1)], -dt


def step_slab(ssh, h, u, f_edge, rts, dt, inv_dc, s_div, terms, rows, cols, halo,
              fb=False, mask=None, forc=None, tr=None, tropts=(0.0, 1.0), cmask=None,
              strat_w=None):
    """One FE or FB step of the linear core on windows padded by
    ``halo`` = (rows, columns) per side (``stencil_reach``); returns the
    (rows, cols) interiors (ssh, h, u), and the tracers' fourth where ``tr``
    (planes [t * 2 + p], padded as h) is given. Mirrors sharded._step_slab:
    FB runs the continuity update on the 1-padded interior and takes the
    pressure gradient of that fresh ssh; the Coriolis term reads the old u.
    The forcing ``forc`` (module docstring, or None) adds dt F of the old u
    and h_edge to u'; the wall ``mask`` (padded as f_edge, or None)
    multiplies u' last. The tracers (``tracer_update``, ``tropts`` = (kappa,
    upwind), ``cmask`` the cell mask padded as rts or None) take the old
    state's flux, FE and FB alike, and the fresh h'. ``strat_w`` (K, K, in
    the state dtype, or None) takes the pressure gradient from the layers'
    Montgomery potential of the old planes (FE) or the fresh 1-padded ones
    (FB) with scale -dt (sharded.py:242-257)."""
    hm, hi = halo
    inner = (hm, hm + rows, hi, hi + cols)
    if fb:
        fresh = (hm - 1, hm + rows + 1, hi - 1, hi + cols + 1)
        h_pad, ssh_pad = _flux_thickness(h, u, rts, dt, s_div, fresh)
        pg_reg = (1, rows + 1, 1, cols + 1)
        h_new = [_interior(x, pg_reg) for x in h_pad]
        ssh_new = [_interior(x, pg_reg) for x in ssh_pad]
        pg, pg_scale = pressure(ssh_pad, h_pad, dt, strat_w)
    else:
        h_new, ssh_new = _flux_thickness(h, u, rts, dt, s_div, inner)
        pg, pg_scale = pressure([ssh[..., p, :, :, :] for p in (0, 1)],
                                 [h[..., p, :, :, :] for p in (0, 1)], dt, strat_w)
        pg_reg = inner

    uf = u * f_edge
    acc = [None] * 6
    for f_out, p_out, f_in, p_in, dm, di, w in terms:
        contrib = w * _sh(uf[..., f_in * 2 + p_in, :, :, :], dm, di, inner)
        c = f_out * 2 + p_out
        acc[c] = contrib if acc[c] is None else acc[c] + contrib
    u_new = []
    for fam in (E, NE, NW):
        for p in (0, 1):
            c = fam * 2 + p
            pin, dm, di = NEIGHBOR[(fam, p)]
            grad = (_sh(pg[pin], dm, di, pg_reg) - _interior(pg[p], pg_reg)) * inv_dc
            un = _interior(u[..., c, :, :, :], inner) + dt * acc[c] + pg_scale * grad
            if forc is not None:
                un = apply_forcing(un, u, h, forc, dt, c, inner)
            if mask is not None:
                un = un * _interior(mask[..., c, :, :, :], inner)
            u_new.append(un)
    new = [ssh_new, h_new, u_new]
    if tr is not None:
        new.append(tracer_update(h, u, tr, h_new, dt, inv_dc, s_div, *tropts, inner, mask,
                                 cmask))
    return tuple(torch.stack(x, dim=-4) for x in new)


def _grow(reg, rows: int, cols: int):
    r0, r1, c0, c1 = reg
    return (r0 - rows, r1 + rows, c0 - cols, c1 + cols)


def _extent(reg):
    r0, r1, c0, c1 = reg
    return r1 - r0, c1 - c0


def derived_slab(h, u, fv, s_ke, s_curl, vc_terms, ev_terms, reg):
    """Stage A of the nonlinear step (sharded._derived_slab): from padded
    state planes, the thickness flux F (6 channels), the cell kinetic energy
    (2 planes) and the edge PV q_e (6 channels) over the region ``reg`` =
    (r0, r1, c0, c1). The vertex PV is computed on ``reg`` grown by the
    endpoint taps' reach, from the curl of u and the kite average of h,
    with the static kite weights, or on a channel (``fv`` of 20 planes:
    f_vertex, vertex_mask, kite planes) the live-renormalised ones and the
    guarded division. Returns (F, KE, q_e) as lists of planes over ``reg``."""
    flux = []
    for fam in (E, NE, NW):
        for p in (0, 1):
            pin, dm, di = NEIGHBOR[(fam, p)]
            he = 0.5 * (_sh(h[..., pin, :, :, :], dm, di, reg) + _interior(h[..., p, :, :, :], reg))
            flux.append(_interior(u[..., fam * 2 + p, :, :, :], reg) * he)
    sq = u * u
    ke = []
    for p in (0, 1):
        total = (_interior(sq[..., E * 2 + p, :, :, :], reg)
                 + _interior(sq[..., NE * 2 + p, :, :, :], reg)
                 + _interior(sq[..., NW * 2 + p, :, :, :], reg))
        for ch, dm, di in INCOMING[p]:
            total = total + _sh(sq[..., ch, :, :, :], dm, di, reg)
        ke.append(total * s_ke)

    # vertex PV on reg grown by the endpoint taps (rows dm_lo..dm_hi, columns
    # di_lo..di_hi of a site)
    lo_m = max(0, -min(t[4] for t in ev_terms))
    lo_i = max(0, -min(t[5] for t in ev_terms))
    r0, r1, c0, c1 = reg
    vreg = (r0 - lo_m, r1 + max(0, max(t[4] for t in ev_terms)),
            c0 - lo_i, c1 + max(0, max(t[5] for t in ev_terms)))
    uc = lambda ch, dm=0, di=0: _sh(u[..., ch, :, :, :], dm, di, vreg)  # noqa: E731
    # curl_A = (u_NE - u_E(NW) - u_NW) dc / A_tri, curl_B = (u_E + u_NW(E) -
    # u_NE) dc / A_tri (model.curl_on_vertex, slab form)
    zeta = [
        (uc(NE * 2) - uc(E * 2 + 1, 0, -1) - uc(NW * 2)) * s_curl,
        (uc(NE * 2 + 1) - uc(E * 2, 1, 0) - uc(NW * 2 + 1)) * s_curl,
        (uc(E * 2) + uc(NW * 2, 0, 1) - uc(NE * 2)) * s_curl,
        (uc(E * 2 + 1) + uc(NW * 2 + 1, 0, 1) - uc(NE * 2 + 1)) * s_curl,
    ]
    masked = fv.shape[-4] > 4
    h_v = [None] * 4
    for t, (kind, p_out, p_in, dm, di, w) in enumerate(vc_terms):
        wgt = _interior(fv[..., 8 + t, :, :, :], vreg) if masked else w
        contrib = wgt * _sh(h[..., p_in, :, :, :], dm, di, vreg)
        c = kind * 2 + p_out
        h_v[c] = contrib if h_v[c] is None else h_v[c] + contrib
    q_v = []
    for c in range(4):
        num = _interior(fv[..., c, :, :, :], vreg) + zeta[c]
        if masked:
            vm = _interior(fv[..., 4 + c, :, :, :], vreg)
            q_v.append(num / torch.where(vm > 0, h_v[c], torch.ones_like(h_v[c])) * vm)
        else:
            q_v.append(num / h_v[c])
    nrows, ncols = _extent(reg)
    local = (lo_m, lo_m + nrows, lo_i, lo_i + ncols)
    q_e = [None] * 6
    for f_out, p_out, kind, p_in, dm, di in ev_terms:
        contrib = _sh(q_v[kind * 2 + p_in], dm, di, local)
        c = f_out * 2 + p_out
        q_e[c] = contrib if q_e[c] is None else q_e[c] + contrib
    return flux, ke, [0.5 * x for x in q_e]


def nl_continuity(h, flux, rts, dt, s_div, reg, dreg):
    """h' and ssh' = sum_k h' - rts over ``reg`` (sharded._nl_continuity):
    the flux out through the owned edges and in through the incoming ones,
    read from planes over ``dreg`` (a region around ``reg``); h and rts
    are padded planes. Returns (h', ssh') lists over parity."""
    r0, r1, c0, c1 = reg
    local = (r0 - dreg[0], r1 - dreg[0], c0 - dreg[2], c1 - dreg[2])
    h_new, ssh_new = [], []
    for p in (0, 1):
        total = (_interior(flux[E * 2 + p], local) + _interior(flux[NE * 2 + p], local)
                 + _interior(flux[NW * 2 + p], local))
        for ch, dm, di in INCOMING[p]:
            total = total - _sh(flux[ch], dm, di, local)
        hp = _interior(h[..., p, :, :, :], reg) - (dt * s_div) * total
        h_new.append(hp)
        ssh_new.append(hp.sum(-1, keepdim=True) - _interior(rts[..., p, :, :, :], reg))
    return h_new, ssh_new


def nl_momentum(u, h, flux, ke, q_e, dt, inv_dc, terms, inner, local, pg, pg_scale, pg_reg,
                mask=None, forc=None):
    """Stage B's momentum (sharded._apply_slab_nonlinear, :505-543): u' = u
    + dt (q_e T(F) / 2 + T(F q_e) / 2 - grad KE) + pg_scale grad pg over the
    region ``inner`` of the padded state planes u and h, from the derived
    planes F, KE and q_e (lists) read around ``local``, their region of
    ``inner``, and the pressure planes ``pg`` read around ``pg_reg``; the
    forcing ``forc`` adds dt F of the old u and h_edge, the wall ``mask``
    multiplies u' last. Returns the six channels' planes as a list."""
    def tangential(x):
        acc = [None] * 6
        for f_out, p_out, f_in, p_in, dm, di, w in terms:
            contrib = w * _sh(x[f_in * 2 + p_in], dm, di, local)
            c = f_out * 2 + p_out
            acc[c] = contrib if acc[c] is None else acc[c] + contrib
        return acc

    w_flux = tangential(flux)
    w_fq = tangential([flux[c] * q_e[c] for c in range(6)])
    u_new = []
    for fam in (E, NE, NW):
        for p in (0, 1):
            c = fam * 2 + p
            pin, dm, di = NEIGHBOR[(fam, p)]
            grad_ke = (_sh(ke[pin], dm, di, local) - _interior(ke[p], local)) * inv_dc
            grad = (_sh(pg[pin], dm, di, pg_reg) - _interior(pg[p], pg_reg)) * inv_dc
            pv = 0.5 * (_interior(q_e[c], local) * w_flux[c] + w_fq[c])
            un = _interior(u[..., c, :, :, :], inner) + dt * (pv - grad_ke) + pg_scale * grad
            if forc is not None:
                un = apply_forcing(un, u, h, forc, dt, c, inner)
            if mask is not None:
                un = un * _interior(mask[..., c, :, :, :], inner)
            u_new.append(un)
    return u_new


def step_slab_nl(ssh, h, u, fv, rts, dt, inv_dc, s_div, s_ke, s_curl, terms, vc_terms,
                 ev_terms, rows, cols, halo, fb=False, mask=None, forc=None, tr=None,
                 tropts=(0.0, 1.0), cmask=None, strat_w=None):
    """One nonlinear FE or FB step on windows padded by ``halo`` = (rows,
    columns) per side (``stencil_reach`` with the vertex taps); returns the
    (rows, cols) interiors (ssh, h, u). Mirrors sharded._step_slab_nl:
    stage A (``derived_slab``) on the interior plus ``derived_ring``'s ring,
    then for FB the fresh h and ssh one ring out (``nl_continuity``), then
    u' = u + dt (q_e T(F) / 2 + T(F q_e) / 2 - grad KE) + pg_scale grad ssh,
    the pressure from the old ssh (FE) or the fresh one (FB), every other
    term from the old state; the forcing ``forc`` (as for ``step_slab``) adds
    dt F of the old u and h_edge; the wall ``mask`` (padded as f_edge, or
    None) multiplies u' last; the tracers ``tr`` and ``strat_w`` as for
    ``step_slab`` (the tracers a fourth item returned)."""
    hm, hi = halo
    rm, rc = derived_ring(terms, fb)
    inner = (hm, hm + rows, hi, hi + cols)
    dreg = _grow(inner, rm, rc)
    flux, ke, q_e = derived_slab(h, u, fv, s_ke, s_curl, vc_terms, ev_terms, dreg)
    local = (rm, rm + rows, rc, rc + cols)  # the interior in dreg's planes
    if fb:
        h_pad, ssh_pad = nl_continuity(h, flux, rts, dt, s_div, _grow(inner, 1, 1), dreg)
        pg_reg = (1, rows + 1, 1, cols + 1)
        h_new = [_interior(x, pg_reg) for x in h_pad]
        ssh_new = [_interior(x, pg_reg) for x in ssh_pad]
        pg, pg_scale = pressure(ssh_pad, h_pad, dt, strat_w)
    else:
        h_new, ssh_new = nl_continuity(h, flux, rts, dt, s_div, inner, dreg)
        pg, pg_scale = pressure([ssh[..., p, :, :, :] for p in (0, 1)],
                                 [h[..., p, :, :, :] for p in (0, 1)], dt, strat_w)
        pg_reg = inner

    u_new = nl_momentum(u, h, flux, ke, q_e, dt, inv_dc, terms, inner, local, pg, pg_scale,
                        pg_reg, mask, forc)
    new = [ssh_new, h_new, u_new]
    if tr is not None:
        new.append(tracer_update(h, u, tr, h_new, dt, inv_dc, s_div, *tropts, inner, mask,
                                 cmask))
    return tuple(torch.stack(x, dim=-4) for x in new)


def window_steps(ssh, h, u, f_full, rts_full, dt, inv_dc, s_div, terms, *, rows, cols,
                 q, halo, fb=False, mask_full=None, fv_full=None, nl=None, forc_full=None,
                 tr=None, tropts=(0.0, 1.0), cmask_full=None, strat_w=None):
    """Advance windows by q steps (pallas_model._window_steps): the state
    arrives padded by q halos per side and shrinks by one halo per side per
    step; the constant fields, the wall mask ``mask_full`` (None on a
    periodic lattice) and the vertex constants ``fv_full`` among them, are
    cut to each step's window. ``nl`` = (s_ke, s_curl, vertex_cell_terms,
    edge_vertex_terms) runs the nonlinear step (``step_slab_nl``, on a halo
    from ``stencil_reach`` with the vertex taps), None the linear one.
    ``forc_full`` (module docstring; its wind and level planes padded as
    f_edge) forces the steps, linear or nonlinear. ``tr`` (tracer planes
    padded as h) is carried with ``tropts`` = (kappa, upwind) and the cell
    mask ``cmask_full`` (padded as rts, or None). ``strat_w`` (K, K) takes
    each step's pressure from the layers' Montgomery potential (sharded.py:
    242-257). Returns the (rows, cols) interiors (ssh, h, u), and the
    tracers' fourth where ``tr`` is given."""
    hm, hi = halo
    full_m, full_i = rows + 2 * hm * q, cols + 2 * hi * q
    for j in range(q):
        om, oi = hm * j, hi * j
        win = (om, full_m - om, oi, full_i - oi)
        r_j, c_j = rows + 2 * hm * (q - 1 - j), cols + 2 * hi * (q - 1 - j)
        mask_j = None if mask_full is None else _interior(mask_full, win)
        cmask_j = None if cmask_full is None else _interior(cmask_full, win)
        forc_j = None if forc_full is None else (
            _interior(forc_full[0], win), _interior(forc_full[1], win), *forc_full[2:])
        if nl is not None:
            s_ke, s_curl, vc_terms, ev_terms = nl
            ssh, h, u, *rest = step_slab_nl(
                ssh, h, u, _interior(fv_full, win), _interior(rts_full, win), dt, inv_dc,
                s_div, s_ke, s_curl, terms, vc_terms, ev_terms, r_j, c_j, halo, fb, mask_j,
                forc_j, tr, tropts, cmask_j, strat_w)
        else:
            ssh, h, u, *rest = step_slab(
                ssh, h, u, _interior(f_full, win), _interior(rts_full, win),
                dt, inv_dc, s_div, terms, r_j, c_j, halo, fb, mask_j, forc_j, tr, tropts,
                cmask_j, strat_w)
        tr = rest[0] if rest else None
    return (ssh, h, u) if tr is None else (ssh, h, u, tr)
