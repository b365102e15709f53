"""The linear core's step on halo-padded windows, and its q-step superstep.

Counterpart of mpas_ocean_tpu/structured/sharded.py:44-62,156-342
(``_sh``, ``_interior``, ``_flux_thickness``, ``_step_slab`` with the wall
masks, and with forcing, tracers, cell masks and stratification off) and of
pallas_model.py:791-849 (``_reach``, ``_window_steps`` with ``masks_full``),
for the forward Euler (FE) and forward-backward (FB) steppers.

The JAX windows are whole rows, padded in m and wrapped periodically in i
(``_roll_nx``). The port's windows are tiles padded in both m and i, so the
wrap becomes an i-halo: a window that spans all nx columns and is padded
periodically in i gives the JAX interior.

Fields carry a channel axis and any leading batch axes, with ssh, f_edge,
the wall mask and rts kept as trailing singletons as in the JAX slabs: ssh
and rts (..., 2, R, C, 1), h (..., 2, R, C, K), u, f_edge and the mask
(..., 6, R, C, K or 1), edge channel ``family * 2 + parity``. The mask is
windowed as f_edge is.
"""

from __future__ import annotations

import torch

from ..constants import GRAVITY
from .hex_layout import E, NE, NW
from .stencils import INCOMING, NEIGHBOR, transpose_coriolis_terms

__all__ = ["adjoint_stencil_reach", "reach", "stencil_reach", "step_slab", "window_steps"]


def reach(fb: bool) -> int:
    """Halo rows a step consumes per side (pallas_model._reach, linear
    arms): 1 for FE; 2 for FB, whose pressure gradient reads the fresh ssh
    one ring out."""
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


def stencil_reach(terms, fb: bool) -> tuple[int, int]:
    """(rows, columns) a step consumes per side, from the neighbour,
    incoming-edge and Coriolis tables: the halo a window needs per step.
    FB chains the pressure gradient (the neighbour table) onto the
    continuity update of the fresh ssh."""
    grad = [(dm, di) for (_, dm, di) in NEIGHBOR.values()]
    cont = _continuity_taps()
    taps = cont + grad + [(t[4], t[5]) for t in terms]
    if fb:
        taps += [(a + c, b + d) for a, b in grad for c, d in cont]
    return max(abs(dm) for dm, _ in taps), max(abs(di) for _, di in taps)


def adjoint_stencil_reach(terms) -> tuple[int, int]:
    """(rows, columns) one reverse step reads per side, from the same tables
    (structured/adjoint.py): G = gh + gs at the neighbours across the owned
    edges and at the incoming edges' own cells, u and gu at the incoming
    edges (u * dG and S_e = sum_k gu_e), both of which ``_continuity_taps``
    lists, and the transposed Coriolis taps."""
    taps = _continuity_taps() + [(t[4], t[5]) for t in transpose_coriolis_terms(terms)]
    return max(abs(dm) for dm, _ in taps), max(abs(di) for _, di in taps)


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


def step_slab(ssh, h, u, f_edge, rts, dt, inv_dc, s_div, terms, rows, cols, halo,
              fb=False, mask=None):
    """One FE or FB step of the linear core on windows padded by
    ``halo`` = (rows, columns) per side (``stencil_reach``); returns the
    (rows, cols) interiors (ssh, h, u). Mirrors sharded._step_slab: FB runs
    the continuity update on the 1-padded interior and takes the pressure
    gradient of that fresh ssh; the Coriolis term reads the old u. The wall
    ``mask`` (padded as f_edge, or None) multiplies u' last."""
    hm, hi = halo
    inner = (hm, hm + rows, hi, hi + cols)
    if fb:
        fresh = (hm - 1, hm + rows + 1, hi - 1, hi + cols + 1)
        h_pad, ssh_pad = _flux_thickness(h, u, rts, dt, s_div, fresh)
        pg_reg = (1, rows + 1, 1, cols + 1)
        h_new = [_interior(x, pg_reg) for x in h_pad]
        ssh_new = [_interior(x, pg_reg) for x in ssh_pad]
        pg = ssh_pad
    else:
        h_new, ssh_new = _flux_thickness(h, u, rts, dt, s_div, inner)
        pg = [ssh[..., p, :, :, :] for p in (0, 1)]
        pg_reg = inner
    pg_scale = -GRAVITY * dt

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
            if mask is not None:
                un = un * _interior(mask[..., c, :, :, :], inner)
            u_new.append(un)
    return tuple(torch.stack(x, dim=-4) for x in (ssh_new, h_new, u_new))


def window_steps(ssh, h, u, f_full, rts_full, dt, inv_dc, s_div, terms, *, rows, cols,
                 q, halo, fb=False, mask_full=None):
    """Advance windows by q steps (pallas_model._window_steps, linear arm):
    the state arrives padded by q halos per side and shrinks by one halo
    per side per step; the constant fields, the wall mask ``mask_full``
    (None on a periodic lattice) among them, are cut to each step's window.
    Returns the (rows, cols) interiors."""
    hm, hi = halo
    full_m, full_i = rows + 2 * hm * q, cols + 2 * hi * q
    for j in range(q):
        om, oi = hm * j, hi * j
        win = (om, full_m - om, oi, full_i - oi)
        ssh, h, u = step_slab(
            ssh, h, u, _interior(f_full, win), _interior(rts_full, win),
            dt, inv_dc, s_div, terms,
            rows + 2 * hm * (q - 1 - j), cols + 2 * hi * (q - 1 - j), halo, fb,
            None if mask_full is None else _interior(mask_full, win),
        )
    return ssh, h, u
