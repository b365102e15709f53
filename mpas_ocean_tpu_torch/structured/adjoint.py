"""Reverse of the forward-Euler step, linear and nonlinear, written out by
hand on ``torch.roll``.

``structured_adjoint_step`` is the VJP of ``model.structured_step``: the
plain PyTorch version of the adjoint-step kernel (csrc/adjoint_step.cu) and
the CPU route of ``diff_model``. It is the counterpart of the in-kernel
``jax.vjp`` of ``_step_planes`` in the JAX package's
``_adjoint_segment_kernel`` (mpas_ocean_tpu/structured/pallas_model.py:
1545-1590), which CUDA does not have. For output cotangents (gs, gh, gu):

* G = gh + gs, broadcast over the levels (ssh' = sum_k h' - rts);
* the flux cotangent on each edge is dt * s_div * (G[nbr] - G[owner]);
* dh = G + 1/2 sum over the cell's 6 edges of u * (flux cotangent);
* du = gu + h_edge * (flux cotangent) + dt * f * (C^T gu), with C^T the
  transposed Coriolis stencil;
* dssh = (g dt / dc) * (owned minus incoming edge sums of sum_k gu): the input
  ssh enters the step only through its gradient;
* d(dt) = <G, tend_h> + <gu, tend_u>.

On a masked lattice (a coastal channel) the step ends u' = m * (u + dt *
tend_u), so the output cotangent gu enters as m * gu wherever it appears:
in C^T gu, in du's first term, in dssh's level sums and in d(dt).

``structured_nl_adjoint_step`` is the VJP of ``structured_step(nonlinear=True)``
(the vector-invariant arm of ``_step_planes``, pallas_model.py:172-242), the
plain version of the nonlinear reverse kernel (csrc/nl_adjoint.cuh). With
a = dt * gu (gu already m * gu on a channel), F = u * h_edge, q_v = (f_v +
zeta) / h_v, q_e the endpoint mean of q_v and T the Coriolis stencil without
f:

* the PV flux (q_e T(F) + T(F q_e)) / 2 gives dq_e = (a T(F) + F T^T(a)) / 2
  and dF = (T^T(a q_e) + q_e T^T(a)) / 2, plus the continuity's
  dt * s_div * (G[nbr] - G[owner]);
* dq_v = the endpoint mean's transpose of dq_e (1/2 per tap); then
  dzeta = dq_v / h_v and dh_v = -dq_v q_v / h_v, which reach u through the
  curl's transpose and h through the kite average's (on a channel the
  division guarded where the vertex mask is 0, both cotangents 0 there,
  and the kite weights the live-renormalised planes);
* -grad KE gives dKE_c = (sum_owned a - sum_incoming a) / dc, and
  du_e += 2 s_ke u_e (dKE_owner + dKE_nbr);
* dF reaches u as h_edge * dF and h as 1/2 sum over the cell's 6 edges of
  u * dF; dssh and d(dt) as in the linear step, d(dt) with the nonlinear
  tend_u.

The transposed vertex tables are stencils.transpose_curl_terms,
transpose_kite_terms and transpose_endpoint_terms.

With momentum forcing (``forcing=``, struct layout), u' gains dt F(u, h_e),
F = top w / h_e - bot (r u + Cd |u| u / h_e) - lambda u (models/forcing.py),
whose transpose is written out by hand as sharded._forcing_term_bwd
(sharded.py:108-128) does, with a = dt * gu and inv_h = 1 / h_e (1 where
h_e <= 0):

* du += a (-bot (r + 2 Cd |u| inv_h) - lambda);
* the h_edge cotangent gains a (top w - bot Cd |u| u) (-inv_h^2), 0 where
  h_e <= 0; it goes where the flux transpose's u * dF goes, half to each of
  the edge's two cells;
* d(dt) gains <gu, F>;
* d(wind) = sum over the levels of a top inv_h, per edge;
* d(r, Cd, lambda) = (-sum a bot u, -sum a bot |u| u inv_h, -sum a u).
The level masks get no cotangent (the JAX kernels return zeros for them).

With tracers (a state's ``tracers``, ``tracer_kappa=`` and ``tracer_upwind=``
as on the forward steps), the step also carries T' = c C / safe, C = h T -
dt s_div (sum_owned g - sum_incoming g), g_e = F_e te_e - kappa m_e he_e
(T_n - T_o) / dc, te_e = (T_n + T_o) / 2 - (upwind / 2) s_e (T_n - T_o), F_e =
u_e he_e, s_e = sign(F_e), c the cell mask (1 on a periodic lattice) and
safe = h' where c > 0, 1 elsewhere. Its transpose (``tracer_transpose``) for
the output cotangent gT' holds s_e fixed (as jax.vjp holds jnp.sign) and adds
to the linear or nonlinear transpose above, with a = c gT' / safe (the
content's cotangent):

* h' feeds back: G += -sum_t a T' (T' = C / safe where c > 0), before the
  continuity transpose reads G (its flux cotangent, dh, du and d(dt)'s
  <G, tend_h>);
* dh += sum_t a T and dT = a h, plus the edge terms;
* dg_e = dt s_div (a_n - a_o) joins the flux cotangent as sum_t dg_e te_e;
  dte_e = dg_e F_e gives dT_n += dte_e (1/2 - (upwind / 2) s_e) and dT_o +=
  dte_e (1/2 + (upwind / 2) s_e);
* the kappa term gives dT_n -= dg_e kappa m_e he_e / dc, dT_o += the same,
  and an h_edge cotangent -dg_e kappa m_e (T_n - T_o) / dc, half to each of the
  edge's cells, where the forcing's goes;
* d(dt) += sum_t <a, tend_T>, tend_T = -s_div (sum_owned g - sum_incoming g).

With layered stratification (``strat=``), the pressure term is -grad Phi,
Phi = g ssh + h @ W (``model.pressure_tendency``), of the old state under
either core. Its transpose (``pressure_transpose``), with a = dt * gu (m * gu
on a channel), per level k:

* dPhi_c,k = (sum_owned a_k - sum_incoming a_k) / dc;
* dssh = g sum_k dPhi_k (the formula above, unchanged);
* dh[c, l] += sum_k W[l, k] dPhi[c, k];
* d(W)[l, k] = sum_c h[c, l] dPhi[c, k], summed in double;
* d(dt) takes <gu, -grad Phi> in place of <gu, -g grad ssh>.
The densities get no cotangent: they build W on the host only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..constants import GRAVITY
from ..models.forcing import Forcing, forcing_tendency
from ..models.stratification import Stratification
from .hex_layout import E, NE, NW
from .model import (
    StructMesh,
    StructState,
    _forced,
    _incoming_edge_fields,
    _neighbor_cell_field,
    _shift,
    _tend_u,
    apply_stencil,
    cell_to_vertex_kite,
    check_nl_mesh,
    curl_on_vertex,
    div_on_cell,
    interp_cell_to_edge,
    pressure_tendency,
    structured_step,
    tangential_times_f,
    tangential_weights_only,
    tracer_tendency_struct,
    vertex_to_edge_mean,
)
from .stencils import (
    transpose_coriolis_terms,
    transpose_curl_terms,
    transpose_endpoint_terms,
    transpose_kite_terms,
)

__all__ = ["ForcingCot", "TracerCot", "forcing_transpose", "pressure_transpose", "strat_pass",
           "structured_adjoint_run_loop", "structured_adjoint_step", "structured_nl_adjoint_step",
           "tracer_transpose"]


class ForcingCot(NamedTuple):
    """The cotangent of a Forcing's differentiable parts: the wind (edges...)
    and (r_lin, Cd, lambda) as a (3,) tensor."""

    wind: torch.Tensor
    coefs: torch.Tensor

    def __add__(self, other: "ForcingCot") -> "ForcingCot":
        return ForcingCot(self.wind + other.wind, self.coefs + other.coefs)


def forcing_transpose(u, h_edge, gu, dt, forcing: Forcing):
    """The transpose of the forcing term dt F(u, h_edge) for its output
    cotangent gu (module docstring): (du, the h_edge cotangent, <gu, F>,
    ForcingCot)."""
    a = dt * gu
    top, bot = forcing.top_mask, forcing.bottom_mask
    wind = forcing.wind_edge[..., None]
    dlin, dquad, rayl = forcing.drag_linear, forcing.drag_quadratic, forcing.rayleigh
    pos = h_edge > 0
    one = torch.ones_like(h_edge)
    inv_h = one / torch.where(pos, h_edge, one)
    au = torch.abs(u)
    d_u = a * (-bot * (dlin + 2.0 * dquad * au * inv_h) - rayl)
    d_he = a * (top * wind - bot * (dquad * au * u)) * torch.where(
        pos, -inv_h * inv_h, torch.zeros_like(inv_h))
    coefs = torch.stack([-(a * bot * u).sum(), -(a * bot * au * u * inv_h).sum(),
                         -(a * u).sum()])
    d_dt = (gu * forcing_tendency(u, h_edge, forcing)).sum()
    return d_u, d_he, d_dt, ForcingCot((a * top * inv_h).sum(-1), coefs)


class TracerCot(NamedTuple):
    """What the tracer transpose adds to a step's reverse (module
    docstring): to G (the h' feedback), to the thickness flux's cotangent
    (3, 2, ny2, nx, K), to the h_edge cotangent, to dh (the content's
    h T), and the tracers' cotangent and d(dt)'s share."""

    g: torch.Tensor
    d_flux: torch.Tensor
    d_he: torch.Tensor
    d_h: torch.Tensor
    d_tracers: torch.Tensor
    d_dt: torch.Tensor


def tracer_transpose(state: StructState, h_new, g_tr, h_edge, mesh: StructMesh, dt,
                     kappa: float, upwind: float, tr_new=None) -> TracerCot:
    """The transpose of one step's tracer update (module docstring) for the
    output cotangent ``g_tr`` (2, ny2, nx, nT, K) of the new tracers, given
    the old state (with its tracers), the step's h' ``h_new`` and the old
    state's ``h_edge``; the h' feedback takes T' = ``tr_new`` where given
    (the kernels read it from the step's result), else C / safe. The sign of
    the flux is held fixed."""
    tr, h = state.tracers, state.layer_thickness
    flux = state.normal_velocity * h_edge
    tend_t = tracer_tendency_struct(tr, flux, mesh, kappa, upwind, h_edge)
    content = h[..., None, :] * tr + dt * tend_t
    hn = h_new[..., None, :]
    if mesh.cell_mask is None:
        safe = hn
        a = g_tr / safe
    else:
        mask = mesh.cell_mask[..., None, None]
        safe = torch.where(mask > 0, hn, torch.ones_like(hn))
        a = g_tr * mask / safe
    g = -(a * (content / safe if tr_new is None else tr_new)).sum(-2)
    d_dt = (a * tend_t).sum()
    # the edge flux g_e's cotangent, and the forward's edge values
    s_div = mesh.dv / mesh.area_cell
    d_g = torch.stack([_neighbor_cell_field(a, f) - a for f in (E, NE, NW)]) * (dt * s_div)
    t_nb = torch.stack([_neighbor_cell_field(tr, f) for f in (E, NE, NW)])
    t_e = 0.5 * (t_nb + tr)
    grad = (t_nb - tr) / mesh.dc
    fl = flux[..., None, :]
    if upwind:
        sg = torch.sign(fl)
        t_e = t_e - (0.5 * upwind * mesh.dc) * sg * grad
    d_te = d_g * fl
    d_flux = (d_g * t_e).sum(-2)
    d_grad = torch.zeros_like(d_te)
    if upwind:
        d_grad = d_grad - (0.5 * upwind * mesh.dc) * sg * d_te
    d_he = torch.zeros_like(h_edge)
    if kappa:
        m = 1.0 if mesh.edge_mask is None else mesh.edge_mask[..., None]
        diff = kappa * h_edge * m
        d_grad = d_grad - diff[..., None, :] * d_g
        d_he = -kappa * m * (d_g * grad).sum(-2)
    # te's and grad's cotangents onto the edge's owner (o) and neighbour (n)
    d_nb = 0.5 * d_te + d_grad / mesh.dc
    d_own = 0.5 * d_te - d_grad / mesh.dc
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(d_nb)
    d_tr = a * h[..., None, :] + d_own[0] + d_own[1] + d_own[2] + inc_E + inc_NE + inc_NW
    return TracerCot(g, d_flux, d_he, (a * tr).sum(-2), d_tr, d_dt)


def _tracer_cot(state: StructState, g: StructState, h_edge, tend_h, mesh: StructMesh, dt,
                kappa, upwind, next_state: StructState | None) -> TracerCot | None:
    """The tracer transpose of a step from ``state`` for the output
    cotangent ``g`` (its tracers' None read as zeros), h' and T' formed again
    or read from ``next_state``; None without tracers."""
    if state.tracers is None:
        return None
    g_tr = g.tracers if g.tracers is not None else torch.zeros_like(state.tracers)
    if next_state is not None:
        return tracer_transpose(state, next_state.layer_thickness, g_tr, h_edge, mesh, dt,
                                kappa, upwind, next_state.tracers)
    h_new = state.layer_thickness + dt * tend_h
    return tracer_transpose(state, h_new, g_tr, h_edge, mesh, dt, kappa, upwind)


def pressure_transpose(h, gu, dt, mesh: StructMesh, strat: Stratification):
    """The transpose of the stratified pressure term's h @ W part for the
    output cotangent gu (m * gu on a channel; module docstring): (its dh
    term W dPhi in h's dtype, d(W) (K, K) summed over the cells in double,
    as the kernels sum it). The g ssh part is the unstratified dssh."""
    w = strat.phi_weights.to(dtype=h.dtype, device=h.device)
    d_phi = _own_minus_incoming(dt * gu) * (1.0 / mesh.dc)
    k = h.shape[-1]
    return d_phi @ w.T, h.reshape(-1, k).double().T @ d_phi.reshape(-1, k).double()


def strat_pass(h, s, w, dt, inv_dc):
    """The plain version of the nonlinear reverse's stratified pass
    (csrc/adjoint_window.cuh, strat_pass_kernel; ``kernels.adjoint_step.
    nl_strat_pass``): for the primal h and S = sum_owned gu - sum_incoming
    gu (gu m * gu on a channel; each (..., K)) and W (K, K), (the dh term
    (dt / dc) S W^T in h's dtype, d(W) = (dt / dc) sum_c h (x) S and d(dt)'s
    W part (1 / dc) sum W (.) sum_c h (x) S, both in double). dt and inv_dc
    are rounded to h's dtype first, as the kernel takes them. With
    ``structured_nl_adjoint_step(strat=None)`` it splits the stratified
    reverse step as the card does."""
    k = h.shape[-1]
    dt_t = torch.tensor(float(dt), dtype=h.dtype)
    inv_t = torch.tensor(float(inv_dc), dtype=h.dtype)
    w = w.to(dtype=h.dtype, device=h.device)
    sums = h.reshape(-1, k).double().T @ s.reshape(-1, k).double()
    d_w = (float(dt_t) * float(inv_t)) * sums
    d_dt = float(inv_t) * (w.double() * sums).sum()
    return (dt_t * inv_t).to(h.device) * (s @ w.T), d_w, d_dt


def _result(d_state: StructState, d_dt, d_forc, d_w=None):
    """(d_state, d_dt), then the ForcingCot where forced, then d(W) where
    stratified."""
    return ((d_state, d_dt) + (() if d_forc is None else (d_forc,))
            + (() if d_w is None else (d_w,)))


def structured_adjoint_step(
    state: StructState, g: StructState, mesh: StructMesh, dt, forcing: Forcing | None = None,
    *, tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
    next_state: StructState | None = None, strat: Stratification | None = None,
):
    """VJP of ``structured_step(state, mesh, dt, forcing=forcing,
    tracer_kappa=, tracer_upwind=, strat=strat)`` for the output cotangent
    ``g``: (cotangent of the input state, d(dt) as a 0-d tensor), and with
    ``forcing`` a third item, the ForcingCot, and with ``strat`` a last one,
    d(W) in double (``pressure_transpose``). With the mesh's wall mask m, gu
    is m * gu throughout. A state with tracers gets their cotangent
    (``tracer_transpose``); ``next_state``, the step's result as the forward
    computed it, gives h' and T' to the tracer transpose, as the reverse
    kernels read them, instead of their forming them again."""
    h, u = state.layer_thickness, state.normal_velocity
    gu = g.normal_velocity
    if mesh.edge_mask is not None:
        gu = gu * mesh.edge_mask[..., None]
    G = g.layer_thickness + g.ssh[..., None]

    h_edge = interp_cell_to_edge(h, mesh)
    tend_h = -div_on_cell(u * h_edge, mesh)
    tr = _tracer_cot(state, g, h_edge, tend_h, mesh, dt, tracer_kappa, tracer_upwind,
                     next_state)
    if tr is not None:
        G = G + tr.g
    tend_u = pressure_tendency(state.ssh, h, mesh, strat) + tangential_times_f(u, mesh)
    d_dt = (G * tend_h).sum() + (gu * tend_u).sum()

    g_flux = torch.stack([_neighbor_cell_field(G, f) - G for f in (E, NE, NW)])
    g_flux = g_flux * (dt * (mesh.dv / mesh.area_cell))
    if tr is not None:
        g_flux = g_flux + tr.d_flux
    ug = u * g_flux
    d_forc = None
    if forcing is not None:
        du_f, dhe_f, dd_f, d_forc = forcing_transpose(u, h_edge, gu, dt, forcing)
        ug = ug + dhe_f
        d_dt = d_dt + dd_f
    if tr is not None:
        ug = ug + tr.d_he
        d_dt = d_dt + tr.d_dt
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(ug)
    d_h = G + 0.5 * (ug[0] + ug[1] + ug[2] + inc_E + inc_NE + inc_NW)
    if tr is not None:
        d_h = d_h + tr.d_h
    d_w = None
    if strat is not None:
        dh_w, d_w = pressure_transpose(h, gu, dt, mesh, strat)
        d_h = d_h + dh_w

    ct = apply_stencil(gu, transpose_coriolis_terms(mesh.coriolis_terms))
    d_u = gu + h_edge * g_flux + dt * (mesh.f_edge[..., None] * ct)
    if forcing is not None:
        d_u = d_u + du_f

    s = gu.sum(-1)
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(s)
    d_ssh = (GRAVITY * dt / mesh.dc) * (s[0] + s[1] + s[2] - inc_E - inc_NE - inc_NW)
    return _result(StructState(ssh=d_ssh, layer_thickness=d_h, normal_velocity=d_u,
                               tracers=None if tr is None else tr.d_tracers), d_dt, d_forc, d_w)


def _gather(y, terms, n_out: int, weight=lambda x, v: v):
    """out[o] = sum over the transposed terms (o, a, b, dm, di, x) of
    weight(x, y[a, b]) at (m + dm, i + di), in the terms' order: y a vertex
    field (2, 2, ny2, nx, ...) or an edge field (3, 2, ny2, nx, ...)."""
    out = [None] * n_out
    for (o, ia, ib, dm, di, x) in terms:
        contrib = _shift(weight(x, y[ia, ib]), dm, di)
        out[o] = contrib if out[o] is None else out[o] + contrib
    return torch.stack(out)


def _own_minus_incoming(x):
    """sum over a cell's owned edges of x minus sum over its incoming ones."""
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(x)
    return x[0] + x[1] + x[2] - inc_E - inc_NE - inc_NW


def _own_plus_incoming(x):
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(x)
    return x[0] + x[1] + x[2] + inc_E + inc_NE + inc_NW


def structured_nl_adjoint_step(
    state: StructState, g: StructState, mesh: StructMesh, dt, forcing: Forcing | None = None,
    *, tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
    next_state: StructState | None = None, strat: Stratification | None = None,
):
    """VJP of ``structured_step(state, mesh, dt, nonlinear=True,
    forcing=forcing, tracer_kappa=, tracer_upwind=, strat=strat)`` for the
    output cotangent ``g``: (cotangent of the input state, d(dt) as a 0-d
    tensor), and with ``forcing`` a third item, the ForcingCot, and with
    ``strat`` a last one, d(W), written out by hand (module docstring).
    With the mesh's wall mask m, gu is m * gu throughout. A state with
    tracers gets their cotangent
    (``tracer_transpose``; ``next_state`` as for ``structured_adjoint_step``).
    A mesh without the vertex constants raises (``model.check_nl_mesh``)."""
    check_nl_mesh(mesh)
    h, u = state.layer_thickness, state.normal_velocity
    gu = g.normal_velocity
    if mesh.edge_mask is not None:
        gu = gu * mesh.edge_mask[..., None]
    G = g.layer_thickness + g.ssh[..., None]
    a = dt * gu
    s_ke = 0.25 * mesh.dc * mesh.dv / mesh.area_cell
    s_curl = mesh.dc / (mesh.area_cell * 0.5)
    terms_t = transpose_coriolis_terms(mesh.coriolis_terms)

    h_edge = interp_cell_to_edge(h, mesh)
    flux = u * h_edge
    tend_h = -div_on_cell(flux, mesh)
    tr = _tracer_cot(state, g, h_edge, tend_h, mesh, dt, tracer_kappa, tracer_upwind,
                     next_state)
    if tr is not None:
        G = G + tr.g
    tend_u = _forced(_tend_u(state, flux, pressure_tendency(state.ssh, h, mesh, strat), mesh,
                             True), state, h_edge, forcing)
    d_dt = (G * tend_h).sum() + (gu * tend_u).sum()
    if tr is not None:
        d_dt = d_dt + tr.d_dt

    # the primal PV, as model.pv_on_vertex_struct computes it
    num = mesh.f_vertex[..., None] + curl_on_vertex(u, mesh)
    h_v = cell_to_vertex_kite(h, mesh)
    vm = mesh.vertex_mask
    if vm is None:
        safe = h_v
        q_v = num / safe
    else:
        vm = vm.reshape(vm.shape + (1,) * (h_v.ndim - 4))
        safe = torch.where(vm > 0, h_v, torch.ones_like(h_v))
        q_v = num / safe * vm
    q_e = vertex_to_edge_mean(q_v, mesh)

    # the PV flux's transpose, and the continuity's
    t_a = apply_stencil(a, terms_t)
    dq_e = 0.5 * (a * tangential_weights_only(flux, mesh) + flux * t_a)
    g_flux = torch.stack([_neighbor_cell_field(G, f) - G for f in (E, NE, NW)])
    d_flux = g_flux * (dt * (mesh.dv / mesh.area_cell)) + 0.5 * (
        apply_stencil(a * q_e, terms_t) + q_e * t_a)
    if tr is not None:
        d_flux = d_flux + tr.d_flux

    # the endpoint mean's, the PV division's, the curl's and the kite's
    ev_t = transpose_endpoint_terms(mesh.edge_vertex_terms)
    dq_v = 0.5 * _gather(dq_e, ((kind * 2 + p, f, po, dm, di, None)
                                for (kind, p, f, po, dm, di) in ev_t), 4).unflatten(0, (2, 2))
    d_zeta = dq_v / safe if vm is None else dq_v * vm / safe
    d_hv = -(dq_v * q_v) / safe
    kw = mesh.vertex_kite_planes
    if kw is None:
        w_kite = [t[5] for t in mesh.vertex_cell_terms]
        kite = lambda t, v: w_kite[t] * v  # noqa: E731
    else:
        kite = lambda t, v: kw[t].reshape(kw[t].shape + (1,) * (v.ndim - 2)) * v  # noqa: E731
    d_curl = _gather(d_zeta * s_curl, transpose_curl_terms(), 6,
                     lambda sign, v: v if sign > 0 else -v)

    # kinetic energy
    d_ke = _own_minus_incoming(a) * (1.0 / mesh.dc)
    ke_sum = torch.stack([_neighbor_cell_field(d_ke, f) + d_ke for f in (E, NE, NW)])

    d_u = (gu + h_edge * d_flux + (2.0 * s_ke) * u * ke_sum
           + d_curl.reshape(d_flux.shape))
    d_he = u * d_flux
    d_forc = None
    if forcing is not None:
        du_f, dhe_f, _, d_forc = forcing_transpose(u, h_edge, gu, dt, forcing)
        d_u = d_u + du_f
        d_he = d_he + dhe_f
    if tr is not None:
        d_he = d_he + tr.d_he
    d_h = (G + 0.5 * _own_plus_incoming(d_he)
           + _gather(d_hv, transpose_kite_terms(mesh.vertex_cell_terms), 2, kite))
    if tr is not None:
        d_h = d_h + tr.d_h
    d_w = None
    if strat is not None:
        dh_w, d_w = pressure_transpose(h, gu, dt, mesh, strat)
        d_h = d_h + dh_w
    d_ssh = (GRAVITY * dt / mesh.dc) * _own_minus_incoming(gu.sum(-1))
    return _result(StructState(ssh=d_ssh, layer_thickness=d_h, normal_velocity=d_u,
                               tracers=None if tr is None else tr.d_tracers), d_dt, d_forc, d_w)


def structured_adjoint_run_loop(
    state: StructState, mesh: StructMesh, dt, n_steps: int, g: StructState,
    nonlinear: bool = False, forcing: Forcing | None = None, *,
    tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
    strat: Stratification | None = None,
):
    """VJP of ``structured_run_loop(state, mesh, dt, n_steps, nonlinear,
    forcing=forcing, tracer_kappa=, tracer_upwind=, strat=strat)`` for the
    output cotangent ``g``, keeping all n_steps primal states: the plain
    version of the whole kernel reverse, on any device. Returns (d_state,
    d_dt), and with ``forcing`` the ForcingCot third, with ``strat`` d(W)
    last (its steps summed in double)."""
    step = functools.partial(
        structured_nl_adjoint_step if nonlinear else structured_adjoint_step,
        tracer_kappa=tracer_kappa, tracer_upwind=tracer_upwind, strat=strat)
    states = [state]
    for _ in range(n_steps - 1):
        states.append(structured_step(states[-1], mesh, dt, nonlinear, forcing, tracer_kappa,
                                      tracer_upwind, strat))
    d_dt = torch.zeros((), dtype=state.layer_thickness.dtype,
                       device=state.layer_thickness.device)
    d_forc = d_w = None
    if forcing is not None:
        d_forc = ForcingCot(torch.zeros_like(forcing.wind_edge),
                            torch.zeros(3, dtype=d_dt.dtype, device=d_dt.device))
    if strat is not None:
        k = state.layer_thickness.shape[-1]
        d_w = torch.zeros((k, k), dtype=torch.float64, device=d_dt.device)
    for s in reversed(states[:n_steps]):
        out = step(s, g, mesh, dt, forcing)
        g, d_dt = out[0], d_dt + out[1]
        if forcing is not None:
            d_forc = d_forc + out[2]
        if strat is not None:
            d_w = d_w + out[-1]
    return _result(g, d_dt, d_forc, None if d_w is None else d_w.to(d_dt.dtype))
