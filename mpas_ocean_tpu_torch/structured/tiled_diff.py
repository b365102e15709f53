"""Differentiable rollout of the structured core with a tiled reverse: the
forward-Euler step kernel (kernels/fe_step.py) forward, and a reverse sweep
through the hand-written tiled adjoint kernel (kernels/tiled_adjoint.py,
csrc/tiled_adjoint.cu), q steps per launch over row x column tiles; for the
nonlinear core, through the nonlinear reverse kernel at q = 1
(kernels/adjoint_step.nl_adjoint_rollout, csrc/nl_adjoint.cuh) and the
q-step nonlinear reverse kernel at q > 1
(kernels/adjoint_step.nl_window_adjoint_rollout, csrc/nl_window_adjoint.cuh),
over tiles that divide the lattice.

Counterpart of mpas_ocean_tpu/structured/pallas_model.py's tiled reverse
(:1960-2584: ``_tiled_adjoint_plan``, ``_halo_unscatter``,
``_pallas_tiled_adjoint``, ``_tiled_adjoint_from_ckpts``) and of the tiled
arms of ``_rollout_fwd`` / ``_rollout_bwd`` (:2779-2944), for the linear and
the nonlinear core with forward Euler, on periodic lattices and on coastal
channels (the wall mask windowed as f_edge, ``masks_full``; the vertex
constants as ``fv_full``). It mirrors ``tiled_model``.

The forward is ``diff_model.forward_ckpts`` in groups of ``group * q``
steps, which runs ``fe_step`` on the card: that is the counterpart of
``_tiled_fwd_ckpts``, and the forward that ``structured_auto_run_loop``
takes at every size, so the gradient's forward is bitwise the forward
path's own. The reverse takes the groups last to first (``diff_model``'s
sweep): it rebuilds the group's superstep-start states with ``fe_step``, q
steps per slot, then runs one tiled adjoint launch per superstep back
through them. This replaces the reverse of ``_tiled_adjoint_from_ckpts``.
Only d(dt) is returned of the scalars' cotangents: d(1/dc) and d(dv/A) go
with the mesh, which gets none (``_rollout_bwd`` returns zeros for it).

The planner (``tiled_adjoint_plan``) replaces ``_tiled_adjoint_plan``, the
TPU's VMEM model ``_adj_window_planes`` and ``_ADJ_TILED_VMEM_BUDGET``: a
plan fits when one block's share of the window, ``adjoint_window_bytes``,
fits the card's shared memory (csrc/tiled_adjoint.cu reckons it the same
way); it takes q = 1 and the largest tile whose window leaves room for two
blocks per SM (else the largest that fits one), with
``tiled_model.resolve_plan``'s clamp, and ``group`` from
``diff_model.adjoint_plan`` over the n / q supersteps.

The nonlinear tiled reverse is kernel 4's nonlinear arm. At q = 1, the
only q the JAX router takes (``_ADJ_Q_ORDER``, pallas_model.py:2673) and the
planner's default, it is the VJP of one nonlinear FE step per tile, which is
the nonlinear reverse kernel's launch, so it runs that kernel (planned by
``adjoint_step.nl_adjoint_plan`` over the tiles that divide the lattice). At
an explicit q > 1 it runs the q-step nonlinear reverse kernel, one launch
per superstep (planned by ``adjoint_step.nl_window_plan``, whose shared
memory does not grow with q); the plain superstep runs any q.

Tracers (a state's ``tracers``, with ``tracer_kappa=`` and
``tracer_upwind=``) are a fourth differentiated field, as in diff_model; on
the card the tiled adjoint kernel's tracer arm runs them, at any q.

Layered stratification (``strat=``, its W a differentiated input, as in
diff_model) runs the stratified arms on the card, at any q; the tiled
reverse accumulates d(W) in double beside d(dt).

Momentum forcing (``forcing=``) runs the forced arms: the tiled reverse
accumulates d(wind) per edge (each tile its core's, over its q steps) and
d(r_lin, Cd, lambda) in double beside d(dt).

The three compose with each other and with either core on the card: the
linear ones in the tiled adjoint kernel's composed arms at any q, the
nonlinear ones in the nonlinear reverse kernel's at q = 1 and in the q-step
nonlinear reverse kernel's at q > 1.

A CUDA state runs the kernels, and a failed build, a failed launch or a
plan that does not fit raises; a CPU state runs the same plan with the plain
step and ``plain_tiled_adjoint_superstep``, the kernel's plain version.
Nothing falls back from one to the other.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.autograd.function import once_differentiable

from ..kernels import adjoint_step, tiled_adjoint
from ..models.forcing import Forcing
from ..models.stratification import Stratification
from . import fused_model
from .adjoint import ForcingCot
from .diff_model import (
    _DIFF_INPUTS,
    _default_budget,
    _dt_meta,
    _empty,
    _end,
    _fields,
    _forcing_inputs,
    _forward,
    _grads,
    _kept_end,
    _lattice_state,
    _output_cotangent,
    _planes_state,
    _reverse,
    _save_dt,
    _save_forcing,
    _save_strat,
    _slot,
    _state_inputs,
    _Steps,
    _strat_input,
    adjoint_plan,
    forward_ckpts,
)
from .model import StructMesh, StructState, check_nl_mesh
from .slab import adjoint_stencil_reach, stencil_reach, window_steps
from .tiled_model import (
    _divisors,
    _nl_args,
    _windows,
    forcing_windows,
    halo_unscatter,
    mask_windows,
    resolve_plan,
)

__all__ = [
    "TiledRolloutDiff",
    "adjoint_window_bytes",
    "plain_tiled_adjoint_superstep",
    "reverse_halo",
    "tiled_adjoint_from_ckpts",
    "tiled_adjoint_plan",
    "tiled_adjoint_rollout",
    "tiled_rollout_diff",
]


# shared-memory budgets of the tiled adjoint's tile, in order of preference:
# two blocks per SM, then one
ADJOINT_BUDGETS = (tiled_adjoint.TWO_BLOCK_BYTES, tiled_adjoint.SMEM_BYTES)


def reverse_halo(terms, nl_terms=None) -> tuple[int, int]:
    """(rows, columns) per side that one step of the reverse reads: the
    larger of the forward step's reach (the recompute, q > 1) and the
    transposed step's, both (1, 2) for the hex lattice's tables. With
    ``nl_terms`` the nonlinear step's reach, (2, 4), the halo of the plain
    superstep's windows (the VJP of ``slab.window_steps``, JAX's scatter
    form); the nonlinear reverse kernel reads its own window
    (``slab.nl_adjoint_rings``)."""
    if nl_terms is not None:
        return stencil_reach(terms, False, nl_terms)
    fwd, adj = stencil_reach(terms, False), adjoint_stencil_reach(terms)
    return max(fwd[0], adj[0]), max(fwd[1], adj[1])


def adjoint_window_bytes(row_tile: int, col_tile: int, q: int, halo, k: int,
                         itemsize: int, forced: bool = False, n_tracers: int = 0,
                         strat: bool = False) -> int:
    """Shared memory of one block of the tiled adjoint kernel: its level
    chunk of q primal states and one cotangent (two at q > 1) over the
    window of 2q - 1 halos per side, with ``n_tracers`` the tracer arm's
    2 n_tracers planes of each, and the window's planes without levels and
    live bits, with ``strat`` the stratified arm's (its S chunk on R_{q-1},
    ``tiled_adjoint.strat_cells``) (csrc/tiled_adjoint.cu: ``smem_bytes``)."""
    sites = tiled_adjoint.window_sites(row_tile, col_tile, q, halo)
    return tiled_adjoint.smem_bytes(sites, row_tile * col_tile, k, q, itemsize, forced,
                                    n_tracers, strat,
                                    tiled_adjoint.strat_cells(row_tile, col_tile, q, halo))


def forced_adjoint_window_bytes(row_tile: int, col_tile: int, q: int, halo, k: int,
                                itemsize: int) -> int:
    """``adjoint_window_bytes`` of the forced arm: what the planner sizes a
    tile by, so that one plan serves both arms."""
    return adjoint_window_bytes(row_tile, col_tile, q, halo, k, itemsize, forced=True)


def tiled_adjoint_plan(ny2: int, nx: int, k: int, itemsize: int, n_steps: int, *, halo,
                       budget: float = math.inf, row_tile=None, col_tile=None, q=None,
                       nonlinear: bool = False, n_tracers: int = 0, strat: bool = False,
                       forced: bool = False):
    """(row_tile, col_tile, q, group) for the gradient of an n-step rollout
    on ny2 x nx sites and k levels, ``halo`` from ``reverse_halo``: the
    caller's choices completed by ``tiled_model.resolve_plan`` with the
    adjoint's window (by default q = 1 and the largest tile whose window
    leaves room for two blocks per SM, else the largest that fits one; for
    ``nonlinear``, q = 1 and ``adjoint_step.nl_adjoint_plan``'s tile among
    those that divide the lattice, sized with its arms' shared memory, or at
    the caller's q > 1 ``adjoint_step.nl_window_plan``'s, sized with the
    q-step kernel's (ValueError where no tile fits); with
    ``n_tracers``, the tracer arm's window at q = 1 by default (or the
    caller's q), sized for one block per SM, the arm's launch bounds; with
    ``strat``, the stratified arm's window at q = 1 by default (or the
    caller's q); either with the forced arm's too where ``forced``), and
    ``group`` supersteps per checkpoint
    group from ``diff_model.adjoint_plan`` over n / q supersteps within
    ``budget`` bytes, a state counting its tracer planes."""
    if nonlinear and (row_tile is None or col_tile is None):
        tiles = [(r, c) for r in _divisors(ny2) for c in _divisors(nx)]
        if q is not None and q > 1:
            rt, ct, _ = adjoint_step.nl_window_plan(ny2, nx, k, itemsize, tiles,
                                                    n_tracers=n_tracers, strat=strat,
                                                    forced=forced)
        else:
            rt, ct, _ = adjoint_step.nl_adjoint_plan(ny2, nx, k, itemsize, tiles,
                                                     n_tracers=n_tracers, strat=strat)
        row_tile = rt if row_tile is None else row_tile
        col_tile = ct if col_tile is None else col_tile
        q = 1 if q is None else q
    window, budgets = forced_adjoint_window_bytes, ADJOINT_BUDGETS
    if nonlinear:  # the nonlinear reverse's own planner sized its tile
        pass
    elif n_tracers:  # the tracer arm: q = 1 by default, one block per SM
        q = 1 if q is None else q
        window = functools.partial(adjoint_window_bytes, forced=forced, n_tracers=n_tracers,
                                   strat=strat)
        budgets = (tiled_adjoint.SMEM_BYTES,)
    elif strat:  # the stratified arm: q = 1 by default
        q = 1 if q is None else q
        window = functools.partial(adjoint_window_bytes, forced=forced, strat=True)
    rt, ct, q = resolve_plan(ny2, nx, k, itemsize, halo, n_steps, row_tile, col_tile, q,
                             window=window, budgets=budgets)
    state_bytes = itemsize * 2 * ny2 * nx * (1 + 4 * k + n_tracers * k)
    group = adjoint_plan(n_steps // q, state_bytes, budget) if n_steps else 1
    return rt, ct, q, group


def plain_tiled_adjoint_superstep(state: StructState, cot: StructState, mesh: StructMesh,
                                  dt, row_tile: int, col_tile: int, q: int,
                                  nonlinear: bool = False, forcing: Forcing | None = None, *,
                                  tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                                  strat: Stratification | None = None):
    """The tiled adjoint kernel's plain version, one reverse superstep of q
    forward-Euler steps (of the nonlinear core with ``nonlinear``, forced
    with ``forcing``, the state's tracers with ``tracer_kappa`` and
    ``tracer_upwind`` rounded to the state dtype, stratified with ``strat``,
    W cast to the state dtype): cut the primal ``state``
    at the superstep start into halo-padded windows and the cotangent
    ``cot`` at its end into the tiles' cores, take ``torch.func.vjp`` of
    ``slab.window_steps`` over all windows as one batch (dt a 0-d tensor;
    the vertex constants and the forcing windowed as f_edge; the tracer
    planes as h, the cell mask as rts), and overlap-add the windows'
    cotangents onto the lattice (``tiled_model.halo_unscatter``). Returns
    (cotangent at the superstep start, its tracers' in the lattice layout,
    d(dt) as a 0-d tensor in the state dtype), with forcing a ForcingCot
    third (d(wind) (3, 2, ny2, nx) overlap-added the same way, d(r_lin, Cd,
    lambda)), with ``strat`` d(W) (K, K) in the state dtype last (W, one
    input of every window, gathers all their cotangents, as the TPU's
    per-tile d(W) summed). It is what the TPU kernel and its caller compute
    together (pallas_model.py:2528-2553), by autograd rather than by the
    hand-written transpose the kernels run."""
    ny2, nx = mesh.ny2, mesh.nx
    h = state.layer_thickness
    k, dtype = h.shape[-1], h.dtype
    if nonlinear:
        check_nl_mesh(mesh)
    nl_terms, nl = _nl_args(mesh, dtype, nonlinear)
    halo = stencil_reach(mesh.coriolis_terms, False, nl_terms)
    hm, hi = halo[0] * q, halo[1] * q
    dt_, inv_dc, s_div = fused_model._scal(mesh, dt, dtype)
    win = lambda x: _windows(x, row_tile, col_tile, hm, hi)
    core = lambda x: _windows(x, row_tile, col_tile, 0, 0)
    f_w = win(mesh.f_edge.to(dtype).reshape(6, ny2, nx, 1))
    rts_w = win(mesh.resting_thickness_sum.to(dtype).reshape(2, ny2, nx, 1))
    mask_w = mask_windows(mesh, dtype, win)
    fv_w = None
    if nonlinear:
        fv = fused_model.nl_setup(mesh, dtype)
        fv_w = win(fv.reshape(fv.shape[0], ny2, nx, 1))
    forc_w = forcing_windows(forcing, mesh, dtype, win)
    # the forcing's differentiable parts (wind windows, coefficients) ride
    # the vjp as inputs; its level windows as constants
    diff_forc = () if forc_w is None else (forc_w[0], *forc_w[2:])
    with_tr, with_w = state.tracers is not None, strat is not None
    w_in = (fused_model.kernel_strat(strat, dtype, h.device),) if with_w else ()
    tr_kw = {}
    if with_tr:
        cm = mesh.cell_mask
        tr_kw = dict(tropts=fused_model.tracer_opts(tracer_kappa, tracer_upwind, dtype),
                     cmask_full=None if cm is None else win(cm.to(dtype).reshape(2, ny2, nx, 1)))

    def steps(ssh, h, u, d, *rest):
        tr, rest = (rest[0], rest[1:]) if with_tr else (None, rest)
        w, fz = (rest[0], rest[1:]) if with_w else (None, rest)
        forc = None if forc_w is None else (fz[0], forc_w[1], *fz[1:])
        return window_steps(ssh, h, u, f_w, rts_w, d, inv_dc, s_div, mesh.coriolis_terms,
                            rows=row_tile, cols=col_tile, q=q, halo=halo, mask_full=mask_w,
                            fv_full=fv_w, nl=nl, forc_full=forc, tr=tr, strat_w=w, **tr_kw)

    tr_in = (win(fused_model.tracer_planes(state.tracers)),) if with_tr else ()
    _, vjp = torch.func.vjp(
        steps, win(state.ssh[..., None]), win(h),
        win(state.normal_velocity.reshape(6, ny2, nx, k)),
        torch.tensor(dt_, dtype=dtype, device=h.device), *tr_in, *w_in, *diff_forc)
    g_out = (core(cot.ssh[..., None].to(dtype)), core(cot.layer_thickness.to(dtype)),
             core(cot.normal_velocity.to(dtype).reshape(6, ny2, nx, k)))
    if with_tr:
        g_tr = cot.tracers if cot.tracers is not None else torch.zeros_like(state.tracers)
        g_out += (core(fused_model.tracer_planes(g_tr.to(dtype))),)
    d_ssh, d_h, d_u, d_dt, *rest = vjp(g_out)
    d_tr, rest = (rest[0], rest[1:]) if with_tr else (None, rest)
    d_w, d_forc = ((rest[0],), rest[1:]) if with_w else ((), rest)
    back = lambda w: halo_unscatter(w, ny2, nx, hm, hi)
    d_state = StructState(ssh=back(d_ssh)[..., 0], layer_thickness=back(d_h),
                          normal_velocity=back(d_u).reshape(3, 2, ny2, nx, k),
                          tracers=None if d_tr is None
                          else fused_model.tracer_unplanes(back(d_tr)))
    if forcing is None:
        return (d_state, d_dt, *d_w)
    return (d_state, d_dt, ForcingCot(back(d_forc[0]).reshape(3, 2, ny2, nx),
                                      torch.stack(d_forc[1:])), *d_w)


class _TiledSteps(_Steps):
    """diff_model's steps with a slot per superstep of q steps: the
    forward kernel fills the slots, the tiled adjoint kernel (or its plain
    version, for a CPU state) reverses them; for ``nonlinear`` on the card,
    the nonlinear reverse kernel at q = 1 over the plan's tiles (diff_model's
    reverse), the q-step nonlinear reverse kernel at q > 1."""

    def __init__(self, mesh: StructMesh, dt, like: torch.Tensor, plan, nonlinear: bool = False,
                 forcing: Forcing | None = None, strat: Stratification | None = None,
                 **tracer_kw):
        super().__init__(mesh, dt, like, nonlinear, nl_tile=tuple(plan[:2]), forcing=forcing,
                         strat=strat, **tracer_kw)
        self.rt, self.ct, self.q, _ = plan
        nl_terms, _ = _nl_args(mesh, like.dtype, nonlinear)
        self.halo = reverse_halo(mesh.coriolis_terms, nl_terms)
        if self.cuda:  # f_edge, rts, the stencil and its transpose
            self.tiled_adj = (*self.fwd, *self.adj[1:])

    def fill(self, stack: StructState, n: int):
        """Slot j + 1 = q steps of slot j, for j < n."""
        if self.q == 1:
            super().fill(stack, n)
            return
        scratch = _empty(_slot(stack, 0))
        for j in range(n):
            self.advance(_slot(stack, j), _slot(stack, j + 1), self.q, scratch)

    def reverse(self, stack: StructState, g: StructState, n: int, ddt: torch.Tensor,
                out: StructState, scratch: StructState, end: StructState | None = None):
        """n >= 1 reverse supersteps through the stack's slots n - 1 .. 0,
        from the cotangent g at the end into out; d(dt) is added to ddt, with
        forcing d(wind) and d(r_lin, Cd, lambda) to ``dforc``, with
        stratification d(W) to ``dstrat``. With tracers on the card, ``end``
        is the state after slot n - 1."""
        if self.cuda and self.nonlinear and self.q == 1:
            super().reverse(stack, g, n, ddt, out, scratch, end)
            return
        if self.cuda and self.nonlinear:
            adjoint_step.nl_window_adjoint_rollout(
                _fields(stack)[:3], _fields(g), self.nl_fwd[0], *self.nl_adj,
                *self.nl_adj_scal, n, self.q, ddt, _fields(out), _fields(scratch),
                live=self.live, tile=(self.rt, self.ct), forcing=self.kf, dforc=self.dforc,
                tracers=self.kernel_tracers(stack.tracers), end=_end(end, self.tracers),
                strat_w=self.sw, dstrat=self.dstrat)
            return
        if self.cuda:
            tiled_adjoint.tiled_adjoint_rollout(
                _fields(stack)[:3], _fields(g), *self.tiled_adj, *self.scal, n, ddt,
                _fields(out), _fields(scratch), row_tile=self.rt, col_tile=self.ct,
                q=self.q, halo=self.halo, live=self.live, forcing=self.kf, dforc=self.dforc,
                tracers=self.kernel_tracers(stack.tracers), end=_end(end, self.tracers),
                strat_w=self.sw, dstrat=self.dstrat)
            return
        for j in reversed(range(n)):
            res = plain_tiled_adjoint_superstep(
                _lattice_state(_slot(stack, j)), _lattice_state(g), self.mesh, self.dt,
                self.rt, self.ct, self.q, self.nonlinear, self.forcing,
                tracer_kappa=self.kappa, tracer_upwind=self.upwind, strat=self.strat)
            g = _planes_state(res[0])
            ddt += res[1]
            self.add_plain_cots(res)
        for dst, x in zip(_fields(out), _fields(g)):
            dst.copy_(x)


def _plan(state: StructState, mesh: StructMesh, n_steps: int, plan, nonlinear: bool,
          strat: bool = False, forced: bool = False):
    if plan:
        return tuple(plan)
    h = state.layer_thickness
    nl_terms, _ = _nl_args(mesh, h.dtype, nonlinear)
    n_tr = 0 if state.tracers is None else state.tracers.shape[-2]
    return tiled_adjoint_plan(mesh.ny2, mesh.nx, h.shape[-1], h.element_size(), n_steps,
                              halo=reverse_halo(mesh.coriolis_terms, nl_terms),
                              budget=_default_budget(h.device), nonlinear=nonlinear,
                              n_tracers=n_tr, strat=strat, forced=forced)


def _tiled_steps(mesh, dt, state: StructState, plan, nonlinear, forcing, tropts,
                 strat=None) -> _TiledSteps:
    return _TiledSteps(mesh, dt, state.layer_thickness, plan, nonlinear, forcing, strat,
                       tracers=state.tracers is not None, tracer_kappa=tropts[0],
                       tracer_upwind=tropts[1])


def tiled_adjoint_from_ckpts(ckpts: StructState, mesh: StructMesh, dt, n_steps: int,
                             plan, g: StructState, nonlinear: bool = False,
                             forcing: Forcing | None = None, *, final: StructState | None = None,
                             tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                             strat: Stratification | None = None) -> tuple:
    """The tiled reverse sweep from the checkpoints that
    ``forward_ckpts(state, mesh, dt, n_steps, group * q, nonlinear, forcing)``
    kept, for ``plan`` = (row_tile, col_tile, q, group): per group, last to
    first, rebuild its superstep-start states and reverse them one superstep
    per launch (the tracers with ``tracer_kappa`` and ``tracer_upwind``,
    stratified with ``strat``; ``final`` as for
    ``diff_model.adjoint_from_ckpts``). Returns (cotangent of the rollout's
    input, d(dt) as a 0-d float64 tensor), with forcing the ForcingCot
    third, with ``strat`` d(W) (K, K) in float64 last. Counterpart of
    ``_tiled_adjoint_from_ckpts``."""
    _, _, q, group = plan
    if n_steps % q:
        raise ValueError(f"q={q} must divide n_steps={n_steps}")
    steps = _tiled_steps(mesh, dt, ckpts, plan, nonlinear, forcing,
                         (tracer_kappa, tracer_upwind), strat)
    return _reverse(steps, ckpts, n_steps // q, group, g,
                    None if final is None else _planes_state(final))


def tiled_adjoint_rollout(state: StructState, mesh: StructMesh, dt, n_steps: int,
                          g: StructState, *, plan=None, nonlinear: bool = False,
                          forcing: Forcing | None = None, tracer_kappa: float = 0.0,
                          tracer_upwind: float = 1.0, strat: Stratification | None = None):
    """VJP of an n-step rollout (of the nonlinear core with ``nonlinear``,
    forced with ``forcing``, the state's tracers with ``tracer_kappa`` and
    ``tracer_upwind``, stratified with ``strat``) through the tiled reverse:
    given its input ``state`` and an output cotangent ``g``, returns
    (d_state, d_dt), d_dt as a 0-d tensor in dt's dtype (float64 for a
    Python dt), with forcing the ForcingCot third, and with ``strat`` d(W)
    (K, K) in float64 last, as ``_pallas_tiled_adjoint`` returns
    d_strat_w. ``plan`` = (row_tile, col_tile, q, group) overrides
    ``tiled_adjoint_plan``. Counterpart of ``_pallas_tiled_adjoint``."""
    dtype, device = _dt_meta(dt, state.layer_thickness.device)
    plan = _plan(state, mesh, n_steps, plan, nonlinear, strat is not None, forcing is not None)
    kw = dict(tracer_kappa=tracer_kappa, tracer_upwind=tracer_upwind, strat=strat)
    final, ckpts = forward_ckpts(state, mesh, dt, n_steps, plan[2] * plan[3], nonlinear,
                                 forcing, **kw)
    res = tiled_adjoint_from_ckpts(ckpts, mesh, dt, n_steps, plan, g, nonlinear, forcing,
                                   final=final, **kw)
    return (res[0], res[1].to(dtype=dtype, device=device), *res[2:])


class TiledRolloutDiff(torch.autograd.Function):
    """n-step rollout whose backward is the tiled reverse sweep
    (``forward_ckpts`` forward, ``tiled_adjoint_from_ckpts`` backward).
    Inputs: ssh, h, u, the tracers (or None), dt (float or tensor), the
    forcing's wind and r_lin, Cd, lambda (None unforced), the
    stratification's W (or None), mesh, n_steps, plan, nonlinear, forcing
    (its level masks), tracer_kappa, tracer_upwind, strat (its densities).
    The mesh, the masks, kappa, upwind and the densities get no
    cotangent."""

    @staticmethod
    def forward(ctx, ssh, h, u, tracers, dt, wind, dlin, dquad, rayl, w, mesh, n_steps,
                plan=None, nonlinear=False, forcing=None, tracer_kappa=0.0, tracer_upwind=1.0,
                strat=None):
        state = _planes_state(StructState(ssh, h, u, tracers))
        _save_dt(ctx, dt, h.device)
        forcing = _save_forcing(ctx, forcing, wind, dlin, dquad, rayl)
        strat = _save_strat(ctx, strat, w)
        plan = _plan(StructState(ssh, h, u, tracers), mesh, n_steps, plan, nonlinear,
                     strat is not None, forcing is not None)
        if n_steps % plan[2]:
            raise ValueError(f"q={plan[2]} must divide n_steps={n_steps}")
        ctx.tropts = (tracer_kappa, tracer_upwind)
        final, ckpts = _forward(state, mesh, ctx.dt_v, n_steps, plan[2] * plan[3], nonlinear,
                                forcing, ctx.tropts, strat=strat)
        ctx.ckpts, ctx.mesh, ctx.n_steps, ctx.plan = ckpts, mesh, n_steps, plan
        ctx.nonlinear = nonlinear
        ctx.final = _kept_end(final, tracers)
        return _state_inputs(_lattice_state(final))

    @staticmethod
    @once_differentiable
    def backward(ctx, gs, gh, gu, gtr):
        rest = (None,) * 8
        if ctx.n_steps == 0:
            return gs, gh, gu, gtr, *(None,) * (_DIFF_INPUTS - 4), *rest
        like = _lattice_state(_slot(ctx.ckpts, 0))
        g = _output_cotangent(like, (gs, gh, gu, gtr))
        steps = _tiled_steps(ctx.mesh, ctx.dt_v, ctx.ckpts, ctx.plan, ctx.nonlinear, ctx.forcing,
                             ctx.tropts, ctx.strat)
        res = _reverse(steps, ctx.ckpts, ctx.n_steps // ctx.plan[2], ctx.plan[3], g, ctx.final)
        return (*_grads(ctx, res), *rest)


def tiled_rollout_diff(state: StructState, mesh: StructMesh, dt, n_steps: int, *,
                       plan=None, nonlinear: bool = False,
                       forcing: Forcing | None = None, tracer_kappa: float = 0.0,
                       tracer_upwind: float = 1.0,
                       strat: Stratification | None = None) -> StructState:
    """n-step rollout of the linear core, or with ``nonlinear`` of the
    vector-invariant one (periodic, or masked where the mesh has a wall
    mask), forced with ``forcing`` (struct layout), the state's tracers
    carried with ``tracer_kappa`` and ``tracer_upwind``, stratified with
    ``strat``, differentiable with respect to the state (its tracers among
    it), a tensor ``dt``, the forcing's wind and coefficients and the
    stratification's W, with the tiled reverse: forward through ``fe_step``
    on the card, backward through ``tiled_adjoint`` (nonlinear: the
    nonlinear reverse kernel at q = 1, the q-step nonlinear reverse kernel
    at q > 1), every combination of the core, forcing, tracers and
    stratification through the kernels' composed arms, at any q.
    ``plan`` = (row_tile,
    col_tile, q, group) overrides ``tiled_adjoint_plan``. The tiled arm of
    ``pallas_rollout_diff``."""
    return StructState(*TiledRolloutDiff.apply(*_state_inputs(state), dt,
                                               *_forcing_inputs(forcing), _strat_input(strat),
                                               mesh, n_steps, plan, nonlinear, forcing,
                                               tracer_kappa, tracer_upwind, strat))
