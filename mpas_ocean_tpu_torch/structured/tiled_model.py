"""Tiled, temporally blocked rollout of the structured core, for lattices
of any size: one hand-written kernel launch per q steps on the card
(kernels/tiled_step.py, csrc/tiled_step.cu).

Counterpart of mpas_ocean_tpu/structured/pallas_model.py's
``pallas_tiled_run_loop`` (:1332) and ``_pallas_tiled_rollout`` (:1221) for
the linear and the nonlinear core with forward Euler (FE) or
forward-backward (FB), on periodic lattices and on coastal channels (the
wall mask and the vertex constants windowed as f_edge, :1287-1288,
1391-1394), with momentum forcing (the wind and level-index planes windowed
as f_edge), with tracers (their planes windowed as h, the cell mask as
rts; the tracer operands of :892-946, 1180-1190) and with layered
stratification (W as a whole operand, :904-908, 1193-1194), in any
combination.
The lattice is cut into row_tile x col_tile tiles; each tile reads its core
and q halos of ``slab.stencil_reach`` rows and columns per side, advances q
steps on the shrinking window (``slab.window_steps``) and writes its core.

A CUDA state runs the kernel, and a failed build, a failed launch or a plan
that does not fit raises; a CPU state runs ``plain_tiled_rollout``, the
kernel's plain version with the same plan. Nothing falls back from one to
the other.

The planner (``tile_plan``) replaces the TPU's VMEM fit model
(``tile_window_fits``, ``auto_tile_plan``, pallas_model.py:965-1045): a plan
fits when one block's share of the window, ``window_bytes``, fits the
card's shared memory (csrc/tiled_step.cu reckons it the same way; the
registers are fixed by the kernel's 512-thread blocks); among the plans
that fit it takes q = 1 and the largest tile, the rule read off the
measurements in PERF.md. The nonlinear core runs at q = 1 FE through
fe_step's nonlinear arm and FB through the tiled kernel's (one template,
csrc/nl_step.cuh), and at q > 1 (the caller's q) FE and FB through the
q-step kernel (csrc/nl_tiled.cuh, ``tiled_step.tiled_nl_rollout``),
planned by ``fe_step.nl_plan`` over the tiles that divide the lattice, at
q. The planner keeps q = 1 for the nonlinear core too: on an H100 the
linear q = 2 plans lost to q = 1 by 47-139%, and the nonlinear q = 2 arms
took 2.0-4.8x the q = 1 time a step alone and 5.1-11.4x with forcing,
tracers and stratification (PERF.md section 5, tools/tile_sweep.py
--kernels nonlinear --q 1 2).
"""

from __future__ import annotations

import functools

import torch

from ..kernels import fe_step, tiled_step
from ..models.forcing import Forcing
from ..models.stratification import Stratification
from . import fused_model
from .model import StructMesh, StructState, check_nl_mesh
from .slab import stencil_reach, window_steps

__all__ = [
    "forcing_windows",
    "halo_unscatter",
    "mask_windows",
    "plain_tiled_rollout",
    "resolve_plan",
    "tile_plan",
    "tiled_run_loop",
    "window_bytes",
]


def window_bytes(row_tile: int, col_tile: int, q: int, halo, k: int, itemsize: int,
                 forced: bool = False, n_tracers: int = 0, strat: bool = False,
                 fb: bool = False) -> int:
    """Shared memory of one block of the tiled kernel: its level chunk of
    the window (2 h planes + 6 u channels, and 2 planes per tracer), one
    copy at q = 1 and two at q > 1, the window's ssh (two copies), column
    partial sums (two), f_edge, rts, and its lattice sites with their live
    bits (the masked arm's, reserved either way; csrc/tiled_step.cu:
    ``smem_bytes``); with ``forced``, the forced arm's too; with ``strat``,
    the stratified arm's Phi planes, staged h planes and W slice, and for
    ``fb`` the kept fresh h' (``tiled_step.strat_smem_bytes``)."""
    hm, hi = halo
    sites = (row_tile + 2 * hm * q) * (col_tile + 2 * hi * q)
    _, kc = tiled_step.level_split(k)
    return tiled_step.smem_bytes(sites, kc, q, itemsize, forced, n_tracers,
                                 k if strat else 0, fb)


def forced_window_bytes(row_tile: int, col_tile: int, q: int, halo, k: int,
                        itemsize: int) -> int:
    """``window_bytes`` of the forced arm: what the planners size a tile by,
    so that one plan serves both arms."""
    return window_bytes(row_tile, col_tile, q, halo, k, itemsize, forced=True)


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


# shared-memory budgets of the forward kernel's tile, in order of preference:
# two blocks per SM, then one
FORWARD_BUDGETS = (tiled_step.TWO_BLOCK_BYTES, tiled_step.SMEM_BYTES)


def _fits(rt, ct, q, halo, ny2, nx, k, itemsize, window, budget) -> bool:
    hm, hi = halo
    return (rt + 2 * hm * q <= ny2 and ct + 2 * hi * q <= nx
            and window(rt, ct, q, halo, k, itemsize) <= budget)


def _best_tile(ny2, nx, k, itemsize, halo, q, window=forced_window_bytes,
               budgets=FORWARD_BUDGETS):
    """The tile of largest area whose ``window`` (one block's shared memory)
    fits the first of ``budgets`` that any tile fits at this q; among
    those, the one with the smallest window, then the widest. None if no
    tile fits."""
    hm, hi = halo
    for budget in budgets:
        tiles = [(rt * ct, -(rt + 2 * hm * q) * (ct + 2 * hi * q), ct, rt)
                 for rt in _divisors(ny2) for ct in _divisors(nx)
                 if _fits(rt, ct, q, halo, ny2, nx, k, itemsize, window, budget)]
        if tiles:
            *_, ct, rt = max(tiles)
            return rt, ct
    return None


def tile_plan(ny2: int, nx: int, k: int, itemsize: int, reach, n_steps: int):
    """(row_tile, col_tile, q) for a lattice of ny2 x nx sites and k levels,
    ``reach`` the per-step halo (rows, columns) of ``slab.stencil_reach``:
    q = 1, which divides every n_steps, and the largest tile whose window
    lets two blocks share an SM, else the largest that fits one
    (``_best_tile``). Measured on an H100 at 256x256x100 and 64x64x100 f32
    (PERF.md section 5, tools/tile_sweep.py): the rule's FB (8, 8, 1) and FE
    (4, 16, 1) were the fastest plans or within 1.1% of them, and the best
    one-block plans took 1.04-1.52x as long; q = 2 took 1.47-2.39x as long
    as q = 1 (the kernel is far from its byte bound, so the halo rings that
    temporal blocking recomputes cost more than the state passes it saves),
    and no q = 4 window fits. One plan serves the periodic and the masked
    arm."""
    tile = _best_tile(ny2, nx, k, itemsize, reach, 1)
    return (*(tile or (1, 1)), 1)


def resolve_plan(ny2: int, nx: int, k: int, itemsize: int, halo, n_steps: int,
                 row_tile=None, col_tile=None, q=None, window=forced_window_bytes,
                 budgets=FORWARD_BUDGETS):
    """The plan ``tiled_run_loop`` runs: the caller's choices completed by
    ``tile_plan``, q lowered until it divides n_steps, and the reach*q clamp
    of pallas_tiled_run_loop (pallas_model.py:1372-1384) applied to rows
    against ny2 and to columns against nx. ``window`` gives one block's
    shared memory for a plan (``window_bytes`` with ``n_tracers`` for a
    state with tracers), and ``budgets`` the budgets ``_best_tile`` tries (the tiled
    adjoint passes its own). Raises ValueError for a tile that does not
    divide the lattice, and for a window that fits no tile."""
    hm, hi = halo
    if q is None:
        _, _, q = tile_plan(ny2, nx, k, itemsize, halo, n_steps)
    q = max(1, min(int(q), n_steps))
    while n_steps % q:
        q -= 1
    if row_tile is None or col_tile is None:
        best = _best_tile(ny2, nx, k, itemsize, halo, q, window, budgets)
        if best is None and window(1, 1, q, halo, k, itemsize) > budgets[-1]:
            raise ValueError(f"no tile of the tiled kernel fits its window in {budgets[-1]} "
                             f"bytes of shared memory at q={q} ({k} levels of {itemsize}-byte "
                             f"values)")
        rt, ct = best or (1, 1)
        row_tile = rt if row_tile is None else row_tile
        col_tile = ct if col_tile is None else col_tile
    if ny2 % row_tile:
        raise ValueError(f"row_tile {row_tile} must divide ny2={ny2}")
    if nx % col_tile:
        raise ValueError(f"col_tile {col_tile} must divide nx={nx}")
    for tile, n, h in ((row_tile, ny2, hm), (col_tile, nx, hi)):
        if tile + 2 * h * q > n:
            q = max(1, (n - tile) // (2 * h))
            while n_steps % q:
                q -= 1
    return int(row_tile), int(col_tile), int(q)


def _nl_tile(ny2: int, nx: int, k: int, itemsize: int, halo, n_steps: int, q, fb: bool,
             arms: dict) -> tuple[int, int]:
    """The nonlinear core's tile for ``tiled_run_loop``: ``fe_step.nl_plan``
    over the tiles that divide the lattice, at q (the caller's, or
    ``tile_plan``'s q = 1, lowered to divide n_steps as ``resolve_plan``
    does) with the q-step kernel's shared memory where q > 1, among the
    tiles whose q-window fits the lattice where any does."""
    hm, hi = halo
    q = max(1, min(int(q or 1), n_steps or 1))
    while n_steps and n_steps % q:
        q -= 1
    tiles = [(r, c) for r in _divisors(ny2) for c in _divisors(nx)]
    if q > 1:
        tiles = [(r, c) for r, c in tiles
                 if r + 2 * hm * q <= ny2 and c + 2 * hi * q <= nx] or tiles
    return fe_step.nl_plan(ny2, nx, k, itemsize, fb, tiles, **arms, q=q)[:2]


def _windows(x, rt, ct, hm, hi):
    """(ch, ny2, nx, K) periodic planes -> (n_row_tiles, n_col_tiles, ch,
    rt + 2 hm, ct + 2 hi, K) halo-padded tile windows (the counterpart of
    ``halos()`` in _pallas_tiled_rollout, pallas_model.py:1254-1279, for
    rows and columns)."""
    _, ny2, nx, _ = x.shape
    dev = x.device
    rows = (torch.arange(0, ny2, rt, device=dev)[:, None] - hm
            + torch.arange(rt + 2 * hm, device=dev)) % ny2
    cols = (torch.arange(0, nx, ct, device=dev)[:, None] - hi
            + torch.arange(ct + 2 * hi, device=dev)) % nx
    return x[:, rows[:, None, :, None], cols[None, :, None, :]].permute(1, 2, 0, 3, 4, 5)


def halo_unscatter(w, ny2: int, nx: int, hm: int, hi: int):
    """The transpose of ``_windows``: (n_row_tiles, n_col_tiles, ch,
    rt + 2 hm, ct + 2 hi, K) per-window values -> (ch, ny2, nx, K), each
    window site overlap-added onto the periodic plane it was read from, over
    rows and columns. The adds run in a fixed order, one window offset at a
    time; within one offset the tiles' sites are distinct. Counterpart of
    ``_halo_unscatter`` (pallas_model.py:2257), whose windows are whole
    rows."""
    _, _, ch, wm, wi, k = w.shape
    rt, ct = wm - 2 * hm, wi - 2 * hi
    out = w.new_zeros((ch, ny2, nx, k))
    r0 = torch.arange(0, ny2, rt, device=w.device) - hm
    c0 = torch.arange(0, nx, ct, device=w.device) - hi
    for a in range(wm):
        rows = ((r0 + a) % ny2)[:, None]
        for b in range(wi):
            out[:, rows, ((c0 + b) % nx)[None, :]] += w[:, :, :, a, b].permute(2, 0, 1, 3)
    return out


def mask_windows(mesh: StructMesh, dtype, win):
    """The wall mask cut by ``win`` into tile windows as f_edge is, or None
    on a periodic lattice."""
    if mesh.edge_mask is None:
        return None
    return win(mesh.edge_mask.to(dtype).reshape(6, mesh.ny2, mesh.nx, 1))


def forcing_windows(forcing: Forcing | None, mesh: StructMesh, dtype, win):
    """The forcing as ``slab.window_steps`` takes it, ``forc_full``: the wind
    planes (6, ny2, nx, 1) and the level indices (12, ny2, nx, 1) of
    ``fused_model.forcing_setup`` cut by ``win`` into tile windows as f_edge
    is, and (r_lin, Cd, lambda) as 0-d tensors rounded to ``dtype``; None
    unforced."""
    if forcing is None:
        return None
    ny2, nx = mesh.ny2, mesh.nx
    wind, idx = fused_model.forcing_setup(forcing, ny2, nx, dtype)
    device = mesh.f_edge.device
    coefs = (torch.tensor(c, dtype=dtype, device=device)
             for c in fused_model.forcing_scal(forcing, dtype))
    return (win(wind.reshape(6, ny2, nx, 1).to(device)),
            win(idx.reshape(12, ny2, nx, 1).to(device)), *coefs)


def _untile(w):
    """(n_row_tiles, n_col_tiles, ch, rt, ct, K) interiors -> (ch, ny2, nx, K)."""
    n_tm, n_ti, ch, rt, ct, k = w.shape
    return w.permute(2, 0, 3, 1, 4, 5).reshape(ch, n_tm * rt, n_ti * ct, k)


def _nl_args(mesh: StructMesh, dtype, nonlinear: bool):
    """(halo's vertex taps, the step's nl tuple) for ``slab.window_steps``,
    or (None, None) for the linear core."""
    if not nonlinear:
        return None, None
    nl_terms = (mesh.vertex_cell_terms, mesh.edge_vertex_terms)
    return nl_terms, (*fused_model.nl_scal(mesh, dtype), *nl_terms)


def plain_tiled_rollout(state: StructState, mesh: StructMesh, dt, n_steps: int,
                        row_tile: int, col_tile: int, q: int, fb: bool = False, *,
                        nonlinear: bool = False, forcing: Forcing | None = None,
                        tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                        strat: Stratification | None = None) -> StructState:
    """The tiled kernel's plain version: n_steps / q times, cut the
    periodic state into halo-padded tile windows, run ``window_steps`` on
    all of them as one batch (the mesh's wall mask, the ``forcing``, for
    ``nonlinear`` the vertex constants, and the state's tracers with the
    cell mask windowed with them; kappa and upwind rounded to the state
    dtype, as the kernel takes them; ``strat``'s W cast to the state dtype,
    ``fused_model.kernel_strat``), and put the interiors back together."""
    if n_steps % q:
        raise ValueError(f"q={q} must divide n_steps={n_steps}")
    ny2, nx = mesh.ny2, mesh.nx
    k = state.layer_thickness.shape[-1]
    dtype = state.layer_thickness.dtype
    nl_terms, nl = _nl_args(mesh, dtype, nonlinear)
    halo = stencil_reach(mesh.coriolis_terms, fb, nl_terms)
    hm, hi = halo[0] * q, halo[1] * q
    dt_, inv_dc, s_div = fused_model._scal(mesh, dt, dtype)
    win = lambda x: _windows(x, row_tile, col_tile, hm, hi)
    f_w = win(mesh.f_edge.to(dtype).reshape(6, ny2, nx, 1))
    rts_w = win(mesh.resting_thickness_sum.to(dtype).reshape(2, ny2, nx, 1))
    mask_w = mask_windows(mesh, dtype, win)
    fv_w = None
    if nonlinear:
        fv = fused_model.nl_setup(mesh, dtype)
        fv_w = win(fv.reshape(fv.shape[0], ny2, nx, 1))
    forc_w = forcing_windows(forcing, mesh, dtype, win)
    strat_w = fused_model.kernel_strat(strat, dtype, state.layer_thickness.device)
    ssh = state.ssh[..., None]
    h = state.layer_thickness
    u = state.normal_velocity.reshape(6, ny2, nx, k)
    tr = tropts = cmask_w = None
    if state.tracers is not None:
        tr = fused_model.tracer_planes(state.tracers)
        tropts = fused_model.tracer_opts(tracer_kappa, tracer_upwind, dtype)
        if mesh.cell_mask is not None:
            cmask_w = win(mesh.cell_mask.to(dtype).reshape(2, ny2, nx, 1))
    for _ in range(n_steps // q):
        out = window_steps(win(ssh), win(h), win(u), f_w, rts_w, dt_, inv_dc, s_div,
                           mesh.coriolis_terms, rows=row_tile, cols=col_tile, q=q,
                           halo=halo, fb=fb, mask_full=mask_w, fv_full=fv_w, nl=nl,
                           forc_full=forc_w, tr=None if tr is None else win(tr),
                           tropts=tropts, cmask_full=cmask_w, strat_w=strat_w)
        ssh, h, u, *tr = (_untile(x) for x in out)
        tr = tr[0] if tr else None
    return StructState(ssh=ssh[..., 0], layer_thickness=h,
                       normal_velocity=u.reshape(3, 2, ny2, nx, k),
                       tracers=None if tr is None else fused_model.tracer_unplanes(tr))


def tiled_run_loop(state: StructState, mesh: StructMesh, dt, n_steps: int, *,
                   row_tile: int | None = None, col_tile: int | None = None,
                   q: int | None = None, nonlinear: bool = False,
                   fb: bool = False, forcing: Forcing | None = None,
                   tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                   strat: Stratification | None = None) -> StructState:
    """n_steps FE (or, with ``fb=True``, FB) steps of the linear core or,
    with ``nonlinear``, of the vector-invariant one, on a periodic lattice
    or a masked channel, q per kernel launch over row_tile x col_tile
    tiles; the plan is completed by ``resolve_plan``. A CUDA state runs the
    kernel (its masked arm where the mesh has a wall mask, its forced arm
    with ``forcing``, its tracer arm for the state's tracers with
    ``tracer_kappa`` and ``tracer_upwind``, its stratified arm with
    ``strat``, in any combination, the plan sized with their shared memory;
    the nonlinear core at q = 1 FE through fe_step's nonlinear arm and FB
    through the tiled kernel's, at q > 1 both through the q-step kernel,
    whose plan the q sizes and which refuses a tile that does not fit with
    ValueError), a CPU state its plain version with the same plan."""
    device = state.layer_thickness.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rollout for state on {device}")
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    k = state.layer_thickness.shape[-1]
    dtype = state.layer_thickness.dtype
    if nonlinear:
        check_nl_mesh(mesh)
    nl_terms, _ = _nl_args(mesh, dtype, nonlinear)
    halo = stencil_reach(mesh.coriolis_terms, fb, nl_terms)
    n_tr = 0 if state.tracers is None else state.tracers.shape[3]
    arms = dict(forced=forcing is not None, n_tracers=n_tr, strat=strat is not None)
    if nonlinear and (row_tile is None or col_tile is None):
        rt, ct = _nl_tile(mesh.ny2, mesh.nx, k, dtype.itemsize, halo, n_steps, q, fb, arms)
        row_tile = rt if row_tile is None else row_tile
        col_tile = ct if col_tile is None else col_tile
    window = forced_window_bytes
    if n_tr or strat is not None:
        window = functools.partial(window_bytes, fb=fb, **arms)
    rt, ct, q = resolve_plan(mesh.ny2, mesh.nx, k, dtype.itemsize, halo, n_steps,
                             row_tile, col_tile, q, window=window)
    if device.type == "cpu":
        if n_steps == 0:
            return StructState(*(None if x is None else x.clone() for x in (
                state.ssh, state.layer_thickness, state.normal_velocity, state.tracers)))
        return plain_tiled_rollout(state, mesh, dt, n_steps, rt, ct, q, fb,
                                   nonlinear=nonlinear, forcing=forcing,
                                   tracer_kappa=tracer_kappa, tracer_upwind=tracer_upwind,
                                   strat=strat)
    consts = (mesh.resting_thickness_sum.to(dtype).contiguous(), *mesh.host_stencil)
    scal = fused_model._scal(mesh, dt, dtype)
    kernel_arms = dict(
        live=fused_model.kernel_live(mesh),
        forcing=fused_model.kernel_forcing(forcing, mesh, dtype, device),
        tracers=fused_model.kernel_tracers(state, mesh, tracer_kappa, tracer_upwind),
        strat_w=fused_model.kernel_strat(strat, dtype, device))
    if nonlinear:
        nl_args = (state.ssh, state.layer_thickness, state.normal_velocity, *consts,
                   fused_model.nl_setup(mesh, dtype), *nl_terms, *scal,
                   *fused_model.nl_scal(mesh, dtype), n_steps)
        if q == 1 and not fb:
            ssh, h, u, *tr = fe_step.fe_nl_rollout(*nl_args, tile=(rt, ct), **kernel_arms)
        else:
            ssh, h, u, *tr = tiled_step.tiled_nl_rollout(*nl_args, tile=(rt, ct), q=q, fb=fb,
                                                         **kernel_arms)
    else:
        ssh, h, u, *tr = tiled_step.tiled_rollout(
            state.ssh, state.layer_thickness, state.normal_velocity,
            mesh.f_edge.to(dtype).contiguous(), *consts, *scal, n_steps,
            row_tile=rt, col_tile=ct, q=q, halo=halo, fb=fb, **kernel_arms)
    return StructState(ssh, h, u, fused_model.tracer_unplanes(tr[0]) if tr else None)
