"""Wrapper of the hand-written tiled adjoint kernel (csrc/tiled_adjoint.cu),
which replaces the TPU kernel ``_tiled_adjoint_kernel``
(mpas_ocean_tpu/structured/pallas_model.py:1979) for the linear
forward-Euler core, on a periodic lattice and, with the wall mask's
``live`` bits (``fe_step.live_bits``), on a coastal channel culled from one;
with ``forcing=`` its forced arm, which adds d(wind) and d(r_lin, Cd,
lambda) to ``dforc``, with ``tracers=`` its tracer arm, and with
``strat_w=`` its stratified arm, which adds d(W) to ``dstrat`` (all as
``adjoint_step.adjoint_rollout``); the three compose in any combination, at
any q.

``tiled_adjoint_rollout`` takes tensors on a CUDA device and the stencils on
the host (``StructMesh.host_stencil``, ``StructMesh.host_adjoint_stencil``),
and launches one kernel per reverse superstep of q steps on the current
stream, then one small kernel that adds the call's d(dt) to an accumulator;
it raises on anything else, including a plan whose window does not fit the
card's shared memory and a stencil that is not the hex lattice's. Its plain
PyTorch version is ``structured.tiled_diff.plain_tiled_adjoint_superstep``,
which ``structured.tiled_diff`` runs for tensors on the CPU. ``launches``
counts kernel launches (one per superstep), ``forced_launches`` those of
the forced arm, ``tracer_launches`` those of the tracer arm and
``strat_launches`` those of the stratified arm.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, fe_step
from .adjoint_step import SHARES, check_dforc, check_dstrat, check_reverse_tracers, dforc_args, \
    reverse_tracer_args, strat_args, strat_smem_bytes
from .fe_step import (
    LIVE_BYTES,
    MAX_CLUSTER,
    SMEM_BYTES,
    TWO_BLOCK_BYTES,
    check_error,
    check_forcing,
    check_live,
    forcing_args,
    forcing_smem_bytes,
    check_tensor,
    host_stencil,
    lattice_dims,
    state_shapes,
)

__all__ = ["MAX_CLUSTER", "SMEM_BYTES", "TWO_BLOCK_BYTES", "forced_launches", "launches",
           "level_split", "occupancy", "smem_bytes", "strat_cells", "strat_launches",
           "tiled_adjoint_rollout", "tracer_launches", "window_sites"]

_RED_BYTES = 8 * 16  # kRedDoubles doubles in csrc/adjoint_window.cuh

# kernel launches made by tiled_adjoint_rollout (one per superstep), and
# those of them that ran the forced arm, the tracer arm and the stratified arm
launches = 0
forced_launches = 0
tracer_launches = 0
strat_launches = 0


# Most blocks in a cluster of the tracer arm at q > 1 (kMaxWideCluster in
# csrc/tiled_adjoint.cu): H100's non-portable cluster size
WIDE_CLUSTER = 16


def level_split(k: int, q: int, n_tracers: int = 0) -> tuple[int, int]:
    """(blocks per cluster, levels per block) of the tiled adjoint kernel.
    At q = 1 the forward kernels' split (``fe_step.level_split``: power-of-
    two chunks, 16 at K = 100, moved by 16-byte copies); at q > 1, whose
    window holds q primal copies and two cotangents, the fewest levels per
    block over at most MAX_CLUSTER blocks (13 at K = 100), and with tracers,
    whose planes ride in every copy, over at most WIDE_CLUSTER blocks (7 at
    K = 100: the (1, 1) tile's two-tracer window at 13 levels a block takes
    more than a block's shared memory). No block is without levels."""
    if q == 1:
        return fe_step.level_split(k)
    kc = -(-k // (WIDE_CLUSTER if n_tracers else MAX_CLUSTER))
    return -(-k // kc), kc


def window_sites(row_tile: int, col_tile: int, q: int, halo) -> int:
    """Sites of a tile's window: the core grown by 2q - 1 ``halo`` = (rows,
    columns) per side, the primal window a q-step reverse reads."""
    hm, hi = halo
    span = 2 * q - 1
    return (row_tile + 2 * hm * span) * (col_tile + 2 * hi * span)


def smem_bytes(sites: int, core: int, k: int, q: int, itemsize: int,
               forced: bool = False, n_tracers: int = 0, strat: bool = False,
               s_cells: int | None = None) -> int:
    """Dynamic shared memory of one block for a window of ``sites`` lattice
    sites around a core of ``core`` sites, k levels and q steps
    (``smem_bytes`` in csrc/tiled_adjoint.cu): the warps' d(dt) sums; q
    primal chunks and one cotangent chunk (two at q > 1) of 8 planes, with
    ``n_tracers`` the tracer arm's 2 n_tracers more in each; per site
    f_edge, gs and q ssh planes, at q > 1 also rts and two pairs of partial
    sums; the ranks' partial sums of the core; the site indices and live
    bits (the masked arm's, reserved either way, as in
    ``fe_step.smem_bytes``); with ``forced``, the forced arm's
    (``fe_step.forcing_smem_bytes``); with ``strat``, the stratified arm's
    (``adjoint_step.strat_smem_bytes``: S on ``s_cells`` cells, the core by
    default, R_{q-1} at q > 1, ``strat_cells``, and W's rows, in chunks of
    the power of two at or above the level chunk)."""
    ranks, kc = level_split(k, q, n_tracers)
    chunks = (8 + 2 * n_tracers) * (q + (2 if q > 1 else 1)) * kc
    planes = 8 + 2 * q + (6 if q > 1 else 0)
    kp = 1 << (kc - 1).bit_length()
    return (_RED_BYTES + itemsize * (sites * (chunks + planes) + ranks * 2 * core)
            + (4 + LIVE_BYTES) * sites + (forcing_smem_bytes(sites, 0, itemsize) if forced else 0)
            + (strat_smem_bytes(core if s_cells is None else s_cells, kp, k, itemsize)
               if strat else 0))


def strat_cells(row_tile: int, col_tile: int, q: int, halo) -> int:
    """Cells of the stratified arm's S chunk: R_{q-1}, the core grown by
    q - 1 ``halo`` = (rows, columns) per side, the largest region a reverse
    step of the superstep stores (the core at q = 1)."""
    hm, hi = halo
    return (row_tile + 2 * hm * (q - 1)) * (col_tile + 2 * hi * (q - 1))


def occupancy(row_tile: int, col_tile: int, q: int, halo, k: int,
              n_tracers: int = 0, strat: bool = False) -> tuple[int, int]:
    """(one block's shared memory in bytes as the kernel reckons it, blocks
    per SM by CUDA's occupancy calculator) of an f32 plan, with
    ``n_tracers`` tracers (the periodic tracer arm), ``strat`` (the
    periodic stratified arm), both or neither."""
    ranks, kc = level_split(k, q, n_tracers)
    fn = build.load().mot_tiled_adjoint_occupancy
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    check_error("tiled_adjoint's occupancy query",
                fn(row_tile, col_tile, q, *halo, kc, ranks, n_tracers, k if strat else 0,
                   ctypes.addressof(out)))
    return out[0], out[1]


_ARGTYPES = ([ctypes.c_void_p] * 35 + [ctypes.c_double] * 8 + [ctypes.c_int] * 14
             + [ctypes.c_void_p])


def _entry(dtype: torch.dtype):
    lib = build.load()
    fn = {torch.float32: lib.mot_tiled_adjoint_f32,
          torch.float64: lib.mot_tiled_adjoint_f64}[dtype]
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def tiled_adjoint_rollout(stack, g_in, f_edge, rts, stencil_table, coriolis_weight,
                          adjoint_table, adjoint_weight, dt: float, inv_dc: float,
                          s_div: float, n_supersteps: int, ddt: torch.Tensor, out=None,
                          scratch=None, *, row_tile: int, col_tile: int, q: int, halo,
                          live=None, forcing=None, dforc=None, tracers=None, end=None,
                          strat_w=None, dstrat=None):
    """n_supersteps >= 1 reverse supersteps of q forward-Euler steps of the
    linear core on the card, over row_tile x col_tile tiles.

    ``stack`` = (ssh (S, 2, ny2, nx), h (S, 2, ny2, nx, K),
    u (S, 3, 2, ny2, nx, K)) holds the primal state at the start of
    superstep s in slot s, S >= n_supersteps. ``g_in`` = (ssh, h, u) is the
    cotangent at the end of the last superstep and is left as it is.
    ``stencil_table`` / ``coriolis_weight`` pack the Coriolis stencil and
    ``adjoint_table`` / ``adjoint_weight`` its transpose
    (``fe_step.pack_stencil``), on the host (``StructMesh.host_stencil``,
    ``StructMesh.host_adjoint_stencil``); ``halo`` = (rows, columns) one
    step reads per side. d(dt) is added to ``ddt``, a float64 (1,) tensor on
    the card. Returns the cotangent at the start of superstep 0, written
    into ``out`` (allocated when None), through ``scratch`` (allocated when
    None and n_supersteps > 1). The scalars are rounded to the state dtype
    as for the forward kernel. ``live`` (the wall mask's live bits, as
    for ``fe_step.fe_rollout``, or None) runs the masked arm, the reverse of
    the masked forward steps; ``forcing`` and ``dforc`` (as for
    ``adjoint_step.adjoint_rollout``) the forced arm; ``tracers`` and ``end``
    (as for ``adjoint_step.adjoint_rollout``, the stack's slots being
    superstep starts) the tracer arm; ``strat_w`` and ``dstrat`` (as for
    ``adjoint_step.adjoint_rollout``) the stratified arm; the forced, tracer
    and stratified arms in any combination, at any q. A plan that does not
    fit the card's shared memory raises ValueError."""
    global launches, forced_launches, tracer_launches, strat_launches
    ssh_st, h_st, u_st = stack
    if h_st.dim() != 5:
        raise ValueError(f"h stack must be (S, 2, ny2, nx, K), got {tuple(h_st.shape)}")
    ny2, nx, k = lattice_dims(h_st[0], "tiled_adjoint")
    dtype, device = h_st.dtype, h_st.device
    if n_supersteps < 1:
        raise ValueError("tiled_adjoint_rollout takes n_supersteps >= 1")
    slots = h_st.shape[0]
    if n_supersteps > slots:
        raise ValueError(f"{n_supersteps} supersteps need {n_supersteps} primal slots, "
                         f"got {slots}")
    if q < 1:
        raise ValueError(f"q={q} must be >= 1")
    if row_tile < 1 or col_tile < 1 or ny2 % row_tile or nx % col_tile:
        raise ValueError(f"tile {row_tile}x{col_tile} must divide the {ny2}x{nx} lattice")
    hm, hi = halo
    n_tr = 0 if tracers is None else tracers.planes.shape[1] // 2
    cluster, kc = level_split(k, q, n_tr)
    need = smem_bytes(window_sites(row_tile, col_tile, q, halo), row_tile * col_tile, k, q,
                      h_st.element_size(), forcing is not None, n_tr, strat_w is not None,
                      strat_cells(row_tile, col_tile, q, halo))
    if need > SMEM_BYTES:
        raise ValueError(f"a {row_tile}x{col_tile} tile at q={q} needs {need} bytes of "
                         f"shared memory per block, more than {SMEM_BYTES}")
    shapes = state_shapes(ny2, nx, k)
    check_tensor("f_edge", f_edge, (3, 2, ny2, nx), dtype, device)
    check_tensor("rts", rts, (2, ny2, nx), dtype, device)
    check_live(live, ny2, nx, device)
    check_forcing(forcing, ny2, nx, dtype, device)
    check_dforc(dforc, forcing, ny2, nx, dtype, device)
    check_tensor("ddt", ddt, (1,), torch.float64, device)
    check_dstrat(strat_w, dstrat, k, dtype, device)
    if tracers is not None:
        shapes = (*shapes, tracers.planes.shape[1:])
    if out is None:
        out = tuple(torch.empty(s, dtype=dtype, device=device) for s in shapes)
    if scratch is None:
        scratch = out if n_supersteps == 1 else tuple(torch.empty_like(x) for x in out)
    for x, shape, f in zip(stack, shapes[:3], ("ssh", "h", "u")):
        check_tensor(f"stack {f}", x, (slots, *shape), dtype, device)
    check_reverse_tracers(tracers, end, (("g_in", g_in), ("out", out), ("scratch", scratch)),
                          live, slots, ny2, nx, k, dtype, device)
    for group, name in ((g_in, "g_in"), (out, "out"), (scratch, "scratch")):
        for x, shape, f in zip(group, shapes[:3], ("ssh", "h", "u")):
            check_tensor(f"{name} {f}", x, shape, dtype, device)
    table, weights, n_terms = host_stencil(stencil_table, coriolis_weight)
    adj_table, adj_weights, n_adj = host_stencil(adjoint_table, adjoint_weight)
    if n_adj != n_terms:
        raise ValueError("the adjoint table must be the transpose of the stencil table")
    n_tiles = (ny2 // row_tile) * (nx // col_tile)
    shares = 1 if forcing is None else SHARES
    part = torch.empty(shares * n_supersteps * n_tiles * cluster, dtype=torch.float64,
                       device=device)
    fn = _entry(dtype)
    ptrs, coefs = forcing_args(forcing, kc)
    tr_ptrs, tr_opts, n_tr = reverse_tracer_args(tracers, end, g_in, out, scratch)
    st_ptrs, _acc = strat_args(strat_w, dstrat, n_tiles, k)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            f_edge.data_ptr(), rts.data_ptr(), None if live is None else live.data_ptr(),
            *ptrs, *dforc_args(dforc),
            table.ctypes.data, weights.ctypes.data, adj_table.ctypes.data, adj_weights.ctypes.data,
            *[x.data_ptr() for x in (*stack[:3], *g_in[:3], *out[:3], *scratch[:3], part, ddt)],
            *tr_ptrs, *st_ptrs, float(dt), float(inv_dc), float(s_div), *coefs[:3], *tr_opts,
            *coefs[3:], ny2, nx, k, n_supersteps, n_terms, row_tile, col_tile, q, hm, hi, kc, n_tr,
            stream,
        )
    check_error("tiled_adjoint", err, f" (plan {(row_tile, col_tile, q)})")
    launches += n_supersteps
    if forcing is not None:
        forced_launches += n_supersteps
    if tracers is not None:
        tracer_launches += n_supersteps
    if strat_w is not None:
        strat_launches += n_supersteps
    return out
