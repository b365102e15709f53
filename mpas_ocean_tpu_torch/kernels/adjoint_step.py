"""Wrappers of the hand-written reverse-step kernels, which replace the TPU
kernel ``_adjoint_segment_kernel``
(mpas_ocean_tpu/structured/pallas_model.py:1480): csrc/adjoint_step.cu for
the linear forward-Euler core and csrc/nl_adjoint.cuh for the nonlinear
(vector-invariant) one, each on a periodic lattice and, with the wall mask's
``live`` bits (``fe_step.live_bits``), on a coastal channel culled from one.

``adjoint_rollout`` takes tensors on a CUDA device and the transposed
stencil on the host (``StructMesh.host_adjoint_stencil``), launches one
adjoint kernel per reverse step on the current stream, each over tiles of
``adjoint_tile`` sites, then one small kernel that adds the call's d(dt) to
an accumulator; it raises on anything else, a table that is not the hex
lattice's transpose included. With ``forcing=`` (the forward's operands,
``structured.fused_model.kernel_forcing``) it runs the kernel's forced arm,
which adds d(wind) and d(r_lin, Cd, lambda) to ``dforc``; with
``tracers=`` (the forward's tracer operands, their planes the tracer stack)
its tracer arm, which carries the tracers' cotangent and reads h' and T'
from the stack's next slot, or from ``end`` after its last; with
``strat_w=`` (W, ``structured.fused_model.kernel_strat``) its stratified
arm, which adds d(W) to ``dstrat``. Its plain PyTorch version is
``structured.adjoint.structured_adjoint_step``. ``launches`` counts
adjoint-step launches (one per reverse step), ``forced_launches`` those of
the forced arm, ``tracer_launches`` those of the tracer arm and
``strat_launches`` those of the stratified arm.

The forced, tracer and stratified arms compose in any combination, in
both kernels.

``nl_adjoint_rollout`` does the same for the nonlinear core, one launch of
the nonlinear reverse kernel per reverse step over tiles of
``nl_adjoint_plan``'s, with the same ``forcing=``, ``tracers=`` and
``strat_w=`` arms; it also serves the tiled route's nonlinear reverse at
q = 1 (the JAX package's kernel 4 at its only q). Its plain PyTorch version
is ``structured.adjoint.structured_nl_adjoint_step``; ``nl_launches`` counts
its launches, ``nl_forced_launches``, ``nl_tracer_launches`` and
``nl_strat_launches`` those of its arms. Its stratified arm runs, after each
step, one launch of the stratified pass (csrc/adjoint_window.cuh:
``strat_pass_kernel``, the W S product and d(W) on the FP64 tensor cores),
counted in ``nl_strat_pass_launches``; ``nl_strat_pass`` runs one alone, its
plain version ``structured.adjoint.strat_pass``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .fe_step import (
    _NL_DERIVED,
    LIVE_BYTES,
    MAX_CLUSTER,
    SMEM_BYTES,
    SMS,
    TWO_BLOCK_BYTES,
    best_tile,
    check_error,
    check_forcing,
    check_live,
    check_strat,
    check_tracer_stack,
    forcing_args,
    forcing_smem_bytes,
    check_tensor,
    host_stencil,
    lattice_dims,
    level_split,
    state_shapes,
    vertex_tables,
)
from .fe_step import strat_smem_bytes as fe_strat_smem_bytes

__all__ = ["NL_ADJ_RINGS", "NL_ADJ_SLICE", "REACH", "TILE_COLS", "TILE_ROWS", "adjoint_rollout",
           "adjoint_tile", "check_dstrat", "forced_launches", "launch_plan", "launches",
           "nl_adjoint_launch_plan", "nl_adjoint_plan",
           "nl_adjoint_rollout", "nl_adjoint_slice", "nl_adjoint_smem_bytes",
           "nl_forced_launches", "nl_launches", "nl_strat_launches", "nl_strat_pass",
           "nl_strat_pass_launches", "nl_tracer_launches", "nl_window_adjoint_rollout",
           "nl_window_forced_launches", "nl_window_launches", "nl_window_plan",
           "nl_window_scratch_values", "nl_window_slice", "nl_window_smem_bytes",
           "nl_window_strat_launches", "nl_window_tracer_launches", "reverse_tracer_args",
           "smem_bytes", "strat_args", "strat_launches", "strat_pass_fit", "strat_pass_groups",
           "strat_pass_smem_bytes", "strat_smem_bytes", "tracer_launches"]

# adjoint-step kernel launches made by adjoint_rollout (one per step), and
# those of them that ran the forced arm, the tracer arm and the stratified arm
launches = 0
forced_launches = 0
tracer_launches = 0
strat_launches = 0
# nonlinear reverse kernel launches made by nl_adjoint_rollout (one per step),
# and those of them that ran the forced, the tracer and the stratified arm
nl_launches = 0
nl_forced_launches = 0
nl_tracer_launches = 0
nl_strat_launches = 0
# launches of the stratified pass (csrc/adjoint_window.cuh, strat_pass_kernel):
# one after each stratified step of nl_adjoint_rollout, one a nl_strat_pass call
nl_strat_pass_launches = 0

# The reach of one reverse step, (rows, columns) per side:
# slab.adjoint_stencil_reach of the hex lattice's tables; csrc/adjoint_step.cu
# derives it from the table.
REACH = (1, 2)
_PLANES = 10  # kPlanes in csrc/adjoint_step.cu
_RED_BYTES = 8 * 16  # kRedDoubles doubles in csrc/adjoint_window.cuh
# The shares a block of a forced reverse arm writes (kShares in
# csrc/adjoint_window.cuh): d(dt), d(r_lin), d(Cd), d(lambda)
SHARES = 4
# adjoint_tile's tiles besides the powers of two: these rows by these
# columns, cut to the lattice (tools/tile_sweep.py sweeps the same set)
TILE_ROWS = (1, 2, 3, 4, 6, 8, 16)
TILE_COLS = (2, 4, 6, 8, 12, 16, 24, 32)
# The waves of clusters (two blocks per SM) from which a launch takes a
# larger tile than the power-of-two rule's
MIN_WAVES = 4
# The nonlinear reverse's rings (rows, columns) per side around its tile, of
# stages C, B, A and of the window (csrc/nl_adjoint.cuh; slab.nl_adjoint_rings
# derives them from the hex lattice's tables)
NL_ADJ_RINGS = ((1, 1), (2, 2), (3, 4), (4, 6))
# ... its values per ring A, B and C site and level, per window site (ssh,
# gs, 20 vertex constant planes: the q-step kernel reserves the masked
# arm's); ints per window site (site, live bits)
_NLA_A, _NLA_B, _NLA_C, _NLA_SITE, _NLA_INTS = 12, 14, 8, 24, 2
# Levels per slice of the nonlinear reverse at which nl_adjoint_plan sizes the
# tile; the slice then grows while it fits
NL_ADJ_SLICE = 4


def strat_smem_bytes(core: int, kc: int, k: int, itemsize: int) -> int:
    """Shared memory the stratified reverse arms take beyond the
    unstratified layout (``strat_adj_smem_bytes`` in
    csrc/adjoint_window.cuh): 16 bytes of alignment, the S chunk at the
    tile's ``core`` sites [2][core][kc] and the block's rows of W [k][kc]."""
    return 16 + itemsize * (2 * core * kc + k * kc)


def smem_bytes(tile, k: int, itemsize: int, forced: bool = False, n_tracers: int = 0,
               strat: bool = False) -> int:
    """Dynamic shared memory of one adjoint_step block for a tile (rows,
    columns) at k levels (``smem_bytes`` in csrc/adjoint_step.cu): the warps'
    d(dt) sums, its level chunk of the window's primal state and cotangent
    [2][8][sites][kc], the window's ssh, gs, f_edge, site indices and live
    bits (the masked arm's, reserved either way, as in
    ``fe_step.smem_bytes``), and the ranks' partial sums of the tile's
    sites; with ``forced``, the forced arm's (``fe_step.forcing_smem_bytes``);
    with ``n_tracers``, the tracer arm's 2 n_tracers planes of the primal
    and of the cotangent chunk; with ``strat``, the stratified arm's
    (``strat_smem_bytes``)."""
    ranks, kc = level_split(k)
    hm, hi = REACH
    sites = (tile[0] + 2 * hm) * (tile[1] + 2 * hi)
    core = tile[0] * tile[1]
    return (_RED_BYTES + itemsize * (sites * ((16 + 4 * n_tracers) * kc + _PLANES)
                                     + ranks * 2 * core)
            + (4 + LIVE_BYTES) * sites + (forcing_smem_bytes(sites, 0, itemsize) if forced else 0)
            + (strat_smem_bytes(core, kc, k, itemsize) if strat else 0))


def adjoint_tile(ny2: int, nx: int, k: int, itemsize: int, n_tracers: int = 0,
                 strat: bool = False, forced: bool = False) -> tuple[int, int]:
    """adjoint_step's tile (rows, columns) on a ny2 x nx lattice: the
    largest tile of TILE_ROWS x TILE_COLS (ragged ones too) whose window
    leaves room for two blocks per SM, then the smallest window, then the
    widest, where its launch makes at least MIN_WAVES waves of clusters on
    the card; else ``fe_step.best_tile``'s power-of-two tile. The window is
    the forced arm's, so that one tile serves both arms, or with ``strat``
    the stratified arm's (with the forced arm's too where ``forced``); with
    ``n_tracers`` the tracer arm's (with the forced and stratified arms'
    where asked), which runs one block per SM (its launch bounds),
    ``best_tile``'s largest tile that fits one block. At 100 f32
    levels the tracer-free tile is
    (4, 12) at 256x256 and (4, 8) at 64x64, the fastest tiles of the sweep
    there (PERF.md section 5, tools/tile_sweep.py): a larger tile re-reads
    less halo, but on a small lattice its few clusters leave the card's
    last wave part empty. A tracer count that fits no tile raises
    ValueError."""
    name = f"adjoint_step ({k} levels of {itemsize}-byte values, {n_tracers} tracers)"
    if n_tracers:
        return best_tile(ny2, nx, REACH, lambda t: smem_bytes(t, k, itemsize, forced,
                                                             n_tracers, strat),
                         name, budgets=(SMEM_BYTES,))
    smem = lambda t: smem_bytes(t, k, itemsize, forced=forced or not strat,  # noqa: E731
                                strat=strat)
    tile = best_tile(ny2, nx, REACH, smem, name)
    hm, hi = REACH
    two = [(rt * ct, -(rt + 2 * hm) * (ct + 2 * hi), ct, rt)
           for rt, ct in {(min(r, ny2), min(c, nx)) for r in TILE_ROWS for c in TILE_COLS}
           if smem((rt, ct)) <= TWO_BLOCK_BYTES]
    if not two or smem(tile) > TWO_BLOCK_BYTES:
        return tile
    area, _, ct, rt = max(two)
    clusters = -(-ny2 // rt) * -(-nx // ct)
    if area > tile[0] * tile[1] and clusters * level_split(k)[0] >= MIN_WAVES * 2 * SMS:
        return rt, ct
    return tile


def launch_plan(table: np.ndarray, ny2: int, nx: int, k: int, tile, n_tracers: int = 0,
                strat: bool = False) -> dict:
    """The launch adjoint_step makes for ``tile`` on an f32 ny2 x nx x k
    lattice with the transposed stencil ``table`` (host copy), with
    ``n_tracers`` tracers (its periodic tracer arm), ``strat`` (its periodic
    stratified arm) or neither: its clusters (one per tile), the blocks one
    SM holds (CUDA's occupancy calculator) and one block's shared memory in
    bytes, as the kernel reckons it."""
    fn = build.load().mot_adjoint_plan
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    table = np.ascontiguousarray(table, dtype=np.int32)
    check_error("adjoint_step's plan query", fn(table.ctypes.data, ny2, nx, k, *tile, n_tracers,
                                                int(strat), ctypes.addressof(out)))
    return {"clusters": out[0], "blocks_per_sm": out[1], "smem_bytes": out[2]}


def nl_adjoint_smem_bytes(tile, itemsize: int, ks: int, n_tracers: int = 0,
                          masked: bool = False) -> int:
    """Dynamic shared memory of one block of the nonlinear reverse for a tile
    (rows, columns) in slices of ks levels (``nl_adjoint_smem_bytes`` in
    csrc/nl_adjoint.cuh): the warps' d(dt) sums; the window, a slice of its
    primal state and cotangent (with ``n_tracers``, the tracer arm's 2
    n_tracers planes of each); the rings'
    planes; with tracers, their values per edge on ring C (1 + 3 n_tracers
    a channel); the window's ssh, gs and vertex constants (4 planes, 20
    ``masked``); the partial sums of the tile's sites; the window's site
    indices and live bits; the packed levels of the 6 edges of each ring C
    site (the forced arm's, reserved by every arm). The stratified arm takes
    none (the stratified pass is a kernel of its own,
    ``strat_pass_smem_bytes``)."""
    rt, ct = tile
    (cm, ci), (bm, bi), (am, ai), (wm, wi) = NL_ADJ_RINGS
    ring = lambda m, i: (rt + 2 * m) * (ct + 2 * i)  # noqa: E731
    w, c = ring(wm, wi), ring(cm, ci)
    edges = 6 * (1 + 3 * n_tracers) * c if n_tracers else 0
    vals = ((2 * (8 + 2 * n_tracers) * w + _NLA_A * ring(am, ai) + _NLA_B * ring(bm, bi)
             + _NLA_C * c + edges) * ks + (4 + (20 if masked else 4)) * w + 2 * rt * ct)
    return _RED_BYTES + itemsize * vals + 4 * (_NLA_INTS * w + 6 * c)


def nl_adjoint_slice(tile, k: int, itemsize: int, n_tracers: int = 0,
                     masked: bool = False) -> int:
    """The largest slice (levels, a power of two up to 16 and the level
    chunk) at which the nonlinear reverse's ``tile`` fits one block with the
    arms' shared memory (``nl_adjoint_smem_bytes``); at least one level."""
    kc = level_split(k)[1]
    ks = 1
    while ks * 2 <= min(16, kc) and nl_adjoint_smem_bytes(tile, itemsize, ks * 2, n_tracers,
                                                          masked) <= SMEM_BYTES:
        ks *= 2
    return ks


# The stratified pass (csrc/adjoint_window.cuh, strat_pass_kernel): its
# threads, its level splits (blocks per group of cells), its largest group
# count (one group per 64 cells up to it) and the sub-chunks it tries,
# largest first
_PASS_THREADS, _PASS_SPLITS, _PASS_GROUPS, _PASS_CELLS = 512, 2, 64, (128, 64, 32, 16, 8)


def strat_pass_smem_bytes(k: int, cb: int, kb: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the stratified pass at k
    levels in sub-chunks of cb cells with kb of W's columns staged at once
    (``strat_pass_smem_bytes`` in csrc/adjoint_window.cuh): a half's rows
    of W at those columns transposed [kb][kh] (kh = 8 ceil(k / 16), the
    half's levels), the sub-chunk's S [8 ceil(k / 8)] and h [kh] rows of
    cb + 4 values, and the warps' d(dt) sums."""
    kh, kp = -(-k // 16) * 8, -(-k // 8) * 8
    return itemsize * (kb * kh + (kp + kh) * (cb + 4)) + 8 * (_PASS_THREADS // 32)


def strat_pass_fit(k: int, itemsize: int) -> tuple[int, int]:
    """The stratified pass's staging at k levels (``strat_pass_fit`` in
    csrc/adjoint_window.cuh): (cb, kb), the sub-chunk cb the largest of
    128, 64, 32, 16, 8 cells whose W S tiles (4 levels x 4 cells) are at
    most one a thread and whose S and h leave room in one block for 8 of
    W's columns (all below 8), then kb the most of W's columns that fit:
    all k, else a multiple of 8. ValueError where no sub-chunk fits (past
    1320 levels in f64, 2048 in f32)."""
    kh = -(-k // 16) * 8
    for cb in _PASS_CELLS:
        if (kh // 4) * (cb // 4) > _PASS_THREADS:
            continue
        base = strat_pass_smem_bytes(k, cb, 0, itemsize)
        if base + itemsize * kh * min(k, 8) > SMEM_BYTES:
            continue
        room = (SMEM_BYTES - base) // (itemsize * kh)
        return cb, k if room >= k else room // 8 * 8
    raise ValueError(f"the stratified pass of the nonlinear reverse fits no block at {k} "
                     f"levels of {itemsize}-byte values (a sub-chunk of h and S and 8 of W's "
                     f"columns in {SMEM_BYTES} bytes of shared memory)")


def strat_pass_groups(cells: int) -> int:
    """The stratified pass's groups of cells over ``cells`` cells: one per 64
    cells, at most 64 (each group holds a K x K partial of d(W) in device
    memory, and takes _PASS_SPLITS blocks, one per half of the levels)."""
    return max(1, min(_PASS_GROUPS, -(-cells // 64)))


def nl_adjoint_plan(ny2: int, nx: int, k: int, itemsize: int, tiles=None, *,
                    n_tracers: int = 0, strat: bool = False, masked: bool = False):
    """The nonlinear reverse's plan (rows, columns, levels per slice) on a
    ny2 x nx lattice at k levels, with ``n_tracers`` tracers sized with
    their arm's shared memory (``masked``: the channel's 20 vertex constant
    planes), reckoned as ``fe_step.nl_plan``: among ``tiles`` (by default
    the powers of two up to 64 a side, cut to the lattice; the kernel runs
    ragged tiles), the tile of largest area that fits one block's shared
    memory at NL_ADJ_SLICE levels per slice and makes at least one block for
    each of the card's SMS SMs (else the largest that fits), then the
    smallest window, then the widest; then the largest slice that still fits
    (``nl_adjoint_slice``). One block per SM: the budget is one block's.
    With ``strat`` the stratified pass must fit too (``strat_pass_fit``). A
    tile that fits
    at one level per slice where none fits at NL_ADJ_SLICE is taken so;
    where none fits at all, it raises ValueError."""
    kc = level_split(k)[1]
    wm, wi = NL_ADJ_RINGS[-1]
    if strat:
        strat_pass_fit(k, itemsize)
    if tiles is None:
        tiles = {(min(1 << a, ny2), min(1 << b, nx)) for a in range(7) for b in range(7)}
    for base in (min(NL_ADJ_SLICE, kc), 1):
        ok = [t for t in tiles
              if nl_adjoint_smem_bytes(t, itemsize, base, n_tracers, masked) <= SMEM_BYTES]
        if ok:
            break
    if not ok:
        raise ValueError(f"no tile of the nonlinear reverse fits ({k} levels of {itemsize}-byte "
                         f"values, {n_tracers} tracers)")
    ranks = level_split(k)[0]
    full = [t for t in ok if -(-ny2 // t[0]) * -(-nx // t[1]) * ranks >= SMS] or ok
    *_, ct, rt = max((t[0] * t[1], -(t[0] + 2 * wm) * (t[1] + 2 * wi), t[1], t[0])
                     for t in full)
    return rt, ct, nl_adjoint_slice((rt, ct), k, itemsize, n_tracers, masked)


def nl_adjoint_launch_plan(ny2: int, nx: int, k: int, tile, ks: int) -> dict:
    """The launch of the nonlinear reverse for ``tile`` at ks levels per
    slice on an f32 periodic ny2 x nx x k lattice: its clusters (one per
    tile), the blocks one SM holds (CUDA's occupancy calculator) and one
    block's shared memory in bytes."""
    fn = build.load().mot_nl_adjoint_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    check_error("the nonlinear reverse's plan query",
                fn(ny2, nx, k, *tile, ks, ctypes.addressof(out)))
    return {"clusters": out[0], "blocks_per_sm": out[1], "smem_bytes": out[2]}


_ARGTYPES = ([ctypes.c_void_p] * 32 + [ctypes.c_double] * 8 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])


def check_dforc(dforc, forcing, ny2: int, nx: int, dtype, device) -> None:
    """The forced reverse arms' accumulators (``structured.adjoint.ForcingCot``:
    d(wind) (6, ny2, nx) in the state dtype, d(r_lin, Cd, lambda) float64
    (3,)), given exactly with ``forcing``."""
    if (dforc is None) != (forcing is None):
        raise ValueError("the forced reverse takes forcing and dforc together")
    if dforc is not None:
        check_tensor("dforc wind", dforc.wind, (6, ny2, nx), dtype, device)
        check_tensor("dforc coefs", dforc.coefs, (3,), torch.float64, device)


def dforc_args(dforc) -> tuple:
    """The (d(wind), d(coefs)) pointers of a reverse entry, or nulls."""
    return (None, None) if dforc is None else (dforc.wind.data_ptr(), dforc.coefs.data_ptr())


def check_reverse_tracers(tracers, end, groups, live, slots: int, ny2: int, nx: int, k: int,
                          dtype, device) -> int:
    """The reverse tracer arms' operands: ``tracers`` as for
    ``fe_step.fe_fill_stack`` (its planes the tracer stack of ``slots``
    slots), ``end`` = (h (2, ny2, nx, K), tracer planes (2 nT, ny2, nx, K))
    of the state after the last slot, and the cotangent groups (name,
    tuple) each carrying the tracer planes fourth; or, without tracers,
    groups of three. Returns the tracer count (0 without)."""
    if tracers is None:
        for name, group in groups:
            if len(group) != 3:
                raise ValueError(f"{name} carries tracers, but no tracers= were given")
        if end is not None:
            raise ValueError("end= is the tracer arm's")
        return 0
    check_tracer_stack(tracers, live, slots, ny2, nx, k, dtype, device)
    planes = tracers.planes.shape[1:]
    if end is None or len(end) != 2:
        raise ValueError("the tracer arm reads end = (h, tracer planes) of the state after "
                         "the stack's last slot")
    check_tensor("end h", end[0], (2, ny2, nx, k), dtype, device)
    check_tensor("end tracers", end[1], planes, dtype, device)
    for name, group in groups:
        if len(group) != 4:
            raise ValueError(f"{name} must carry the tracer planes fourth")
        check_tensor(f"{name} tracers", group[3], planes, dtype, device)
    return planes[0] // 2


def check_dstrat(strat_w, dstrat, k: int, dtype, device) -> None:
    """The stratified reverse arms' operands: W (K, K) in the state dtype
    (``fe_step.check_strat``) and its cotangent's accumulator ``dstrat``
    (K, K) float64, given together."""
    if (strat_w is None) != (dstrat is None):
        raise ValueError("the stratified reverse takes strat_w and dstrat together")
    check_strat(strat_w, k, dtype, device)
    if dstrat is not None:
        check_tensor("dstrat", dstrat, (k, k), torch.float64, device)


def strat_args(strat_w, dstrat, tiles: int, k: int) -> tuple:
    """The reverse entries' stratified pointers (W, the tiles' d(W)
    accumulators, d(W)), with the accumulators allocated here (tiles * K * K
    doubles, csrc/adjoint_window.cuh: AdjStrat), or nulls; and the
    accumulators, which the caller keeps until the entry has returned (the
    caching allocator then reuses them only for work queued after it on the
    stream)."""
    if strat_w is None:
        return (None, None, None), None
    acc = torch.empty(tiles * k * k, dtype=torch.float64, device=strat_w.device)
    return (strat_w.data_ptr(), acc.data_ptr(), dstrat.data_ptr()), acc


def reverse_tracer_args(tracers, end, g_in, out, scratch) -> tuple:
    """The reverse entries' tracer pointers (tracer stack, cotangent in,
    out and scratch, end h and tracers, cell mask), (kappa, upwind) and the
    tracer count, or nulls and zeros for the tracer-free arm."""
    if tracers is None:
        return (None,) * 7, (0.0, 0.0), 0
    mask = tracers.cell_mask
    ptrs = (tracers.planes, g_in[3], out[3], scratch[3], *end)
    return ((*(x.data_ptr() for x in ptrs), None if mask is None else mask.data_ptr()),
            (float(tracers.kappa), float(tracers.upwind)), tracers.planes.shape[1] // 2)


def _entry(dtype: torch.dtype):
    lib = build.load()
    fn = {torch.float32: lib.mot_adjoint_rollout_f32,
          torch.float64: lib.mot_adjoint_rollout_f64}[dtype]
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _rollout(stack, g_in, f_edge, table, weights, scal, n_steps, ddt, out, scratch, tile,
             live=None, forcing=None, dforc=None, tracers=None, end=None, strat_w=None,
             dstrat=None):
    """``adjoint_rollout`` with scal = (dt, inv_dc, s_div), over tiles of
    ``tile`` (rows, columns) sites, or ``adjoint_tile``'s for None (the tile
    sweep and the tests give their own)."""
    global launches, forced_launches, tracer_launches, strat_launches
    ssh_st, h_st, u_st = stack
    if h_st.dim() != 5:
        raise ValueError(f"h stack must be (S, 2, ny2, nx, K), got {tuple(h_st.shape)}")
    ny2, nx, k = lattice_dims(h_st[0], "adjoint_step")
    dtype, device = h_st.dtype, h_st.device
    if n_steps < 1:
        raise ValueError("adjoint_rollout takes n_steps >= 1")
    slots = h_st.shape[0]
    if n_steps > slots:
        raise ValueError(f"{n_steps} steps need {n_steps} primal slots, got {slots}")
    shapes = state_shapes(ny2, nx, k)
    check_tensor("f_edge", f_edge, (3, 2, ny2, nx), dtype, device)
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
        scratch = out if n_steps == 1 else tuple(torch.empty_like(x) for x in out)
    for x, shape, f in zip(stack, shapes[:3], ("ssh", "h", "u")):
        check_tensor(f"stack {f}", x, (slots, *shape), dtype, device)
    n_tr = check_reverse_tracers(tracers, end, (("g_in", g_in), ("out", out),
                                                ("scratch", scratch)),
                                 live, slots, ny2, nx, k, dtype, device)
    strat = strat_w is not None
    for group, name in ((g_in, "g_in"), (out, "out"), (scratch, "scratch")):
        for x, shape, f in zip(group, shapes[:3], ("ssh", "h", "u")):
            check_tensor(f"{name} {f}", x, shape, dtype, device)
    table, weights, n_terms = host_stencil(table, weights)
    itemsize, masked = h_st.element_size(), live is not None
    if tile is None:
        tile = adjoint_tile(ny2, nx, k, itemsize, n_tr, strat, forcing is not None)
    tile = tuple(tile)
    need = smem_bytes(tile, k, itemsize, forcing is not None, n_tr, strat)
    if need > SMEM_BYTES:
        raise ValueError(f"an adjoint_step tile {tile} at {k} levels needs {need} bytes of "
                         f"shared memory per block, more than {SMEM_BYTES}")
    ranks, _ = level_split(k)
    tiles = -(-ny2 // tile[0]) * -(-nx // tile[1])
    shares = 1 if forcing is None else SHARES
    part = torch.empty(shares * n_steps * tiles * ranks, dtype=torch.float64, device=device)
    fn = _entry(dtype)
    ptrs, coefs = forcing_args(forcing, level_split(k)[1])
    tr_ptrs, tr_opts, n_tr = reverse_tracer_args(tracers, end, g_in, out, scratch)
    st_ptrs, _acc = strat_args(strat_w, dstrat, tiles, k)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            f_edge.data_ptr(), live.data_ptr() if masked else None, *ptrs, *dforc_args(dforc),
            table.ctypes.data, weights.ctypes.data,
            *[x.data_ptr() for x in (*stack[:3], *g_in[:3], *out[:3], *scratch[:3], part, ddt)],
            *tr_ptrs, *st_ptrs, *(float(x) for x in scal), *coefs[:3], *tr_opts, *coefs[3:],
            ny2, nx, k, n_steps, n_terms, *tile, n_tr, stream,
        )
    check_error("adjoint_step", err, f" (tile {tile})")
    launches += n_steps
    if forcing is not None:
        forced_launches += n_steps
    if tracers is not None:
        tracer_launches += n_steps
    if strat:
        strat_launches += n_steps
    return out


def adjoint_rollout(stack, g_in, f_edge, stencil_table, coriolis_weight,
                    dt: float, inv_dc: float, s_div: float, n_steps: int,
                    ddt: torch.Tensor, out=None, scratch=None, live=None, forcing=None,
                    dforc=None, tracers=None, end=None, strat_w=None, dstrat=None):
    """n_steps >= 1 reverse forward-Euler steps of the linear core on the
    card.

    ``stack`` = (ssh (S, 2, ny2, nx), h (S, 2, ny2, nx, K),
    u (S, 3, 2, ny2, nx, K)) holds the primal state of step j in slot j,
    S >= n_steps. ``g_in`` = (ssh, h, u) is the cotangent at step n_steps
    and is left as it is. ``stencil_table`` / ``coriolis_weight`` are the
    TRANSPOSED Coriolis stencil packed by ``fe_step.pack_stencil``, on the
    host (``StructMesh.host_adjoint_stencil``); a table that is not the hex
    lattice's transpose raises ValueError. d(dt) is added to ``ddt``, a
    float64 (1,) tensor on the card. Returns the cotangent at step 0,
    written into ``out`` (allocated when None), through ``scratch``
    (allocated when None and n_steps > 1). The scalars are rounded to the
    state dtype as for the forward kernel. ``live`` (the wall mask's live
    bits, as for ``fe_step.fe_rollout``, or None) runs the masked arm, the
    reverse of the masked forward step. ``forcing`` (as for
    ``fe_step.fe_rollout``) runs the forced arm, the reverse of the forced
    step, which adds d(wind) and d(r_lin, Cd, lambda) to ``dforc`` (a
    ``structured.adjoint.ForcingCot`` of a (6, ny2, nx) tensor in the state
    dtype and a float64 (3,) tensor, on the card). ``tracers`` (as for
    ``fe_step.fe_fill_stack``: ``fused_model.kernel_tracers``' operands whose
    planes are the tracer stack (S, 2 nT, ny2, nx, K) of the primal
    tracers) runs the tracer arm: ``g_in``, ``out`` and
    ``scratch`` then carry the tracer cotangent planes (2 nT, ny2, nx, K)
    fourth, and ``end`` = (h, tracer planes) is the state after slot
    n_steps - 1 (the next checkpoint, or the rollout's final state), whose
    h' and T' the last step reads. ``strat_w`` (W (K, K) in the state dtype,
    on the card: ``fused_model.kernel_strat``) runs the stratified arm,
    which adds d(W) to ``dstrat``, a float64 (K, K) tensor on the card. The
    forced, tracer and stratified arms compose in any combination."""
    return _rollout(stack, g_in, f_edge, stencil_table, coriolis_weight, (dt, inv_dc, s_div),
                    n_steps, ddt, out, scratch, None, live, forcing, dforc, tracers, end,
                    strat_w, dstrat)


def _nl_reverse_checks(name, stack, g_in, fv, stencil_table, coriolis_weight, adjoint_table,
                       adjoint_weight, vertex_cell_terms, edge_vertex_terms, n_steps, ddt, out,
                       scratch, live, forcing, dforc, tracers, end, strat_w, dstrat):
    """The nonlinear reverses' checks of their operands (as ``nl_adjoint_rollout``
    takes them), with ``out`` and ``scratch`` allocated where None: ((ny2,
    nx, k), out, scratch, the tracer count, the vertex constants' planes,
    the host tables (stencil, its transpose, the vertex tables) and the
    stencil's term count)."""
    ssh_st, h_st, u_st = stack
    if h_st.dim() != 5:
        raise ValueError(f"h stack must be (S, 2, ny2, nx, K), got {tuple(h_st.shape)}")
    ny2, nx, k = lattice_dims(h_st[0], name)
    dtype, device = h_st.dtype, h_st.device
    if n_steps < 1:
        raise ValueError(f"{name} takes n_steps >= 1")
    slots = h_st.shape[0]
    if n_steps > slots:
        raise ValueError(f"{n_steps} steps need {n_steps} primal slots, got {slots}")
    shapes = state_shapes(ny2, nx, k)
    check_live(live, ny2, nx, device)
    n_fv = 4 if live is None else 20
    check_tensor("fv", fv, (n_fv, ny2, nx), dtype, device)
    check_tensor("ddt", ddt, (1,), torch.float64, device)
    check_forcing(forcing, ny2, nx, dtype, device)
    check_dforc(dforc, forcing, ny2, nx, dtype, device)
    check_dstrat(strat_w, dstrat, k, dtype, device)
    if tracers is not None:
        shapes = (*shapes, tracers.planes.shape[1:])
    if out is None:
        out = tuple(torch.empty(s, dtype=dtype, device=device) for s in shapes)
    if scratch is None:
        scratch = out if n_steps == 1 else tuple(torch.empty_like(x) for x in out)
    for x, shape, f in zip(stack, shapes[:3], ("ssh", "h", "u")):
        check_tensor(f"stack {f}", x, (slots, *shape), dtype, device)
    n_tr = check_reverse_tracers(tracers, end, (("g_in", g_in), ("out", out),
                                                ("scratch", scratch)),
                                 live, slots, ny2, nx, k, dtype, device)
    for group, gname in ((g_in, "g_in"), (out, "out"), (scratch, "scratch")):
        for x, shape, f in zip(group, shapes[:3], ("ssh", "h", "u")):
            check_tensor(f"{gname} {f}", x, shape, dtype, device)
    table, weights, n_terms = host_stencil(stencil_table, coriolis_weight)
    adj_table, adj_weights, n_adj = host_stencil(adjoint_table, adjoint_weight)
    if n_adj != n_terms:
        raise ValueError("the adjoint table must be the transpose of the stencil table")
    tables = (table, weights, adj_table, adj_weights,
              *vertex_tables(vertex_cell_terms, edge_vertex_terms))
    return (ny2, nx, k), out, scratch, n_tr, n_fv, tables, n_terms


def _nl_reverse_args(stack, g_in, out, scratch, fv, n_fv, live, tables, part, ddt, forcing,
                     dforc, tracers, end, strat_w, dstrat, kc: int, tiles: int, k: int) -> tuple:
    """The nonlinear reverse entries' shared pointers, from ``fv`` to the
    stratified arm's (``_NL_ARGTYPES``' first 38), and the arms' scalars
    (r_lin, Cd, lambda; kappa, upwind; the rank masks), with the d(W)
    accumulators the caller keeps until the entry has returned."""
    ptrs, coefs = forcing_args(forcing, kc)
    tr_ptrs, tr_opts, _ = reverse_tracer_args(tracers, end, g_in, out, scratch)
    st_ptrs, acc = strat_args(strat_w, dstrat, tiles, k)
    return ((fv.data_ptr(), n_fv, None if live is None else live.data_ptr(), *ptrs,
             *dforc_args(dforc), *(t.ctypes.data for t in tables),
             *[x.data_ptr() for x in (*stack, *g_in[:3], *out[:3], *scratch[:3], part, ddt)],
             *tr_ptrs, *st_ptrs), (*coefs[:3], *tr_opts), coefs[3:], acc)


_NL_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 38
                + [ctypes.c_double] * 12 + [ctypes.c_int] * 13 + [ctypes.c_void_p])


def nl_adjoint_rollout(stack, g_in, fv, stencil_table, coriolis_weight, adjoint_table,
                       adjoint_weight, vertex_cell_terms, edge_vertex_terms, dt: float,
                       inv_dc: float, s_div: float, s_ke: float, s_curl: float,
                       ds_scale: float, dke_scale: float, n_steps: int, ddt: torch.Tensor,
                       out=None, scratch=None, *, live=None, tile=None, ks=None,
                       forcing=None, dforc=None, tracers=None, end=None, strat_w=None,
                       dstrat=None, _kc=None):
    """n_steps >= 1 reverse forward-Euler steps of the nonlinear core on the
    card, one launch of the nonlinear reverse kernel (csrc/nl_adjoint.cuh)
    each, over tiles of ``tile`` (rows, columns; ragged ones too) in slices
    of ks levels, by default ``nl_adjoint_plan``'s tile and the largest
    slice that fits it, each sized with the arms' shared memory; a block
    takes the levels of the split the kernel's launch reckons fastest from
    the clusters the card keeps resident (csrc/nl_adjoint.cu, choose_kc;
    the tools and tests may fix it with ``_kc``, a multiple of ks with at
    most MAX_CLUSTER blocks a tile).

    ``stack``, ``g_in``, ``ddt``, ``out``, ``scratch`` and ``live`` as for
    ``adjoint_rollout``; ``fv`` the vertex constants
    (``fused_model.nl_setup``: 4 planes, or 20 with ``live``); the Coriolis
    stencil and its transpose on the host (``StructMesh.host_stencil``,
    ``host_adjoint_stencil``), the vertex stencils as ``StructMesh`` holds
    them; the scalars rounded to the state dtype (``fused_model._scal``,
    ``fused_model.nl_scal``, and ds_scale = g dt / dc, dke_scale = dt / dc
    from ``fused_model.nl_adjoint_scal``). ``forcing`` and ``dforc``,
    ``tracers`` and ``end``, ``strat_w`` and ``dstrat`` run the forced,
    tracer and stratified arms, in any combination, as for
    ``adjoint_rollout`` (``g_in``, ``out`` and ``scratch`` then carry the
    tracer cotangent planes fourth); the stratified arm runs one launch of
    the stratified pass after each step (``nl_strat_pass_launches``), its S
    scratch, d(W) partials and d(dt) shares allocated here. Returns the
    cotangent at step 0. A stencil or vertex table that is not the hex
    lattice's raises ValueError."""
    global nl_launches, nl_forced_launches, nl_tracer_launches, nl_strat_launches
    global nl_strat_pass_launches
    (ny2, nx, k), out, scratch, n_tr, n_fv, tables, n_terms = _nl_reverse_checks(
        "the nonlinear reverse", stack, g_in, fv, stencil_table, coriolis_weight, adjoint_table,
        adjoint_weight, vertex_cell_terms, edge_vertex_terms, n_steps, ddt, out, scratch, live,
        forcing, dforc, tracers, end, strat_w, dstrat)
    dtype, device, itemsize = fv.dtype, fv.device, fv.element_size()
    strat, masked = strat_w is not None, live is not None
    arms = dict(n_tracers=n_tr, masked=masked)
    if tile is None:
        tile = nl_adjoint_plan(ny2, nx, k, itemsize, strat=strat, **arms)[:2]
    tile = tuple(tile)
    ks = nl_adjoint_slice(tile, k, itemsize, **arms) if ks is None else ks
    chunk = level_split(k)[1]
    if not (1 <= ks <= min(16, chunk) and ks & (ks - 1) == 0):
        raise ValueError(f"the nonlinear reverse's slices are a power of two of levels up to "
                         f"{min(16, chunk)} (its level chunk at {k} levels), got {ks}")
    need = nl_adjoint_smem_bytes(tile, itemsize, ks, **arms)
    if need > SMEM_BYTES:
        raise ValueError(f"a nonlinear reverse tile {tile} at {k} levels in slices of {ks} "
                         f"needs {need} bytes of shared memory per block, more than "
                         f"{SMEM_BYTES}")
    if _kc is not None and not (_kc >= ks and _kc % ks == 0 and -(-k // _kc) <= MAX_CLUSTER):
        raise ValueError(f"the nonlinear reverse's blocks take a multiple of its slice ({ks}) "
                         f"of levels, at most {MAX_CLUSTER} a tile, got {_kc} of {k}")
    tiles = -(-ny2 // tile[0]) * -(-nx // tile[1])
    shares = 1 if forcing is None else SHARES
    # one share a block: the kernel picks the blocks a tile (up to MAX_CLUSTER)
    part = torch.empty(shares * n_steps * tiles * MAX_CLUSTER, dtype=torch.float64,
                       device=device)
    groups = strat_pass_groups(2 * ny2 * nx)
    s_scr = pass_shares = None
    if strat:
        strat_pass_fit(k, itemsize)
        s_scr = torch.empty((2, ny2, nx, k), dtype=dtype, device=device)
        pass_shares = torch.empty(n_steps * groups * _PASS_SPLITS, dtype=torch.float64,
                                  device=device)
    lib = build.load()
    fn = {torch.float32: lib.mot_nl_adjoint_f32, torch.float64: lib.mot_nl_adjoint_f64}[dtype]
    fn.argtypes = _NL_ARGTYPES
    fn.restype = ctypes.c_int
    ptrs, opts, ranks_masks, _acc = _nl_reverse_args(
        stack, g_in, out, scratch, fv, n_fv, live, tables, part, ddt, forcing, dforc, tracers,
        end, strat_w, dstrat, chunk, groups, k)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *ptrs, *(None if x is None else x.data_ptr() for x in (s_scr, pass_shares)),
            *(float(x) for x in (dt, inv_dc, s_div, s_ke, s_curl, ds_scale, dke_scale)),
            *opts, *ranks_masks, ny2, nx, k, n_steps, n_terms, *tile, ks, groups, _kc or 0,
            n_tr, stream,
        )
    check_error("the nonlinear reverse", err, f" (tile {tile}, slice {ks})")
    nl_launches += n_steps
    nl_forced_launches += n_steps if forcing is not None else 0
    nl_tracer_launches += n_steps if tracers is not None else 0
    nl_strat_launches += n_steps if strat else 0
    nl_strat_pass_launches += n_steps if strat else 0
    return out


def nl_strat_pass(h, s, w, dh, dt: float, inv_dc: float, dstrat, ddt):
    """One step's stratified pass of the nonlinear reverse, alone (the
    launch nl_adjoint_rollout makes after each stratified step): for the
    primal h and the step's S = sum_owned gu - sum_incoming gu (each
    (2, ny2, nx, K) or (cells, K)), W (K, K), dh += (dt / dc) S W^T in
    place, d(W) (dt / dc) sum_c h (x) S added to ``dstrat`` (K, K) f64 and
    d(dt)'s W part to ``ddt`` (1,) f64. On CUDA tensors one launch of the
    kernel (csrc/adjoint_window.cuh, strat_pass_kernel; counted in
    ``nl_strat_pass_launches``), on CPU tensors its plain version
    ``structured.adjoint.strat_pass``. Returns dh."""
    global nl_strat_pass_launches
    k = h.shape[-1]
    dtype, device = h.dtype, h.device
    for name, x in (("h", h), ("s", s), ("dh", dh)):
        check_tensor(name, x, tuple(h.shape), dtype, device)
    check_tensor("strat_w", w, (k, k), dtype, device)
    check_tensor("dstrat", dstrat, (k, k), torch.float64, device)
    check_tensor("ddt", ddt, (1,), torch.float64, device)
    if device.type != "cuda":
        from ..structured.adjoint import strat_pass

        dh_w, d_w, d_dt = strat_pass(h, s, w, dt, inv_dc)
        dh += dh_w
        dstrat += d_w
        ddt += d_dt
        return dh
    cells = h.numel() // k
    strat_pass_fit(k, h.element_size())
    groups = strat_pass_groups(cells)
    acc = torch.empty(groups * k * k, dtype=torch.float64, device=device)
    shares = torch.empty(groups * _PASS_SPLITS, dtype=torch.float64, device=device)
    lib = build.load()
    fn = {torch.float32: lib.mot_strat_pass_f32, torch.float64: lib.mot_strat_pass_f64}[dtype]
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_double] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(x.data_ptr() for x in (h, s, w, dh, acc, shares, dstrat, ddt)), float(dt),
                 float(inv_dc), cells, k, groups, stream)
    check_error("the stratified pass", err, f" ({cells} cells, {k} levels)")
    nl_strat_pass_launches += 1
    return dh


# The q-step nonlinear reverse (csrc/nl_window_adjoint.cuh): launches made by
# nl_window_adjoint_rollout (one per superstep of q steps), and those of them
# that ran the forced, the tracer and the stratified arm
nl_window_launches = 0
nl_window_forced_launches = 0
nl_window_tracer_launches = 0
nl_window_strat_launches = 0
# ... its recompute's FE step: reach and ring of derived planes (fe_step's
# NL_REACH and NL_RING, FE)
NL_WIN_FWD = ((2, 4), (1, 2))


def nl_window_smem_bytes(tile, k: int, itemsize: int, ks: int, n_tracers: int = 0,
                         strat: bool = False, forced: bool = False) -> int:
    """Dynamic shared memory of one block of the q-step nonlinear reverse
    for a tile (rows, columns) at k levels in slices of ks
    (``nl_window_smem_bytes`` in csrc/nl_window_adjoint.cuh), whatever q:
    the warps' d(dt) sums and four ints per reverse window site (lattice,
    primal and cotangent scratch sites, live bits), then the larger of the
    reverse's layout (``nl_adjoint_smem_bytes``' values and stratified
    part) and the recompute's (the FE step's with one state slice, its
    derived planes, the window's ssh, rts and vertex constants, the partial
    sums; with ``strat`` Phi's ssh, the kept momentum and
    ``fe_step.strat_smem_bytes`` with the h chunk; with ``forced`` the
    tile's winds and levels, ``fe_step.forcing_smem_bytes``)."""
    rt, ct = tile
    (cm, ci), (bm, bi), (am, ai), (wm, wi) = NL_ADJ_RINGS
    (fm, fi), (dm, di) = NL_WIN_FWD
    ring = lambda m, i: (rt + 2 * m) * (ct + 2 * i)  # noqa: E731
    w, fw, core, fs = ring(wm, wi), ring(fm, fi), rt * ct, ring(1, 1)
    kc = level_split(k)[1]
    n_pl = 8 + 2 * n_tracers
    rev = (itemsize * ((2 * n_pl * w + _NLA_A * ring(am, ai) + _NLA_B * ring(bm, bi)
                        + _NLA_C * ring(cm, ci)) * ks + _NLA_SITE * w + 2 * core)
           + (strat_smem_bytes(core, kc, k, itemsize) if strat else 0))
    fvals = (n_pl * fw + _NL_DERIVED * ring(dm, di)) * ks + _NLA_SITE * fw + 2 * core
    if strat:
        fvals += 2 * fs + 6 * core * kc
    fwd = (itemsize * fvals + (fe_strat_smem_bytes(fs, kc, k, itemsize, True) if strat else 0)
           + (forcing_smem_bytes(core, 0, itemsize) if forced else 0))
    return _RED_BYTES + 4 * 4 * w + max(rev, fwd)


def nl_window_scratch_values(tile, q: int, k: int, n_tracers: int = 0) -> int:
    """Values of one tile's scratch in device memory
    (``scratch_per_tile`` in csrc/nl_window_adjoint.cu): q - 1 slots of
    the recomputed primal states over the core grown by q (4, 6) +
    (q - 2) (2, 4) per side, then min(q - 1, 2) of the cotangents between
    the reverse steps over the core grown by (q - 1) (4, 6), each slot every
    rank's ssh pair (padded to a multiple of 4 values) and the 8 + 2
    n_tracers planes of K levels."""
    rt, ct = tile
    (_, _), (_, _), (_, _), (wm, wi) = NL_ADJ_RINGS
    (fm, fi), _ = NL_WIN_FWD
    ranks = level_split(k)[0]
    ps = (rt + 2 * (wm * q + fm * (q - 2))) * (ct + 2 * (wi * q + fi * (q - 2)))
    cs = (rt + 2 * wm * (q - 1)) * (ct + 2 * wi * (q - 1))
    planes = (8 + 2 * n_tracers) * k
    ssh = lambda sites: -(-2 * ranks * sites // 4) * 4  # noqa: E731
    return (q - 1) * (ssh(ps) + planes * ps) + min(q - 1, 2) * (ssh(cs) + planes * cs)


def nl_window_slice(tile, k: int, itemsize: int, n_tracers: int = 0, strat: bool = False,
                    forced: bool = False) -> int:
    """The largest slice (levels, a power of two up to 16 and the level
    chunk) at which the q-step nonlinear reverse's ``tile`` fits one block
    (``nl_window_smem_bytes``); at least one level."""
    kc = level_split(k)[1]
    ks = 1
    while ks * 2 <= min(16, kc) and nl_window_smem_bytes(tile, k, itemsize, ks * 2, n_tracers,
                                                         strat, forced) <= SMEM_BYTES:
        ks *= 2
    return ks


def nl_window_plan(ny2: int, nx: int, k: int, itemsize: int, tiles=None, *,
                   n_tracers: int = 0, strat: bool = False, forced: bool = False):
    """The q-step nonlinear reverse's plan (rows, columns, levels per slice),
    by ``nl_adjoint_plan``'s rule with this kernel's shared memory
    (``nl_window_smem_bytes``, which does not grow with q: the regions are
    walked in sub-tiles of the tile): among ``tiles`` (by default those
    that divide the lattice, which the kernel needs), the tile of largest
    area that fits one block at NL_ADJ_SLICE levels per slice (else at one)
    and makes at least one block for each of the card's SMS SMs (else the
    largest that fits), then the smallest window, then the widest; then the
    largest slice that fits. Where no tile fits, ValueError."""
    kc = level_split(k)[1]
    wm, wi = NL_ADJ_RINGS[-1]
    if tiles is None:
        tiles = [(r, c) for r in range(1, ny2 + 1) if ny2 % r == 0
                 for c in range(1, nx + 1) if nx % c == 0]
    arms = dict(n_tracers=n_tracers, strat=strat, forced=forced)
    ok = []
    for base in (min(NL_ADJ_SLICE, kc), 1):
        ok = [t for t in tiles if nl_window_smem_bytes(t, k, itemsize, base, **arms) <= SMEM_BYTES]
        if ok:
            break
    if not ok:
        raise ValueError(f"no tile of the q-step nonlinear reverse fits one block's shared "
                         f"memory ({SMEM_BYTES} bytes) at {k} levels of {itemsize}-byte "
                         f"values, {n_tracers} tracers, stratified: {strat}, forced: {forced}")
    ranks = level_split(k)[0]
    full = [t for t in ok if -(-ny2 // t[0]) * -(-nx // t[1]) * ranks >= SMS] or ok
    *_, ct, rt = max((t[0] * t[1], -(t[0] + 2 * wm) * (t[1] + 2 * wi), t[1], t[0])
                     for t in full)
    return rt, ct, nl_window_slice((rt, ct), k, itemsize, **arms)


_NL_WIN_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 37
                    + [ctypes.c_longlong] + [ctypes.c_double] * 12 + [ctypes.c_int] * 12
                    + [ctypes.c_void_p])


def nl_window_adjoint_rollout(stack, g_in, rts, fv, stencil_table, coriolis_weight,
                              adjoint_table, adjoint_weight, vertex_cell_terms,
                              edge_vertex_terms, dt: float, inv_dc: float, s_div: float,
                              s_ke: float, s_curl: float, ds_scale: float, dke_scale: float,
                              n_steps: int, q: int, ddt: torch.Tensor, out=None, scratch=None,
                              *, live=None, tile, ks=None, forcing=None, dforc=None,
                              tracers=None, end=None, strat_w=None, dstrat=None):
    """n_steps >= 1 reverse supersteps of q > 1 nonlinear forward-Euler
    steps each on the card, one launch of the q-step nonlinear reverse
    kernel (csrc/nl_window_adjoint.cuh) per superstep, over ``tile`` (rows,
    columns; they must divide the lattice) in slices of ks levels, by
    default the largest that fits (``nl_window_slice``).

    ``stack`` holds the superstep-start states (slot j the state before
    superstep j); ``rts`` the resting thickness sum (2, ny2, nx) in the
    state dtype, which the kernel's recompute of the steps inside a
    superstep reads; the rest as for ``nl_adjoint_rollout`` (``end`` the
    state after the last superstep). The tiles' recomputed states and
    cotangents between the steps live in a scratch allocated here
    (``nl_window_scratch_values`` per tile). Returns the cotangent at the
    first superstep's start. A tile that does not divide the lattice or
    fits no block raises ValueError."""
    global nl_window_launches, nl_window_forced_launches, nl_window_tracer_launches
    global nl_window_strat_launches
    if q < 2:
        raise ValueError(f"the q-step nonlinear reverse takes q >= 2, got {q} (q = 1 is "
                         f"nl_adjoint_rollout's)")
    tile = tuple(tile)
    ny2, nx = stack[1].shape[-3:-1]
    if ny2 % tile[0] or nx % tile[1]:
        raise ValueError(f"the q-step nonlinear reverse's tile {tile} must divide the "
                         f"{ny2} x {nx} lattice")
    (ny2, nx, k), out, scratch, n_tr, n_fv, tables, n_terms = _nl_reverse_checks(
        "the q-step nonlinear reverse", stack, g_in, fv, stencil_table, coriolis_weight,
        adjoint_table, adjoint_weight, vertex_cell_terms, edge_vertex_terms, n_steps, ddt, out,
        scratch, live, forcing, dforc, tracers, end, strat_w, dstrat)
    dtype, device, itemsize = fv.dtype, fv.device, fv.element_size()
    check_tensor("rts", rts, (2, ny2, nx), dtype, device)
    strat, forced = strat_w is not None, forcing is not None
    arms = dict(n_tracers=n_tr, strat=strat, forced=forced)
    ks = nl_window_slice(tile, k, itemsize, **arms) if ks is None else ks
    ranks, kc = level_split(k)
    if not (1 <= ks <= min(16, kc) and ks & (ks - 1) == 0):
        raise ValueError(f"the q-step nonlinear reverse's slices are a power of two of levels "
                         f"up to {min(16, kc)} (its level chunk at {k} levels), got {ks}")
    need = nl_window_smem_bytes(tile, k, itemsize, ks, **arms)
    if need > SMEM_BYTES:
        raise ValueError(f"a q-step nonlinear reverse tile {tile} at {k} levels in slices of "
                         f"{ks} needs {need} bytes of shared memory per block, more than "
                         f"{SMEM_BYTES}")
    tiles = (ny2 // tile[0]) * (nx // tile[1])
    shares = 1 if forcing is None else SHARES
    part = torch.empty(shares * n_steps * tiles * ranks, dtype=torch.float64, device=device)
    values = tiles * nl_window_scratch_values(tile, q, k, n_tr)
    tile_scratch = torch.empty(values, dtype=dtype, device=device)
    lib = build.load()
    fn = {torch.float32: lib.mot_nl_window_adjoint_f32,
          torch.float64: lib.mot_nl_window_adjoint_f64}[dtype]
    fn.argtypes = _NL_WIN_ARGTYPES
    fn.restype = ctypes.c_int
    ptrs, opts, ranks_masks, _acc = _nl_reverse_args(
        stack, g_in, out, scratch, fv, n_fv, live, tables, part, ddt, forcing, dforc, tracers,
        end, strat_w, dstrat, kc, tiles, k)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            rts.data_ptr(), *ptrs, tile_scratch.data_ptr(), values,
            *(float(x) for x in (dt, inv_dc, s_div, s_ke, s_curl, ds_scale, dke_scale)),
            *opts, *ranks_masks, ny2, nx, k, n_steps, n_terms, *tile, ks, n_tr, q, stream,
        )
    check_error("the q-step nonlinear reverse", err, f" (tile {tile}, slice {ks}, q {q})")
    nl_window_launches += n_steps
    nl_window_forced_launches += n_steps if forced else 0
    nl_window_tracer_launches += n_steps if tracers is not None else 0
    nl_window_strat_launches += n_steps if strat else 0
    return out
