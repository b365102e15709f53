"""Wrapper of the hand-written forward-Euler step kernel (csrc/fe_step.cu),
which replaces the TPU kernel ``_rollout_kernel``
(mpas_ocean_tpu/structured/pallas_model.py:320) for the linear core and, in
its nonlinear arm (csrc/nl_step.cuh, ``fe_nl_rollout``), for the
vector-invariant one, on a periodic lattice and, with the wall mask's
``live`` bits (``live_bits`` of ``StructMesh.edge_mask``), on a coastal
channel culled from one; the forward entries of both cores take momentum
forcing (``forcing=``, ``structured.fused_model.kernel_forcing``'s
operands), which runs the kernel's forced arm, tracers (``tracers=``,
``structured.fused_model.kernel_tracers``' operands), which run its tracer
arm, and a stratification's W (``strat_w=``,
``structured.fused_model.kernel_strat``), which runs its stratified arm, in
any combination.

The entries take tensors on a CUDA device and the stencil on the host
(``StructMesh.host_stencil``), and launch one kernel per step on the
current stream, each over tiles of ``fe_tile`` sites; they raise on
anything else, a stencil that is not the hex lattice's included:

* ``fe_rollout`` returns new state tensors (and new tracer planes);
* ``fe_rollout_into`` writes the result into tensors the caller gives;
* ``fe_fill_stack`` fills a stack of states, slot j + 1 = step(slot j);
* ``fe_nl_rollout`` returns new state tensors after nonlinear steps (or
  writes them into tensors the caller gives);
* ``fe_nl_fill_stack`` fills a stack of states with nonlinear steps.

Their plain PyTorch version is ``structured.model.structured_run_loop``,
which ``structured.fused_model`` runs for tensors on the CPU. ``launches``
counts kernel launches, ``forced_launches`` those of the forced arm,
``tracer_launches`` those of the tracer arm and ``strat_launches`` those of
the stratified arm.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..structured.stencils import INCOMING, NEIGHBOR
from . import build

__all__ = [
    "LIVE_BYTES",
    "MAX_TERMS",
    "best_tile",
    "check_forcing",
    "check_live",
    "check_strat",
    "check_tracer_stack",
    "check_tracers",
    "forcing_smem_bytes",
    "forcing_ranks",
    "live_bits",
    "fe_fill_stack",
    "fe_rollout",
    "fe_rollout_into",
    "fe_tile",
    "forced_launches",
    "host_stencil",
    "launch_plan",
    "launches",
    "level_split",
    "fe_nl_fill_stack",
    "fe_nl_rollout",
    "nl_launch_plan",
    "nl_plan",
    "nl_scratch_size",
    "nl_slice",
    "nl_smem_bytes",
    "pack_stencil",
    "smem_bytes",
    "strat_launches",
    "strat_smem_bytes",
    "tracer_args",
    "tracer_launches",
    "vertex_tables",
]

MAX_TERMS = 128  # kMaxTerms in csrc/lattice.cuh
# What the kernels' entries return for a stencil table that is not the hex
# lattice's (kNotHexTable in csrc/step_window.cuh)
NOT_HEX_TABLE = -1
_HEADER = 44  # kHeader in csrc/lattice.cuh
_MAX_INDEX = 2**31 - 1  # kMaxIndex in csrc/lattice.cuh
# Largest dynamic shared memory of one block on an H100 (sm_90), in bytes:
# the planners' budget; the kernels' entries check it against the device.
SMEM_BYTES = 232448
# An H100 SM's shared memory (228 KB), of which the runtime keeps 1 KB per
# block: two blocks of the forward kernels share an SM when each takes at
# most TWO_BLOCK_BYTES (their 512 threads at 64 registers allow two).
SM_SMEM_BYTES = 233472
TWO_BLOCK_BYTES = SM_SMEM_BYTES // 2 - 1024
# Most blocks in a thread-block cluster, which split a tile's levels
# (kMaxCluster in csrc/tiled_window.cuh, the portable maximum).
MAX_CLUSTER = 8
_FE_PLANES = 10  # kPlanes in csrc/fe_step.cu
# Bytes per window site of the masked arms' live bits, one int holding the
# six channels' wall mask (load_live in csrc/step_window.cuh)
LIVE_BYTES = 4
# The reach of one FE step, (rows, columns) per side: slab.stencil_reach of
# the hex lattice's tables; csrc/fe_step.cu derives it from the table.
FE_REACH = (1, 2)
# The nonlinear step's (csrc/nl_step.cuh, make_nl_plan), FE and FB: its
# reach, and the ring around the tile on which it computes the derived
# planes (slab.stencil_reach with the vertex taps, slab.derived_ring)
NL_REACH = {False: (2, 4), True: (3, 4)}
NL_RING = {False: (1, 2), True: (2, 2)}
# The nonlinear step's values per window site and level (two slices of the
# 8 state planes), per derived site and level (F, F q_e, q_e, KE), per
# window site (ssh, rts, 20 vertex constant planes reserved); ints per
# window site (site, live bits)
_NL_STATE, _NL_DERIVED, _NL_SITE, _NL_INTS = 16, 20, 24, 2
# Levels per slice of the nonlinear step (csrc/nl_step.cuh) at which its
# planner (nl_plan) sizes the tile; the slice then grows while it fits
NL_SLICE = 4
# At q > 1 the planner takes the largest slice, from NL_SLICE down, at
# which a tile of at least this many sites fits (nl_plan)
NL_Q_SITES = 32
# The SMs of an H100 SXM (the planners' count of a launch's waves)
SMS = 132

# kernel launches made by this module's entries (one per step), and those
# of them that ran the forced arm, the tracer arm and the stratified arm
launches = 0
forced_launches = 0
tracer_launches = 0
strat_launches = 0


def pack_stencil(terms) -> tuple[np.ndarray, np.ndarray]:
    """The stencil table the kernels read (layout in csrc/lattice.cuh) and
    the Coriolis weights in the table's term order, as float64.

    ``terms`` are (f_out, p_out, f_in, p_in, dm, di, w) tuples; they are
    grouped by output channel f_out * 2 + p_out, keeping their order within
    a channel, so the kernel sums each channel's terms in the order the
    plain version does."""
    terms = sorted(terms, key=lambda t: t[0] * 2 + t[1])  # stable
    if len(terms) > MAX_TERMS:
        raise ValueError(f"{len(terms)} Coriolis terms > {MAX_TERMS}")
    nbr = [NEIGHBOR[(c // 2, c % 2)] for c in range(6)]
    inc = [tap for p in (0, 1) for tap in INCOMING[p]]
    counts = np.bincount([t[0] * 2 + t[1] for t in terms], minlength=6)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    taps = [(t[2] * 2 + t[3], t[4], t[5]) for t in terms]
    table = np.concatenate(
        [[len(terms)], np.ravel(nbr), np.ravel(inc), offsets,
         np.ravel(taps) if taps else []]
    ).astype(np.int32)
    assert table.size == _HEADER + 3 * len(terms)
    return table, np.array([t[6] for t in terms], dtype=np.float64)


def level_split(k: int) -> tuple[int, int]:
    """(blocks per cluster, levels per block) of the forward window kernels
    (``step_chunk`` in csrc/step_window.cuh): the least power of two of
    levels per block over at most MAX_CLUSTER blocks (16 at K = 100); no
    block is without levels."""
    kc = 1
    while kc * MAX_CLUSTER < k:
        kc *= 2
    return -(-k // kc), kc


def forcing_smem_bytes(sites: int, extra: int, itemsize: int) -> int:
    """Shared memory the forced arms take beyond the unforced layout
    (``forcing_smem_bytes`` in csrc/step_window.cuh): 16 bytes of
    alignment, the window's six winds and ``extra`` more values per block in
    the state dtype, and its six packed levels per site."""
    return 16 + itemsize * (6 * sites + extra) + 4 * 6 * sites


def strat_smem_bytes(sites: int, kc: int, k: int, itemsize: int, fresh: bool = False) -> int:
    """Shared memory the stratified arms take beyond the unstratified
    layout (``strat_smem_bytes`` in csrc/step_window.cuh): 16 bytes of
    alignment, Phi and another rank's staged h [2][sites][kc] each, the
    block's columns of W [k][kc], and with ``fresh`` (tiled_step's FB arm)
    the fresh h' [2][sites][kc]."""
    return 16 + itemsize * ((6 if fresh else 4) * sites * kc + k * kc)


def smem_bytes(tile, k: int, itemsize: int, forced: bool = False, n_tracers: int = 0,
               strat: bool = False) -> int:
    """Dynamic shared memory of one fe_step block for a tile (rows, columns)
    at k levels (``smem_bytes`` in csrc/fe_step.cu): its level chunk of the
    window's state [8][sites][kc], the window's ssh, f_edge, rts, site
    indices and live bits (the masked arm's, which the periodic arm
    reserves too, so that one plan serves both), and the ranks' partial
    column sums of the tile's sites; with ``forced``, the forced arm's
    (``forcing_smem_bytes``); with ``n_tracers``, the tracer arm's chunk of
    the window's 2 n_tracers tracer planes; with ``strat``, the stratified
    arm's (``strat_smem_bytes``)."""
    ranks, kc = level_split(k)
    hm, hi = FE_REACH
    sites = (tile[0] + 2 * hm) * (tile[1] + 2 * hi)
    return (itemsize * (sites * ((8 + 2 * n_tracers) * kc + _FE_PLANES)
                        + ranks * 2 * tile[0] * tile[1])
            + (4 + LIVE_BYTES) * sites + (forcing_smem_bytes(sites, 0, itemsize) if forced else 0)
            + (strat_smem_bytes(sites, kc, k, itemsize) if strat else 0))


def best_tile(ny2: int, nx: int, reach, smem, name: str,
              budgets=(TWO_BLOCK_BYTES, SMEM_BYTES)) -> tuple[int, int]:
    """The tile (rows, columns) of a one-step window kernel on a ny2 x nx
    lattice: among the powers of two up to 64 a side, cut to the lattice,
    the tile of largest area whose window (``smem(tile)`` bytes of shared
    memory per block, ``reach`` = (rows, columns) per side) lets two blocks
    share an SM (TWO_BLOCK_BYTES), or else fits one block (``budgets``, in
    order of preference); then the smallest window; then the widest. Tiles
    need not divide the lattice."""
    hm, hi = reach
    tiles = {(min(1 << a, ny2), min(1 << b, nx)) for a in range(7) for b in range(7)}
    for budget in budgets:
        fit = [(rt * ct, -(rt + 2 * hm) * (ct + 2 * hi), ct, rt) for rt, ct in tiles
               if smem((rt, ct)) <= budget]
        if fit:
            *_, ct, rt = max(fit)
            return rt, ct
    raise ValueError(f"no {name} tile fits")


def fe_tile(ny2: int, nx: int, k: int, itemsize: int, n_tracers: int = 0,
            strat: bool = False, forced: bool = False) -> tuple[int, int]:
    """fe_step's tile (rows, columns) on a ny2 x nx lattice, by
    ``best_tile``'s rule, sized for the forced arm so that one tile serves
    both arms, or with ``n_tracers`` for the tracer arm's window and with
    ``strat`` for the stratified arm's, each with the forced arm's shared
    memory too where ``forced``. On an H100 at 64x64x100 and 256x256x100 f32
    that is (4, 16), periodic or masked: the fastest tile at 64^2 and within
    2.5% of the fastest at 256^2, where the best one-block tile took 1.12x
    as long (PERF.md section 5, tools/tile_sweep.py). A tracer count whose
    window fits no tile raises ValueError."""
    if n_tracers or strat:
        arms = ", ".join(x for x, on in ((f"{n_tracers} tracers", n_tracers),
                                         ("stratified", strat), ("forced", forced)) if on)
        return best_tile(ny2, nx, FE_REACH,
                         lambda t: smem_bytes(t, k, itemsize, forced, n_tracers, strat),
                         f"fe_step ({k} levels of {itemsize}-byte values, {arms})")
    return best_tile(ny2, nx, FE_REACH, lambda t: smem_bytes(t, k, itemsize, forced=True),
                     f"fe_step ({k} levels of {itemsize}-byte values)")


def nl_smem_bytes(tile, k: int, itemsize: int, fb: bool, ks: int, forced: bool = False,
                  n_tracers: int = 0, strat: bool = False, q: int = 1) -> int:
    """Dynamic shared memory of one block of the nonlinear step for a tile
    (rows, columns) at k levels in slices of ks (``nl_smem_bytes`` in
    csrc/nl_step.cuh): two state slices of the window (with ``n_tracers``,
    the tracer arm's 2 n_tracers planes each), the derived planes on the
    tile plus its ring, the window's ssh, rts and vertex constants, the
    partial column sums (on the tile, FB: plus one ring), for FB and with
    ``strat`` the pressure's ssh and the chunk's momentum on the tile, and
    the window's site indices and live bits; with ``strat``, the stratified
    arm's Phi, staging, W slice and chunk of h on the tile plus one ring
    (``strat_smem_bytes`` with ``fresh``); with ``forced``, the tile's winds
    and packed levels (``forcing_smem_bytes``). At q > 1, the q-step
    kernel's (``nl_tiled_smem_bytes`` in csrc/nl_tiled.cuh): the q = 1
    kernel's at the tile grown by q - 1 reaches per side, and a second ssh
    pair over its window."""
    (hm, hi), (dr, dc) = NL_REACH[fb], NL_RING[fb]
    rt, ct = tile[0] + 2 * hm * (q - 1), tile[1] + 2 * hi * (q - 1)
    _, kc = level_split(k)
    w = (rt + 2 * hm) * (ct + 2 * hi)
    d = (rt + 2 * dr) * (ct + 2 * dc)
    f, core = (rt + 2) * (ct + 2), rt * ct
    vals = (_NL_STATE + 4 * n_tracers) * w * ks + _NL_DERIVED * d * ks + _NL_SITE * w \
        + 2 * (f if fb else core)
    if fb or strat:
        vals += 2 * f + 6 * core * kc
    if q > 1:
        vals += 2 * w
    return (itemsize * vals + 4 * _NL_INTS * w
            + (strat_smem_bytes(f, kc, k, itemsize, fresh=True) if strat else 0)
            + (forcing_smem_bytes(core, 0, itemsize) if forced else 0))


def nl_plan(ny2: int, nx: int, k: int, itemsize: int, fb: bool = False, tiles=None,
            forced: bool = False, n_tracers: int = 0, strat: bool = False, q: int = 1):
    """The nonlinear step's plan (rows, columns, levels per slice) on a
    ny2 x nx lattice at k levels: among ``tiles`` (by default the powers of
    two up to 64 a side, cut to the lattice; both arms run ragged
    tiles), the tile of largest area that fits one block's shared memory
    at NL_SLICE levels per slice and makes at least one block for each of
    the card's SMS SMs (else the largest that fits), then the smallest
    window, then the widest; then the largest slice that still fits
    (``nl_slice``). The kernel holds one block per SM by its registers, so
    the budget is one block's. On an H100 at 64x64x100 and 256x256x100 f32
    (PERF.md section 6, tools/tile_sweep.py --kernels nonlinear) that is FE
    (4, 16, 8) and (8, 16, 4), FB (8, 8, 4) at both. ``forced``,
    ``n_tracers`` and ``strat`` size the plan for the composed arms' shared
    memory (``nl_smem_bytes``), which may leave fewer levels per slice, or
    none at NL_SLICE: then the tile is sized at one level per slice. With
    q > 1 over the q-step kernel's shared memory and windows
    (csrc/nl_tiled.cuh; ``tiles`` then the tiles that divide the lattice),
    the tile is sized at the largest slice, from NL_SLICE down, at which a
    tile of at least NL_Q_SITES sites fits (else at one level): the halo
    recompute, which a larger tile cuts, grows with q. On an H100 at
    256x256x100 and 64x64x100 f32 at q = 2 (PERF.md section 6,
    tools/tile_sweep.py --kernels nonlinear --q 1 2) that is FE (4, 16, 4),
    the fastest of 60 plans at both, and FB (4, 8, 2), within 1.6% of the
    fastest of 28 and the fastest; sizing at one level per slice took FE
    (8, 32, 1), 1.98x the fastest. A composition that fits no tile raises
    ValueError, which names the shared memory."""
    kc = level_split(k)[1]
    hm, hi = NL_REACH[fb]
    arms = dict(forced=forced, n_tracers=n_tracers, strat=strat, q=q)
    if tiles is None:
        tiles = {(min(1 << a, ny2), min(1 << b, nx)) for a in range(7) for b in range(7)}
    top = min(NL_SLICE, kc)
    bases = ([(top, 0), (1, 0)] if q == 1 else
             [(b, NL_Q_SITES) for b in (4, 2, 1) if b <= top] + [(1, 0)])
    for base, least in bases:
        ok = [t for t in tiles if t[0] * t[1] >= least
              and nl_smem_bytes(t, k, itemsize, fb, base, **arms) <= SMEM_BYTES]
        if ok:
            break
    else:
        on = [a for a in ("forced", "n_tracers", "strat") if arms[a]] + [f"q={q}"] * (q > 1)
        raise ValueError(f"no tile of the nonlinear step fits {SMEM_BYTES} bytes of shared "
                         f"memory per block ({k} levels of {itemsize}-byte "
                         f"values{''.join(f', {a}' for a in on)})")
    ranks = level_split(k)[0]
    full = [t for t in ok if -(-ny2 // t[0]) * -(-nx // t[1]) * ranks >= SMS] or ok
    *_, ct, rt = max((t[0] * t[1], -(t[0] + 2 * hm * q) * (t[1] + 2 * hi * q), t[1], t[0])
                     for t in full)
    return rt, ct, nl_slice((rt, ct), k, itemsize, fb, **arms)


def nl_slice(tile, k: int, itemsize: int, fb: bool = False, forced: bool = False,
             n_tracers: int = 0, strat: bool = False, q: int = 1) -> int:
    """The largest slice (levels, a power of two up to 16 and the level
    chunk) at which the nonlinear step's ``tile`` fits one block, with the
    composed arms' shared memory (``nl_smem_bytes``, of the q-step kernel at
    q > 1); at least one level."""
    kc = level_split(k)[1]
    ks = 1
    while ks * 2 <= min(16, kc) and nl_smem_bytes(tile, k, itemsize, fb, ks * 2, forced,
                                                  n_tracers, strat, q) <= SMEM_BYTES:
        ks *= 2
    return ks


def vertex_tables(vertex_cell_terms, edge_vertex_terms):
    """The vertex stencils as the nonlinear arms take them (host copies,
    checked against csrc/nl_step.cuh's hex_vert:: by the entries): the kite
    taps' (kind, p_out, p_in, dm, di) int32 (12 x 5) and weights float64,
    the endpoint taps int32 (12 x 6)."""
    vc = np.ascontiguousarray([t[:5] for t in vertex_cell_terms], dtype=np.int32)
    vc_w = np.ascontiguousarray([t[5] for t in vertex_cell_terms], dtype=np.float64)
    ev = np.ascontiguousarray(edge_vertex_terms, dtype=np.int32)
    if vc.shape != (12, 5) or ev.shape != (12, 6):
        raise ValueError(f"the nonlinear arms take the hex lattice's 12 kite and 12 endpoint "
                         f"taps, got {vc.shape[0]} and {ev.shape[0]}")
    return vc, vc_w, ev


def host_stencil(table, weights) -> tuple[np.ndarray, np.ndarray, int]:
    """(int32 table, float64 weights, number of terms) of a stencil given on
    the host (``pack_stencil``'s arrays, or ``StructMesh.host_stencil`` and
    ``host_adjoint_stencil``): the kernels take it resolved on the host, as
    kernel parameters."""
    if not (isinstance(table, np.ndarray) and isinstance(weights, np.ndarray)):
        raise TypeError("the kernels take the stencil table and weights as numpy arrays "
                        "(StructMesh.host_stencil, StructMesh.host_adjoint_stencil)")
    table = np.ascontiguousarray(table, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    n_terms = weights.shape[0]
    if weights.ndim != 1 or n_terms > MAX_TERMS:
        raise ValueError(f"coriolis weights must be (n_terms <= {MAX_TERMS},), "
                         f"got {weights.shape}")
    if table.shape != (_HEADER + 3 * n_terms,) or table[0] != n_terms:
        raise ValueError(f"stencil table has shape {table.shape}, expected "
                         f"({_HEADER + 3 * n_terms},) for {n_terms} terms")
    return table, weights, n_terms


def check_error(name: str, err: int, what: str = "") -> None:
    """Raise for an entry's nonzero return: ValueError for a stencil that is
    not the hex lattice's, RuntimeError for a CUDA error."""
    if err == NOT_HEX_TABLE:
        raise ValueError(f"{name} takes the hex lattice's stencil tables only "
                         "(csrc/step_window.cuh, hex::; csrc/adjoint_window.cuh, "
                         "hex_adj::); this one does not map so")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}{what}")


def launch_plan(table: np.ndarray, ny2: int, nx: int, k: int, tile, n_tracers: int = 0,
                strat: bool = False) -> dict:
    """The launch fe_step makes for ``tile`` on an f32 ny2 x nx x k lattice
    with the stencil ``table`` (host copy), of its periodic arm with
    ``n_tracers`` tracers, ``strat`` or both or neither: its clusters (one
    per tile) and the blocks one SM holds (CUDA's occupancy calculator)."""
    fn = build.load().mot_fe_plan
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    table = np.ascontiguousarray(table, dtype=np.int32)
    check_error("fe_step's plan query", fn(table.ctypes.data, ny2, nx, k, *tile, n_tracers,
                                           int(strat), ctypes.addressof(out)))
    return {"clusters": out[0], "blocks_per_sm": out[1]}


def nl_launch_plan(ny2: int, nx: int, k: int, tile, ks: int, fb: bool = False) -> dict:
    """The launch of the nonlinear step for ``tile`` at ks levels per slice
    on an f32 ny2 x nx x k lattice: its clusters (one per tile), the blocks
    one SM holds (CUDA's occupancy calculator) and one block's shared
    memory in bytes. FB asks tiled_step.cu's instantiation."""
    lib = build.load()
    fn = lib.mot_tiled_nl_plan if fb else lib.mot_fe_nl_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(ny2, nx, k, *tile, ks, ctypes.addressof(out))
    check_error("the nonlinear step's plan query", err)
    return {"clusters": out[0], "blocks_per_sm": out[1], "smem_bytes": out[2]}


_P, _D, _I = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
_ARGTYPES = {
    "steps": [_P] * 21 + [_D] * 8 + [_I] * 10 + [_P],
    "stack": [_P] * 13 + [_D] * 8 + [_I] * 10 + [_P],
    "nl_steps": [_P, _P, _I] + [_P] * 22 + [_D] * 10 + [_I] * 12 + [_P],
    "nl_stack": [_P, _P, _I] + [_P] * 14 + [_D] * 10 + [_I] * 11 + [_P],
    "nl_tiled": [_P, _P, _I] + [_P] * 23 + [_D] * 10 + [_I] * 13 + [_P],
}


def _entry(kind: str, dtype: torch.dtype):
    lib = build.load()
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    fn = getattr(lib, f"mot_fe_{kind}_{suffix}")
    fn.argtypes = _ARGTYPES[kind]
    fn.restype = ctypes.c_int
    return fn


def check_tensor(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def state_shapes(ny2: int, nx: int, k: int):
    """Shapes of (ssh, h, u) on the lattice."""
    return (2, ny2, nx), (2, ny2, nx, k), (3, 2, ny2, nx, k)


def slab_rows(rows: int, halo_rows: int, reach: int, q: int, name: str) -> int:
    """The slab's own rows of buffers of ``rows`` rows that hold
    ``halo_rows`` received halo rows per side (structured/sharded.py; 0: a
    periodic lattice, all its rows its own), after checking that the halo
    is the windows' q reaches of ``reach`` rows and leaves rows."""
    if halo_rows == 0:
        return rows
    if halo_rows != reach * q or rows <= 2 * halo_rows:
        raise ValueError(f"{name} takes {reach * q} received halo rows per side (reach "
                         f"{reach}, q={q}) around a slab, got {halo_rows} in {rows} rows")
    return rows - 2 * halo_rows


def lattice_dims(h: torch.Tensor, name: str = "fe_step") -> tuple[int, int, int]:
    """(ny2, nx, K) from h (2, ny2, nx, K), after checking the device and
    dtype every kernel takes."""
    if h.device.type != "cuda":
        raise ValueError(f"{name} runs on a CUDA device, got {h.device}")
    if h.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {h.dtype}")
    if h.dim() != 4 or h.shape[0] != 2:
        raise ValueError(f"h must be (2, ny2, nx, K), got {tuple(h.shape)}")
    _, ny2, nx, k = h.shape
    if 6 * ny2 * nx * k > _MAX_INDEX:
        raise ValueError(f"u would hold {6 * ny2 * nx * k} values; the kernels' "
                         f"32-bit offsets take at most {_MAX_INDEX}")
    return ny2, nx, k


def live_bits(mask: torch.Tensor) -> torch.Tensor:
    """The wall mask (``StructMesh.edge_mask``, (3, 2, ny2, nx), 0 or 1) as
    the kernels' masked arms take it: one int32 per lattice site, (ny2, nx),
    bit c set where the mask of channel c = family * 2 + parity is not 0
    (csrc/step_window.cuh, load_live)."""
    m = (mask.reshape(6, *mask.shape[2:]) != 0).to(torch.int32)
    weights = torch.tensor([1 << c for c in range(6)], dtype=torch.int32, device=mask.device)
    return (m * weights.reshape(6, 1, 1)).sum(0, dtype=torch.int32).contiguous()


def check_live(live, ny2: int, nx: int, device) -> None:
    """Live bits (``live_bits``) as the kernels take them: int32 (ny2, nx),
    contiguous, on the state's device; None for a periodic lattice."""
    if live is not None:
        check_tensor("live", live, (ny2, nx), torch.int32, device)


def check_forcing(forcing, ny2: int, nx: int, dtype, device) -> None:
    """The forced arms' operands (``fused_model.KernelForcing``: wind
    (6, ny2, nx) in the state dtype, packed levels int32 (6, ny2, nx), three
    coefficients), contiguous, on the state's device; None unforced."""
    if forcing is not None:
        check_tensor("forcing wind", forcing.wind, (6, ny2, nx), dtype, device)
        check_tensor("forcing levels", forcing.levels, (6, ny2, nx), torch.int32, device)
        if len(forcing.coefs) != 3:
            raise ValueError("the forcing takes three coefficients (r_lin, Cd, lambda)")


def check_tracers(tracers, live, ny2: int, nx: int, k: int, dtype, device) -> None:
    """The tracer arms' operands (``fused_model.KernelTracers``: planes
    (2 nT, ny2, nx, K) with nT >= 1, the cell mask (2, ny2, nx) exactly where
    the live bits are given, both in the state dtype), contiguous, on the
    state's device; None without tracers."""
    if tracers is None:
        return
    n = tracers.planes.shape[0] if tracers.planes.dim() == 4 else 0
    if n < 2 or n % 2:
        raise ValueError(f"tracer planes must be (2 nT, ny2, nx, K) with nT >= 1, got "
                         f"{tuple(tracers.planes.shape)}")
    check_tensor("tracer planes", tracers.planes, (n, ny2, nx, k), dtype, device)
    if (tracers.cell_mask is None) != (live is None):
        raise ValueError("the tracer arms take the cell mask exactly on a channel (with the "
                         "live bits)")
    if tracers.cell_mask is not None:
        check_tensor("cell mask", tracers.cell_mask, (2, ny2, nx), dtype, device)


def tracer_args(tracers, out, tmp) -> tuple:
    """(tracer in, out and scratch planes, cell mask) pointers, (kappa,
    upwind) and the tracer count of an entry's tracer arm, or nulls and
    zeros for the tracer-free one."""
    if tracers is None:
        return (None,) * 4, (0.0, 0.0), 0
    mask = tracers.cell_mask
    return ((tracers.planes.data_ptr(), out.data_ptr(), tmp.data_ptr(),
             None if mask is None else mask.data_ptr()),
            (float(tracers.kappa), float(tracers.upwind)), tracers.planes.shape[0] // 2)


def check_tracer_stack(tracers, live, slots: int, ny2: int, nx: int, k: int, dtype,
                       device) -> None:
    """The operands of a tracer arm that runs through a stack of states
    (``fused_model.KernelTracers`` whose planes are the tracer stack
    (slots, 2 nT, ny2, nx, K)), as ``check_tracers`` holds them; None
    without tracers."""
    if tracers is None:
        return
    planes = tracers.planes
    if planes.dim() != 5 or planes.shape[0] != slots:
        raise ValueError(f"the tracer stack must be ({slots}, 2 nT, ny2, nx, K), got "
                         f"{tuple(planes.shape)}")
    check_tracers(tracers._replace(planes=planes[0]), live, ny2, nx, k, dtype, device)
    if not planes.is_contiguous():
        raise ValueError("the tracer stack is not contiguous")


def stack_tracer_args(tracers) -> tuple:
    """(tracer stack, cell mask) pointers, (kappa, upwind) and the tracer
    count of a stack entry's tracer arm, or nulls and zeros."""
    if tracers is None:
        return (None, None), (0.0, 0.0), 0
    mask = tracers.cell_mask
    return ((tracers.planes.data_ptr(), None if mask is None else mask.data_ptr()),
            (float(tracers.kappa), float(tracers.upwind)), tracers.planes.shape[1] // 2)


def check_strat(strat_w, k: int, dtype, device) -> None:
    """The stratified arms' operand (``fused_model.kernel_strat``: W (K, K)
    in the state dtype), contiguous, on the state's device; None
    unstratified. Every entry, forward and reverse, composes it with any
    forcing and tracers."""
    if strat_w is None:
        return
    check_tensor("strat_w", strat_w, (k, k), dtype, device)


def forcing_ranks(forcing, kc: int) -> tuple[int, int]:
    """(lvl_ranks, wind_ranks) of a launch whose blocks take chunks of kc
    levels (csrc/step_window.cuh, ForcingArgs): bit r set where rank r's
    chunk holds some edge's top or bottom level, and some edge's top level."""
    wind = 0
    for t in forcing.top_levels:
        wind |= 1 << (t // kc)
    lvl = wind
    for b in forcing.bottom_levels:
        lvl |= 1 << (b // kc)
    return lvl, wind


def forcing_args(forcing, kc: int) -> tuple:
    """(wind, levels) pointers, (r_lin, Cd, lambda) and the rank masks
    (``forcing_ranks``) of an entry's forced arm for chunks of kc levels, or
    nulls and zeros for the unforced one."""
    if forcing is None:
        return (None, None), (0.0, 0.0, 0.0, 0, 0)
    return ((forcing.wind.data_ptr(), forcing.levels.data_ptr()),
            (*(float(c) for c in forcing.coefs), *forcing_ranks(forcing, kc)))


def _consts(h, f_edge, rts, table, weights, live, forcing=None):
    ny2, nx, k = lattice_dims(h)
    dtype, device = h.dtype, h.device
    check_tensor("f_edge", f_edge, (3, 2, ny2, nx), dtype, device)
    check_tensor("rts", rts, (2, ny2, nx), dtype, device)
    check_live(live, ny2, nx, device)
    check_forcing(forcing, ny2, nx, dtype, device)
    return (ny2, nx, k), host_stencil(table, weights)


def _run(kind, h, tensors, f_edge, rts, live, stencil, scal, dims, n_steps, tile,
         forcing=None, tracers=None, tr_bufs=None, strat_w=None):
    table, weights, n_terms = stencil
    n_tr = 0 if tracers is None else tracers.planes.shape[-4] // 2
    strat = strat_w is not None
    if tile is None:
        tile = fe_tile(*dims, h.element_size(), n_tr, strat, forcing is not None)
    tile = tuple(tile)
    need = smem_bytes(tile, dims[2], h.element_size(), forcing is not None, n_tr, strat)
    if need > SMEM_BYTES:
        raise ValueError(f"an fe_step tile {tile} at {dims[2]} levels needs {need} bytes of "
                         f"shared memory per block, more than {SMEM_BYTES}")
    fn = _entry(kind, h.dtype)
    ptrs, coefs = forcing_args(forcing, level_split(dims[2])[1])
    state_ptrs = [x.data_ptr() for x in tensors]
    scal = tuple(float(x) for x in scal)
    if kind == "steps":  # W follows the tracer pointers
        tr_ptrs, tr_opts, n_tr = tracer_args(tracers, *(tr_bufs or (None, None)))
        state_ptrs += [*tr_ptrs, None if strat_w is None else strat_w.data_ptr()]
    else:  # the stack entry: the tracer stack in place, then W
        tr_ptrs, tr_opts, n_tr = stack_tracer_args(tracers)
        state_ptrs += [*tr_ptrs, None if strat_w is None else strat_w.data_ptr()]
    scal, extra = (*scal, *tr_opts), (n_tr,)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(f_edge.data_ptr(), rts.data_ptr(), None if live is None else live.data_ptr(),
                 *ptrs, table.ctypes.data, weights.ctypes.data, *state_ptrs,
                 *scal, *coefs, *dims, n_steps, n_terms, *tile, *extra, stream)
    check_error("fe_step", err, f" (tile {tile})")
    count_launches(n_steps, forcing, tracers, strat_w)


def count_launches(n: int, forcing, tracers, strat_w) -> None:
    """Count n launches of fe_step, of both cores: in ``launches``, and in
    the counters of the arms they ran."""
    global launches, forced_launches, tracer_launches, strat_launches
    launches += n
    forced_launches += n if forcing is not None else 0
    tracer_launches += n if tracers is not None else 0
    strat_launches += n if strat_w is not None else 0


def _rollout_into(src, out, f_edge, rts, table, weights, scal, n_steps, scratch, tile,
                  live, forcing=None, tracers=None, tr_out=None, tr_scratch=None,
                  strat_w=None):
    if n_steps < 1:
        raise ValueError("fe_rollout_into takes n_steps >= 1")
    h = src[1]
    dims, stencil = _consts(h, f_edge, rts, table, weights, live, forcing)
    check_tracers(tracers, live, *dims, h.dtype, h.device)
    check_strat(strat_w, dims[2], h.dtype, h.device)
    if scratch is None:
        scratch = out if n_steps == 1 else tuple(torch.empty_like(x) for x in out)
    for group, name in ((src, "src"), (out, "out"), (scratch, "scratch")):
        for x, shape, f in zip(group, state_shapes(*dims), ("ssh", "h", "u")):
            check_tensor(f"{name} {f}", x, shape, h.dtype, h.device)
    tr_bufs = None
    if tracers is not None:
        check_tensor("tracer out", tr_out, tracers.planes.shape, h.dtype, h.device)
        if tr_scratch is None:
            tr_scratch = tr_out if n_steps == 1 else torch.empty_like(tr_out)
        check_tensor("tracer scratch", tr_scratch, tracers.planes.shape, h.dtype, h.device)
        tr_bufs = (tr_out, tr_scratch)
    _run("steps", h, (*src, *out, *scratch), f_edge, rts, live, stencil, scal, dims,
         n_steps, tile, forcing, tracers, tr_bufs, strat_w)


def fe_rollout_into(src, out, f_edge, rts, stencil_table, coriolis_weight,
                    dt: float, inv_dc: float, s_div: float, n_steps: int, scratch=None,
                    live=None, forcing=None, tracers=None, tr_out=None, tr_scratch=None,
                    strat_w=None):
    """n_steps >= 1 forward-Euler steps of the linear core on the card, from
    ``src`` = (ssh, h, u) into ``out`` (same shapes, another buffer), through
    ``scratch`` (allocated here when None and n_steps > 1). ``src`` is left as
    it is.

    ssh (2, ny2, nx), h (2, ny2, nx, K), u (3, 2, ny2, nx, K), f_edge
    (3, 2, ny2, nx) and rts (2, ny2, nx) in float32 or float64, contiguous,
    on the card; the stencil on the host (``StructMesh.host_stencil``):
    stencil_table int32 from ``pack_stencil`` and coriolis_weight
    (n_terms,), rounded to the state dtype in the kernel; the scalars
    already rounded to the state dtype. ``live`` is the wall mask of a
    culled channel as ``live_bits`` packs it (int32 (ny2, nx), on the card),
    which runs the masked arm, or None. ``forcing`` is the momentum forcing
    as ``structured.fused_model.kernel_forcing`` gives it (wind, packed
    levels, (r_lin, Cd, lambda) rounded to the state dtype), which runs the
    forced arm, or None. ``tracers`` (``structured.fused_model.
    kernel_tracers``' operands, as for ``fe_rollout``: the source planes, the
    cell mask, kappa and upwind) runs the tracer arm into ``tr_out`` through
    ``tr_scratch`` (allocated here when None and n_steps > 1). ``strat_w``
    (W (K, K) in the state dtype, on the card:
    ``structured.fused_model.kernel_strat``) runs the stratified arm; the
    forced, tracer and stratified arms compose. Raises ValueError for a
    stencil that is not the hex lattice's."""
    _rollout_into(src, out, f_edge, rts, stencil_table, coriolis_weight,
                  (dt, inv_dc, s_div), n_steps, scratch, None, live, forcing, tracers, tr_out,
                  tr_scratch, strat_w)


def fe_fill_stack(stack, f_edge, rts, stencil_table, coriolis_weight,
                  dt: float, inv_dc: float, s_div: float, n_steps: int, live=None,
                  forcing=None, tracers=None, strat_w=None):
    """Fill a stack of states on the card: slot j + 1 = one step of slot j
    for j < n_steps. ``stack`` = (ssh (S, 2, ny2, nx), h (S, 2, ny2, nx, K),
    u (S, 3, 2, ny2, nx, K)) with S > n_steps; slot 0 holds the start.
    ``tracers`` (as for ``fe_rollout``, its planes the tracer stack
    (S, 2 nT, ny2, nx, K)) runs the tracer arm and ``strat_w`` the
    stratified arm, the same launches as ``fe_rollout_into``'s, so that the
    slots are that path's states bit for bit. The rest as for
    ``fe_rollout_into``."""
    ssh, h, u = stack
    if h.dim() != 5:
        raise ValueError(f"h stack must be (S, 2, ny2, nx, K), got {tuple(h.shape)}")
    dims, stencil = _consts(h[0], f_edge, rts, stencil_table, coriolis_weight, live, forcing)
    slots = h.shape[0]
    if not 0 <= n_steps < slots:
        raise ValueError(f"{n_steps} steps do not fit a stack of {slots} slots")
    for x, shape, f in zip(stack, state_shapes(*dims), ("ssh", "h", "u")):
        check_tensor(f"stack {f}", x, (slots, *shape), h.dtype, h.device)
    check_tracer_stack(tracers, live, slots, *dims, h.dtype, h.device)
    check_strat(strat_w, dims[2], h.dtype, h.device)
    _run("stack", h, stack, f_edge, rts, live, stencil, (dt, inv_dc, s_div), dims, n_steps,
         None, forcing, tracers, strat_w=strat_w)


def _rollout(ssh, h, u, f_edge, rts, table, weights, scal, n_steps, tile, live=None,
             forcing=None, tracers=None, strat_w=None):
    """``fe_rollout`` with scal = (dt, inv_dc, s_div), over tiles of
    ``tile`` (rows, columns) sites, or ``fe_tile``'s for None (the tile
    sweep and the tests give their own); ``forcing`` and ``strat_w`` as for
    ``fe_rollout_into``, ``tracers`` as for ``fe_rollout``."""
    lattice_dims(h)
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    src = tuple(x.contiguous() for x in (ssh, h, u))
    if n_steps == 0:
        out = tuple(x.clone() for x in src)
        return out if tracers is None else (*out, tracers.planes.clone())
    out = tuple(torch.empty_like(x) for x in src)
    tr_out = None if tracers is None else torch.empty_like(tracers.planes)
    _rollout_into(src, out, f_edge, rts, table, weights, scal, n_steps, None, tile, live,
                  forcing, tracers, tr_out, None, strat_w)
    return out if tracers is None else (*out, tr_out)


def fe_rollout(ssh, h, u, f_edge, rts, stencil_table, coriolis_weight,
               dt: float, inv_dc: float, s_div: float, n_steps: int, live=None,
               forcing=None, tracers=None, strat_w=None):
    """n_steps forward-Euler steps of the linear core on the card (arguments
    as for ``fe_rollout_into``). Returns new (ssh, h, u) tensors; the inputs
    are left as they are. ``tracers`` (``structured.fused_model.
    kernel_tracers``' operands: tracer planes (2 nT, ny2, nx, K), on a
    channel the cell mask, kappa and upwind rounded to the state dtype) runs
    the tracer arm, and the new tracer planes come fourth.
    ``strat_w`` (as for ``fe_rollout_into``) runs the stratified arm."""
    return _rollout(ssh, h, u, f_edge, rts, stencil_table, coriolis_weight,
                    (dt, inv_dc, s_div), n_steps, None, live, forcing, tracers, strat_w)



def _nl_checks(name, h, rts, table, weights, fv, vertex_cell_terms, edge_vertex_terms, tile,
               ks, live, fb, forcing=None, tracers=None, strat_w=None, q=1, ro=0):
    """The checks both nonlinear wrappers make (the state's device and
    dtype, the constants' device, dtype, shape and contiguity, the vertex
    constants' 4 planes (periodic) or 20 (with ``live``), the composed arms'
    operands, the plan's shared memory with theirs, and with ``ro`` received
    halo rows the slab's, ``slab_rows``); returns ((ny2, nx, k), the
    stencil, the vertex tables, n_fv), ny2 the lattice's or the slab's own
    rows."""
    rows, nx, k = lattice_dims(h, name)
    ny2 = slab_rows(rows, ro, NL_REACH[fb][0], q, name)
    dtype, device = h.dtype, h.device
    check_tensor("rts", rts, (2, rows, nx), dtype, device)
    check_live(live, rows, nx, device)
    n_fv = 4 if live is None else 20
    check_tensor("fv", fv, (n_fv, rows, nx), dtype, device)
    check_forcing(forcing, rows, nx, dtype, device)
    check_tracers(tracers, live, rows, nx, k, dtype, device)
    check_strat(strat_w, k, dtype, device)
    stencil = host_stencil(table, weights)
    tables = vertex_tables(vertex_cell_terms, edge_vertex_terms)
    kc = level_split(k)[1]
    if not (1 <= ks <= min(16, kc) and ks & (ks - 1) == 0):
        raise ValueError(f"the nonlinear step's slices are a power of two of levels up to "
                         f"{min(16, kc)} (its level chunk at {k} levels), got {ks}")
    need = nl_smem_bytes(tile, k, h.element_size(), fb, ks, **nl_arms(forcing, tracers, strat_w),
                         q=q)
    if need > SMEM_BYTES:
        raise ValueError(f"a nonlinear tile {tile} at {k} levels in slices of {ks}"
                         f"{f' and q={q}' if q > 1 else ''} needs {need} bytes of shared memory "
                         f"per block, more than {SMEM_BYTES}")
    return (ny2, nx, k), stencil, tables, n_fv


def nl_arms(forcing, tracers, strat_w) -> dict:
    """The composed arms of a nonlinear launch as the planners take them
    (``nl_plan``, ``nl_slice``, ``nl_smem_bytes``)."""
    return dict(forced=forcing is not None,
                n_tracers=0 if tracers is None else tracers.planes.shape[0] // 2,
                strat=strat_w is not None)


def nl_run(name, entry, ssh, h, u, rts, table, weights, fv, vertex_cell_terms,
           edge_vertex_terms, scal, n_steps, tile, ks, live, fb=False, out=None, tmp=None,
           forcing=None, tracers=None, strat_w=None, tr_out=None, tr_tmp=None, q=1, ro=0):
    """n_steps >= 0 nonlinear steps through ``entry``, the FE arm's entry
    (csrc/nl_step_fe_*.cu) or (``fb``) the FB arm's (nl_step_fb_*.cu), which
    take the same arguments, or with q > 1 the q-step kernel's entry of the
    arm (csrc/nl_tiled_*.cu: q steps per launch over tiles that divide the
    lattice, the tiles' state between the steps in a scratch allocated here,
    ``nl_scratch_size``); ``forcing``, ``tracers`` and ``strat_w`` (as
    for ``fe_rollout``) run the composed arms. Returns (ssh, h, u), new or
    written into ``out`` (through ``tmp``, allocated when None and more
    than one launch), with the tracer planes fourth with ``tracers``, new or
    written into ``tr_out`` (through ``tr_tmp``, alike), and raises as
    ``check_error`` for a failed launch, after ``_nl_checks``. ``ro`` > 0
    takes every lattice operand as a slab with ``ro`` received halo rows per
    side (one step's reach, or q reaches at q > 1; ``slab_rows``): the
    windows read them unwrapped, and the launches write the slab's own rows
    of the outputs and leave their halo rows as they are (csrc/
    step_window.cuh, buffer_plane). Its tiles divide the slab."""
    dims, (table, weights, n_terms), (vc, vc_w, ev), n_fv = _nl_checks(
        name, h, rts, table, weights, fv, vertex_cell_terms, edge_vertex_terms, tile, ks, live,
        fb, forcing, tracers, strat_w, q, ro)
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    if q < 1 or n_steps % q:
        raise ValueError(f"q={q} must be >= 1 and divide n_steps={n_steps}")
    if (q > 1 and dims[1] % tile[1]) or ((q > 1 or ro) and dims[0] % tile[0]):
        raise ValueError(f"the {'q-step kernel' if q > 1 else 'received-halo arm'}'s tile "
                         f"{tuple(tile)} must divide the {dims[0]}x{dims[1]} "
                         f"{'slab' if ro else 'lattice'}")
    device = h.device
    src = tuple(x.contiguous() for x in (ssh, h, u))
    for x, shape, f in zip(src, state_shapes(dims[0] + 2 * ro, *dims[1:]), ("ssh", "h", "u")):
        check_tensor(f, x, shape, h.dtype, device)
    if n_steps == 0:
        out = tuple(x.clone() for x in src)
        return out if tracers is None else (*out, tracers.planes.clone())
    if out is None:
        out = tuple(torch.empty_like(x) for x in src)
    if tmp is None:
        tmp = out if n_steps == q else tuple(torch.empty_like(x) for x in src)
    for group, what in ((out, "out"), (tmp, "scratch")):
        for x, y, f in zip(group, src, ("ssh", "h", "u")):
            check_tensor(f"{what} {f}", x, y.shape, h.dtype, device)
    if tracers is not None:
        if tr_out is None:
            tr_out = torch.empty_like(tracers.planes)
        if tr_tmp is None:
            tr_tmp = tr_out if n_steps == q else torch.empty_like(tr_out)
        for x, what in ((tr_out, "tracer out"), (tr_tmp, "tracer scratch")):
            check_tensor(what, x, tracers.planes.shape, h.dtype, device)
    tr_ptrs, tr_opts, n_tr = tracer_args(tracers, tr_out, tr_tmp)
    ptrs, coefs = forcing_args(forcing, level_split(dims[2])[1])
    # the q-step kernel's scratch, held until the launches are queued
    scr = (torch.empty(nl_scratch_size(*dims, tile, q, fb, n_tr), dtype=h.dtype, device=device)
           if q > 1 else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(rts.data_ptr(), fv.data_ptr(), n_fv,
                    None if live is None else live.data_ptr(), *ptrs, table.ctypes.data,
                    weights.ctypes.data, vc.ctypes.data, vc_w.ctypes.data, ev.ctypes.data,
                    *[x.data_ptr() for x in (*src, *out, *tmp)], *tr_ptrs,
                    None if strat_w is None else strat_w.data_ptr(),
                    *(() if scr is None else (scr.data_ptr(),)),
                    *(float(x) for x in scal), *tr_opts, *coefs, *dims, n_steps, n_terms, ro,
                    *tile, ks, n_tr, *((q,) if q > 1 else ()), stream)
    check_error(name, err, f" (tile {tile}, slice {ks})")
    return out if tracers is None else (*out, tr_out)


def nl_scratch_size(ny2: int, nx: int, k: int, tile, q: int, fb: bool, n_tracers: int) -> int:
    """Values of the q-step kernel's scratch (csrc/nl_tiled.cuh): per tile
    of ``tile`` (dividing the lattice), the 8 state and 2 n_tracers tracer
    planes of its tile grown by q - 1 reaches per side at k levels."""
    hm, hi = NL_REACH[fb]
    grown = (tile[0] + 2 * hm * (q - 1)) * (tile[1] + 2 * hi * (q - 1))
    return (ny2 // tile[0]) * (nx // tile[1]) * (8 + 2 * n_tracers) * grown * k


def _fe_nl_plan(h, tile, ks, arms=None):
    ny2, nx, k = lattice_dims(h)
    arms = arms or {}
    tile = nl_plan(ny2, nx, k, h.element_size(), **arms)[:2] if tile is None else tuple(tile)
    return tile, nl_slice(tile, k, h.element_size(), **arms) if ks is None else ks


def fe_nl_rollout(ssh, h, u, rts, stencil_table, coriolis_weight, fv, vertex_cell_terms,
                  edge_vertex_terms, dt: float, inv_dc: float, s_div: float, s_ke: float,
                  s_curl: float, n_steps: int, live=None, tile=None, ks=None, out=None,
                  scratch=None, forcing=None, tracers=None, strat_w=None, tr_out=None,
                  tr_scratch=None, halo_rows: int = 0):
    """n_steps forward-Euler steps of the nonlinear core on the card, one
    launch of fe_step's nonlinear arm each (csrc/nl_step.cuh). ssh, h, u and
    rts as for ``fe_rollout``; ``fv`` the vertex constants
    (``fused_model.nl_setup``: (4, ny2, nx), or (20, ny2, nx) with ``live``);
    the vertex stencils as ``StructMesh`` holds them; the scalars rounded to
    the state dtype (``fused_model._scal``, ``fused_model.nl_scal``);
    ``forcing``, ``tracers`` and ``strat_w`` (as for ``fe_rollout``) run the
    forced, tracer and stratified arms, in any combination. The tile (rows,
    columns) defaults to ``nl_plan``'s and the slice ks to the largest that
    fits the tile (``nl_slice``), each sized with the composed arms' shared
    memory. Returns (ssh, h, u), with the new tracer planes fourth with
    ``tracers``: new, or written into ``out`` through ``scratch`` and the
    tracer planes into ``tr_out`` through ``tr_scratch`` (as
    ``fe_rollout_into``); raises ValueError for a stencil that is not the hex
    lattice's. ``halo_rows`` = 2 takes the operands as slabs with received
    halos (``nl_run``'s ro; the tile and ks given)."""
    if halo_rows and (tile is None or ks is None):
        raise ValueError("the received-halo arm takes its tile and slice from the caller")
    tile, ks = _fe_nl_plan(h, tile, ks, nl_arms(forcing, tracers, strat_w))
    out = nl_run("fe_step (nonlinear)", _entry("nl_steps", h.dtype), ssh, h, u, rts,
                 stencil_table, coriolis_weight, fv, vertex_cell_terms, edge_vertex_terms,
                 (dt, inv_dc, s_div, s_ke, s_curl), n_steps, tile, ks, live, out=out,
                 tmp=scratch, forcing=forcing, tracers=tracers, strat_w=strat_w, tr_out=tr_out,
                 tr_tmp=tr_scratch, ro=halo_rows)
    count_launches(n_steps, forcing, tracers, strat_w)
    return out


def fe_nl_fill_stack(stack, rts, stencil_table, coriolis_weight, fv, vertex_cell_terms,
                     edge_vertex_terms, dt: float, inv_dc: float, s_div: float, s_ke: float,
                     s_curl: float, n_steps: int, live=None, tile=None, ks=None, forcing=None,
                     tracers=None, strat_w=None):
    """Fill a stack of states on the card with nonlinear steps: slot j + 1
    = one step of slot j for j < n_steps, the launches ``fe_nl_rollout``
    makes with the same plan and arms, so the slots are its states bit for
    bit. ``stack`` as for ``fe_fill_stack``; ``forcing``, ``tracers`` (its
    planes the tracer stack (S, 2 nT, ny2, nx, K)) and ``strat_w`` run the
    composed arms, in any combination; the rest as for ``fe_nl_rollout``."""
    ssh, h, u = stack
    if h.dim() != 5:
        raise ValueError(f"h stack must be (S, 2, ny2, nx, K), got {tuple(h.shape)}")
    slots = h.shape[0]
    check_tracer_stack(tracers, live, slots, *lattice_dims(h[0]), h.dtype, h.device)
    slot_tracers = None if tracers is None else tracers._replace(planes=tracers.planes[0])
    tile, ks = _fe_nl_plan(h[0], tile, ks, nl_arms(forcing, slot_tracers, strat_w))
    dims, (table, weights, n_terms), (vc, vc_w, ev), n_fv = _nl_checks(
        "fe_step (nonlinear)", h[0], rts, stencil_table, coriolis_weight, fv, vertex_cell_terms,
        edge_vertex_terms, tile, ks, live, False, forcing, slot_tracers, strat_w)
    if not 0 <= n_steps < slots:
        raise ValueError(f"{n_steps} steps do not fit a stack of {slots} slots")
    for x, shape, f in zip(stack, state_shapes(*dims), ("ssh", "h", "u")):
        check_tensor(f"stack {f}", x, (slots, *shape), h.dtype, h.device)
    ptrs, coefs = forcing_args(forcing, level_split(dims[2])[1])
    (tr, cmask), tr_opts, n_tr = stack_tracer_args(tracers)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _entry("nl_stack", h.dtype)(
            rts.data_ptr(), fv.data_ptr(), n_fv, None if live is None else live.data_ptr(),
            *ptrs, table.ctypes.data, weights.ctypes.data, vc.ctypes.data, vc_w.ctypes.data,
            ev.ctypes.data, *[x.data_ptr() for x in stack], tr, cmask,
            None if strat_w is None else strat_w.data_ptr(), float(dt), float(inv_dc),
            float(s_div), float(s_ke), float(s_curl), *tr_opts, *coefs, *dims, n_steps, n_terms,
            *tile, ks, n_tr, stream)
    check_error("fe_step (nonlinear)", err, f" (tile {tile}, slice {ks})")
    count_launches(n_steps, forcing, tracers, strat_w)
