"""Wrapper of the hand-written tiled adjoint kernel (csrc/tiled_adjoint.cu),
which replaces the TPU kernel ``_tiled_adjoint_kernel``
(mpas_ocean_tpu/structured/pallas_model.py:1979) for the linear periodic
forward-Euler core.

``tiled_adjoint_rollout`` takes tensors on a CUDA device and launches one
kernel per reverse superstep of q steps on the current stream, then one small
kernel that adds the call's d(dt) to an accumulator; it raises on anything
else, including a plan whose window does not fit the card's shared memory.
Its plain PyTorch version is
``structured.tiled_diff.plain_tiled_adjoint_superstep``, which
``structured.tiled_diff`` runs for tensors on the CPU. ``launches`` counts
kernel launches (one per superstep).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .fe_step import (
    MAX_CLUSTER,
    MAX_TERMS,
    SMEM_BYTES,
    check_stencil,
    check_tensor,
    lattice_dims,
    state_shapes,
)

__all__ = ["launches", "level_split", "smem_bytes", "tiled_adjoint_rollout", "window_sites"]

_SMALL_INTS = 64  # kSmallInts in csrc/tiled_window.cuh
_TAP_BYTES = 16  # sizeof(Tap<T>) in csrc/tiled_window.cuh

# kernel launches made by tiled_adjoint_rollout (one per superstep)
launches = 0


def level_split(k: int) -> tuple[int, int]:
    """(blocks per cluster, levels per block) of the tiled adjoint kernel:
    the fewest levels per block over at most MAX_CLUSTER blocks, and no
    block without levels."""
    kc = -(-k // MAX_CLUSTER)
    return -(-k // kc), kc


def window_sites(row_tile: int, col_tile: int, q: int, halo) -> int:
    """Sites of a tile's window: the core grown by 2q - 1 ``halo`` = (rows,
    columns) per side, the primal window a q-step reverse reads."""
    hm, hi = halo
    span = 2 * q - 1
    return (row_tile + 2 * hm * span) * (col_tile + 2 * hi * span)


def smem_bytes(sites: int, kc: int, q: int, itemsize: int) -> int:
    """Dynamic shared memory of one block for a window of ``sites`` lattice
    sites, ``kc`` levels and q steps (``smem_bytes`` in
    csrc/tiled_adjoint.cu): q primal states and min(q, 2) cotangents of 8
    planes per level, 2q + 16 planes without levels, two tap tables, the
    sites and the small tables."""
    states = 8 * (q + min(q, 2))
    return (2 * _TAP_BYTES * MAX_TERMS + itemsize * sites * (states * kc + 2 * q + 16)
            + 4 * (sites + _SMALL_INTS))


_ARGTYPES = ([ctypes.c_void_p] * 20 + [ctypes.c_double] * 3 + [ctypes.c_int] * 11
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
                          scratch=None, *, row_tile: int, col_tile: int, q: int, halo):
    """n_supersteps >= 1 reverse supersteps of q forward-Euler steps of the
    linear core on the card, over row_tile x col_tile tiles.

    ``stack`` = (ssh (S, 2, ny2, nx), h (S, 2, ny2, nx, K),
    u (S, 3, 2, ny2, nx, K)) holds the primal state at the start of
    superstep s in slot s, S >= n_supersteps. ``g_in`` = (ssh, h, u) is the
    cotangent at the end of the last superstep and is left as it is.
    ``stencil_table`` / ``coriolis_weight`` pack the Coriolis stencil and
    ``adjoint_table`` / ``adjoint_weight`` its transpose
    (``fe_step.pack_stencil``); ``halo`` = (rows, columns) one step reads per
    side. d(dt) is added to ``ddt``, a float64 (1,) tensor on the card.
    Returns the cotangent at the start of superstep 0, written into ``out``
    (allocated when None), through ``scratch`` (allocated when None and
    n_supersteps > 1). The scalars are rounded to the state dtype as for
    the forward kernel."""
    global launches
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
    cluster, kc = level_split(k)
    need = smem_bytes(window_sites(row_tile, col_tile, q, halo), kc, q, h_st.element_size())
    if need > SMEM_BYTES:
        raise ValueError(f"a {row_tile}x{col_tile} tile at q={q} needs {need} bytes of "
                         f"shared memory per block, more than {SMEM_BYTES}")
    shapes = state_shapes(ny2, nx, k)
    check_tensor("f_edge", f_edge, (3, 2, ny2, nx), dtype, device)
    check_tensor("rts", rts, (2, ny2, nx), dtype, device)
    n_terms = check_stencil(stencil_table, coriolis_weight, dtype, device)
    if check_stencil(adjoint_table, adjoint_weight, dtype, device) != n_terms:
        raise ValueError("the adjoint table must be the transpose of the stencil table")
    check_tensor("ddt", ddt, (1,), torch.float64, device)
    if out is None:
        out = tuple(torch.empty(s, dtype=dtype, device=device) for s in shapes)
    if scratch is None:
        scratch = out if n_supersteps == 1 else tuple(torch.empty_like(x) for x in out)
    for x, shape, f in zip(stack, shapes, ("ssh", "h", "u")):
        check_tensor(f"stack {f}", x, (slots, *shape), dtype, device)
    for group, name in ((g_in, "g_in"), (out, "out"), (scratch, "scratch")):
        for x, shape, f in zip(group, shapes, ("ssh", "h", "u")):
            check_tensor(f"{name} {f}", x, shape, dtype, device)
    n_tiles = (ny2 // row_tile) * (nx // col_tile)
    part = torch.empty(n_supersteps * n_tiles * cluster, dtype=dtype, device=device)
    fn = _entry(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *[x.data_ptr() for x in (f_edge, rts, stencil_table, coriolis_weight,
                                      adjoint_table, adjoint_weight, *stack, *g_in, *out,
                                      *scratch, part, ddt)],
            float(dt), float(inv_dc), float(s_div), ny2, nx, k, n_supersteps, n_terms,
            row_tile, col_tile, q, hm, hi, kc, stream,
        )
    if err != 0:
        raise RuntimeError(f"tiled_adjoint kernel launch failed with CUDA error {err}")
    launches += n_supersteps
    return out
