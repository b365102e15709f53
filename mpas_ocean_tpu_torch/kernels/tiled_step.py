"""Wrapper of the hand-written tiled q-step kernel (csrc/tiled_step.cu),
which replaces the TPU kernel ``_tiled_step_kernel``
(mpas_ocean_tpu/structured/pallas_model.py:852) for the linear periodic
core, forward Euler and forward-backward.

``tiled_rollout`` takes tensors on a CUDA device and launches one kernel per
q steps on the current stream; it raises on anything else, including a plan
whose window does not fit the card's shared memory. Its plain PyTorch
version is ``structured.tiled_model.plain_tiled_rollout``, which
``structured.tiled_model.tiled_run_loop`` runs for tensors on the CPU.
``launches`` counts kernel launches (one per q steps).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .fe_step import MAX_TERMS, check_stencil, check_tensor, lattice_dims, state_shapes

__all__ = ["SMEM_BYTES", "active_clusters", "launches", "level_split", "smem_bytes",
           "tiled_rollout"]

# Largest dynamic shared memory of one block on an H100 (sm_90), in bytes:
# the planner's budget; the kernel's entry checks it against the device.
SMEM_BYTES = 232448
# Most blocks in a thread-block cluster, which split a tile's levels
# (kMaxCluster in csrc/tiled_step.cu, the portable maximum).
MAX_CLUSTER = 8
_SMALL_INTS = 64  # kSmallInts in csrc/tiled_step.cu

# kernel launches made by tiled_rollout (one per q steps)
launches = 0


def level_split(k: int) -> tuple[int, int]:
    """(blocks per cluster, levels per block): the fewest levels per block
    over at most MAX_CLUSTER blocks, and no block without levels."""
    kc = -(-k // MAX_CLUSTER)
    return -(-k // kc), kc


def smem_bytes(sites: int, kc: int, itemsize: int) -> int:
    """Dynamic shared memory of one block for a window of ``sites`` lattice
    sites and ``kc`` levels (``smem_bytes`` in csrc/tiled_step.cu)."""
    return itemsize * sites * (16 * kc + 16) + 16 * MAX_TERMS + 4 * (sites + _SMALL_INTS)


_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_double] * 3 + [ctypes.c_int] * 12
             + [ctypes.c_void_p])


def _entry(dtype: torch.dtype):
    lib = build.load()
    fn = {torch.float32: lib.mot_tiled_steps_f32,
          torch.float64: lib.mot_tiled_steps_f64}[dtype]
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def active_clusters(row_tile: int, col_tile: int, q: int, halo, k: int) -> int:
    """How many clusters of an f32 FE plan the card holds at once (CUDA's
    occupancy calculator): with the grid's clusters, the number of waves."""
    hm, hi = halo
    ranks, kc = level_split(k)
    sites = (row_tile + 2 * hm * q) * (col_tile + 2 * hi * q)
    fn = build.load().mot_tiled_active_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(sites, kc, ranks, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {err}")
    return out.value


def tiled_rollout(ssh, h, u, f_edge, rts, stencil_table, coriolis_weight,
                  dt: float, inv_dc: float, s_div: float, n_steps: int, *,
                  row_tile: int, col_tile: int, q: int, halo, fb: bool = False):
    """n_steps FE (or FB) steps of the linear core on the card, q per launch
    over row_tile x col_tile tiles whose windows carry q ``halo`` = (rows,
    columns) per side. Shapes and dtypes as for ``fe_step.fe_rollout``.
    Returns new (ssh, h, u) tensors; the inputs are left as they are."""
    global launches
    ny2, nx, k = lattice_dims(h, "tiled_step")
    dtype, device = h.dtype, h.device
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    if q < 1 or n_steps % q:
        raise ValueError(f"q={q} must be >= 1 and divide n_steps={n_steps}")
    if row_tile < 1 or col_tile < 1 or ny2 % row_tile or nx % col_tile:
        raise ValueError(f"tile {row_tile}x{col_tile} must divide the {ny2}x{nx} lattice")
    hm, hi = halo
    cluster, kc = level_split(k)
    sites = (row_tile + 2 * hm * q) * (col_tile + 2 * hi * q)
    need = smem_bytes(sites, kc, h.element_size())
    if need > SMEM_BYTES:
        raise ValueError(f"a {row_tile}x{col_tile} tile at q={q} needs {need} bytes of "
                         f"shared memory per block, more than {SMEM_BYTES}")
    check_tensor("f_edge", f_edge, (3, 2, ny2, nx), dtype, device)
    check_tensor("rts", rts, (2, ny2, nx), dtype, device)
    n_terms = check_stencil(stencil_table, coriolis_weight, dtype, device)
    src = tuple(x.contiguous() for x in (ssh, h, u))
    for x, shape, f in zip(src, state_shapes(ny2, nx, k), ("ssh", "h", "u")):
        check_tensor(f, x, shape, dtype, device)
    if n_steps == 0:
        return tuple(x.clone() for x in src)
    out = tuple(torch.empty_like(x) for x in src)
    tmp = out if n_steps == q else tuple(torch.empty_like(x) for x in src)
    fn = _entry(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *[x.data_ptr() for x in (f_edge, rts, stencil_table, coriolis_weight,
                                      *src, *out, *tmp)],
            float(dt), float(inv_dc), float(s_div), ny2, nx, k, n_steps, n_terms,
            row_tile, col_tile, q, hm, hi, kc, int(fb), stream,
        )
    if err != 0:
        raise RuntimeError(f"tiled_step kernel launch failed with CUDA error {err}")
    launches += n_steps // q
    return out
