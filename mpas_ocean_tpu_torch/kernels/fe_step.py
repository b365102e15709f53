"""Wrapper of the hand-written forward-Euler step kernel (csrc/fe_step.cu),
which replaces the TPU kernel ``_rollout_kernel``
(mpas_ocean_tpu/structured/pallas_model.py:320) for the linear periodic core.

``fe_rollout`` takes tensors on a CUDA device and launches one kernel per
step on the current stream, ping-ponging between two state buffers that it
allocates; it raises on anything else. Its plain PyTorch version is
``structured.model.structured_run_loop``, which ``structured.fused_model``
runs for tensors on the CPU. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..structured.stencils import INCOMING, NEIGHBOR
from . import build

__all__ = ["MAX_TERMS", "fe_rollout", "launches", "pack_stencil"]

MAX_TERMS = 128  # kMaxTerms in csrc/fe_step.cu
_HEADER = 44  # kHeader in csrc/fe_step.cu
_MAX_INDEX = 2**31 - 1  # kMaxIndex in csrc/fe_step.cu

# kernel launches made by fe_rollout (one per step)
launches = 0


def pack_stencil(terms) -> tuple[np.ndarray, np.ndarray]:
    """The stencil table the kernel reads (layout in csrc/fe_step.cu) and the
    Coriolis weights in the table's term order, as float64.

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


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_double] * 3 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p
]


def _entry(dtype: torch.dtype):
    lib = build.load()
    fn = {torch.float32: lib.mot_fe_rollout_f32,
          torch.float64: lib.mot_fe_rollout_f64}[dtype]
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def fe_rollout(ssh, h, u, f_edge, rts, stencil_table, coriolis_weight,
               dt: float, inv_dc: float, s_div: float, n_steps: int):
    """n_steps forward-Euler steps of the linear core on the card.

    ssh (2, ny2, nx), h (2, ny2, nx, K), u (3, 2, ny2, nx, K), f_edge
    (3, 2, ny2, nx), rts (2, ny2, nx) and coriolis_weight (n_terms,) in
    float32 or float64; stencil_table int32 from ``pack_stencil``; the
    scalars already rounded to the state dtype. Returns new (ssh, h, u)
    tensors; the inputs are left as they are."""
    global launches
    device, dtype = h.device, h.dtype
    if device.type != "cuda":
        raise ValueError(f"fe_rollout runs on a CUDA device, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fe_rollout takes float32 or float64, got {dtype}")
    if h.dim() != 4 or h.shape[0] != 2:
        raise ValueError(f"h must be (2, ny2, nx, K), got {tuple(h.shape)}")
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    _, ny2, nx, k = h.shape
    n_terms = coriolis_weight.shape[0]
    _check("ssh", ssh, (2, ny2, nx), dtype, device)
    _check("u", u, (3, 2, ny2, nx, k), dtype, device)
    _check("f_edge", f_edge, (3, 2, ny2, nx), dtype, device)
    _check("rts", rts, (2, ny2, nx), dtype, device)
    _check("coriolis_weight", coriolis_weight, (n_terms,), dtype, device)
    _check("stencil_table", stencil_table, (_HEADER + 3 * n_terms,), torch.int32,
           device)
    if n_terms > MAX_TERMS:
        raise ValueError(f"{n_terms} Coriolis terms > {MAX_TERMS}")
    if u.numel() > _MAX_INDEX:
        raise ValueError(f"u holds {u.numel()} values; the kernel's 32-bit "
                         f"offsets take at most {_MAX_INDEX}")

    consts = [x.contiguous() for x in (f_edge, rts, stencil_table, coriolis_weight)]
    bufs = [[torch.empty_like(x, memory_format=torch.contiguous_format)
             for x in (ssh, h, u)] for _ in range(2)]
    for dst, src in zip(bufs[0], (ssh, h, u)):
        dst.copy_(src)
    fn = _entry(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *[x.data_ptr() for x in consts],
            *[x.data_ptr() for x in bufs[0]],
            *[x.data_ptr() for x in bufs[1]],
            float(dt), float(inv_dc), float(s_div),
            ny2, nx, k, n_steps, n_terms, stream,
        )
    if err != 0:
        raise RuntimeError(f"fe_step kernel launch failed with CUDA error {err}")
    launches += n_steps
    return tuple(bufs[n_steps % 2])
