"""Wrapper of the hand-written forward-Euler step kernel (csrc/fe_step.cu),
which replaces the TPU kernel ``_rollout_kernel``
(mpas_ocean_tpu/structured/pallas_model.py:320) for the linear periodic core.

The entries take tensors on a CUDA device and launch one kernel per step on
the current stream; they raise on anything else:

* ``fe_rollout`` returns new state tensors;
* ``fe_rollout_into`` writes the result into tensors the caller gives;
* ``fe_fill_stack`` fills a stack of states, slot j + 1 = step(slot j).

Their plain PyTorch version is ``structured.model.structured_run_loop``,
which ``structured.fused_model`` runs for tensors on the CPU. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..structured.stencils import INCOMING, NEIGHBOR
from . import build

__all__ = [
    "MAX_TERMS",
    "fe_fill_stack",
    "fe_rollout",
    "fe_rollout_into",
    "launches",
    "pack_stencil",
]

MAX_TERMS = 128  # kMaxTerms in csrc/lattice.cuh
_HEADER = 44  # kHeader in csrc/lattice.cuh
_MAX_INDEX = 2**31 - 1  # kMaxIndex in csrc/lattice.cuh

# kernel launches made by this module's entries (one per step)
launches = 0


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


_P, _D, _I = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
_ARGTYPES = {
    "steps": [_P] * 13 + [_D] * 3 + [_I] * 5 + [_P],
    "stack": [_P] * 7 + [_D] * 3 + [_I] * 5 + [_P],
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


def check_stencil(table, weights, dtype, device) -> int:
    """Checks a packed stencil and returns its number of terms."""
    n_terms = weights.shape[0]
    if n_terms > MAX_TERMS:
        raise ValueError(f"{n_terms} Coriolis terms > {MAX_TERMS}")
    check_tensor("coriolis_weight", weights, (n_terms,), dtype, device)
    check_tensor("stencil_table", table, (_HEADER + 3 * n_terms,), torch.int32, device)
    return n_terms


def _consts(h, f_edge, rts, table, weights):
    ny2, nx, k = lattice_dims(h)
    dtype, device = h.dtype, h.device
    check_tensor("f_edge", f_edge, (3, 2, ny2, nx), dtype, device)
    check_tensor("rts", rts, (2, ny2, nx), dtype, device)
    n_terms = check_stencil(table, weights, dtype, device)
    return (ny2, nx, k), n_terms


def _run(kind, h, tensors, consts, dt, inv_dc, s_div, dims, n_steps, n_terms):
    global launches
    fn = _entry(kind, h.dtype)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(*[x.data_ptr() for x in consts], *[x.data_ptr() for x in tensors],
                 float(dt), float(inv_dc), float(s_div), *dims, n_steps, n_terms, stream)
    if err != 0:
        raise RuntimeError(f"fe_step kernel launch failed with CUDA error {err}")
    launches += n_steps


def fe_rollout_into(src, out, f_edge, rts, stencil_table, coriolis_weight,
                    dt: float, inv_dc: float, s_div: float, n_steps: int,
                    scratch=None):
    """n_steps >= 1 forward-Euler steps of the linear core on the card, from
    ``src`` = (ssh, h, u) into ``out`` (same shapes, another buffer), through
    ``scratch`` (allocated here when None and n_steps > 1). ``src`` is left as
    it is.

    ssh (2, ny2, nx), h (2, ny2, nx, K), u (3, 2, ny2, nx, K), f_edge
    (3, 2, ny2, nx), rts (2, ny2, nx) and coriolis_weight (n_terms,) in
    float32 or float64, contiguous; stencil_table int32 from
    ``pack_stencil``; the scalars already rounded to the state dtype."""
    if n_steps < 1:
        raise ValueError("fe_rollout_into takes n_steps >= 1")
    h = src[1]
    dims, n_terms = _consts(h, f_edge, rts, stencil_table, coriolis_weight)
    if scratch is None:
        scratch = out if n_steps == 1 else tuple(torch.empty_like(x) for x in out)
    for group, name in ((src, "src"), (out, "out"), (scratch, "scratch")):
        for x, shape, f in zip(group, state_shapes(*dims), ("ssh", "h", "u")):
            check_tensor(f"{name} {f}", x, shape, h.dtype, h.device)
    _run("steps", h, (*src, *out, *scratch),
         (f_edge, rts, stencil_table, coriolis_weight),
         dt, inv_dc, s_div, dims, n_steps, n_terms)


def fe_fill_stack(stack, f_edge, rts, stencil_table, coriolis_weight,
                  dt: float, inv_dc: float, s_div: float, n_steps: int):
    """Fill a stack of states on the card: slot j + 1 = one step of slot j
    for j < n_steps. ``stack`` = (ssh (S, 2, ny2, nx), h (S, 2, ny2, nx, K),
    u (S, 3, 2, ny2, nx, K)) with S > n_steps; slot 0 holds the start."""
    ssh, h, u = stack
    if h.dim() != 5:
        raise ValueError(f"h stack must be (S, 2, ny2, nx, K), got {tuple(h.shape)}")
    dims, n_terms = _consts(h[0], f_edge, rts, stencil_table, coriolis_weight)
    slots = h.shape[0]
    if not 0 <= n_steps < slots:
        raise ValueError(f"{n_steps} steps do not fit a stack of {slots} slots")
    for x, shape, f in zip(stack, state_shapes(*dims), ("ssh", "h", "u")):
        check_tensor(f"stack {f}", x, (slots, *shape), h.dtype, h.device)
    _run("stack", h, stack, (f_edge, rts, stencil_table, coriolis_weight),
         dt, inv_dc, s_div, dims, n_steps, n_terms)


def fe_rollout(ssh, h, u, f_edge, rts, stencil_table, coriolis_weight,
               dt: float, inv_dc: float, s_div: float, n_steps: int):
    """n_steps forward-Euler steps of the linear core on the card (shapes as
    in ``fe_rollout_into``). Returns new (ssh, h, u) tensors; the inputs
    are left as they are."""
    lattice_dims(h)
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    src = tuple(x.contiguous() for x in (ssh, h, u))
    if n_steps == 0:
        return tuple(x.clone() for x in src)
    out = tuple(torch.empty_like(x) for x in src)
    fe_rollout_into(src, out, f_edge, rts, stencil_table, coriolis_weight,
                    dt, inv_dc, s_div, n_steps)
    return out
