"""Wrapper of the hand-written adjoint-step kernel (csrc/adjoint_step.cu),
which replaces the TPU kernel ``_adjoint_segment_kernel``
(mpas_ocean_tpu/structured/pallas_model.py:1480) for the linear periodic
forward-Euler core.

``adjoint_rollout`` takes tensors on a CUDA device and launches one adjoint
kernel per reverse step on the current stream, then one small kernel that
adds the call's d(dt) to an accumulator; it raises on anything else. Its
plain PyTorch version is ``structured.adjoint.structured_adjoint_step``.
``launches`` counts adjoint-step launches (one per reverse step).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .fe_step import check_stencil, check_tensor, lattice_dims, state_shapes

__all__ = ["adjoint_rollout", "launches"]

# adjoint-step kernel launches made by adjoint_rollout (one per step)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_double] * 3 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p
]


def _entry(dtype: torch.dtype):
    lib = build.load()
    fn = {torch.float32: lib.mot_adjoint_rollout_f32,
          torch.float64: lib.mot_adjoint_rollout_f64}[dtype]
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def adjoint_rollout(stack, g_in, f_edge, stencil_table, coriolis_weight,
                    dt: float, inv_dc: float, s_div: float, n_steps: int,
                    ddt: torch.Tensor, out=None, scratch=None):
    """n_steps >= 1 reverse forward-Euler steps of the linear core on the
    card.

    ``stack`` = (ssh (S, 2, ny2, nx), h (S, 2, ny2, nx, K),
    u (S, 3, 2, ny2, nx, K)) holds the primal state of step j in slot j,
    S >= n_steps. ``g_in`` = (ssh, h, u) is the cotangent at step n_steps
    and is left as it is. ``stencil_table`` / ``coriolis_weight`` are the
    TRANSPOSED Coriolis stencil packed by ``fe_step.pack_stencil``. d(dt) is
    added to ``ddt``, a float64 (1,) tensor on the card. Returns the
    cotangent at step 0, written into ``out`` (allocated when None), through
    ``scratch`` (allocated when None and n_steps > 1). The scalars are
    rounded to the state dtype as for the forward kernel."""
    global launches
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
    n_terms = check_stencil(stencil_table, coriolis_weight, dtype, device)
    check_tensor("ddt", ddt, (1,), torch.float64, device)
    if out is None:
        out = tuple(torch.empty(s, dtype=dtype, device=device) for s in shapes)
    if scratch is None:
        scratch = out if n_steps == 1 else tuple(torch.empty_like(x) for x in out)
    for x, shape, f in zip(stack, shapes, ("ssh", "h", "u")):
        check_tensor(f"stack {f}", x, (slots, *shape), dtype, device)
    for group, name in ((g_in, "g_in"), (out, "out"), (scratch, "scratch")):
        for x, shape, f in zip(group, shapes, ("ssh", "h", "u")):
            check_tensor(f"{name} {f}", x, shape, dtype, device)
    part = torch.empty(n_steps * 2 * ny2 * nx, dtype=dtype, device=device)
    fn = _entry(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *[x.data_ptr() for x in (f_edge, stencil_table, coriolis_weight, *stack,
                                      *g_in, *out, *scratch, part, ddt)],
            float(dt), float(inv_dc), float(s_div), ny2, nx, k, n_steps, n_terms,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"adjoint_step kernel launch failed with CUDA error {err}")
    launches += n_steps
    return out
