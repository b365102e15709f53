"""Wrapper of the hand-written tiled q-step kernel (csrc/tiled_step.cu),
which replaces the TPU kernel ``_tiled_step_kernel``
(mpas_ocean_tpu/structured/pallas_model.py:852) for the linear core, forward
Euler and forward-backward, and, in its nonlinear arms (``tiled_nl_rollout``:
FB at q = 1 in csrc/nl_step.cuh, whose FE arm at q = 1 is fe_step's,
``fe_step.fe_nl_rollout``; FE and FB at q > 1 in the q-step kernel,
csrc/nl_tiled.cuh), for the vector-invariant one, on a periodic
lattice and, with the wall mask's ``live`` bits (``fe_step.live_bits``), on
a coastal channel culled from one; ``tiled_rollout`` takes momentum forcing
(``forcing=``), which runs the kernel's forced arm, tracers
(``tracers=``), which run its tracer arm, and a stratification's W
(``strat_w=``), which runs its stratified arm, in any combination, and so
does ``tiled_nl_rollout``.

``tiled_rollout`` takes tensors on a CUDA device and the stencil on the
host (``StructMesh.host_stencil``), and launches one kernel per q steps on
the current stream; it raises on anything else, including a plan whose
window does not fit the card's shared memory and a stencil that is not the
hex lattice's. Its plain PyTorch
version is ``structured.tiled_model.plain_tiled_rollout``, which
``structured.tiled_model.tiled_run_loop`` runs for tensors on the CPU.
``launches`` counts kernel launches (one per q steps), of both cores,
``forced_launches`` those of the forced arm, ``tracer_launches`` those of
the tracer arm, ``strat_launches`` those of the stratified arm and
``window_launches`` those of the nonlinear q-step kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .fe_step import (
    _ARGTYPES as _FE_ARGTYPES,
    LIVE_BYTES,
    MAX_CLUSTER,
    SMEM_BYTES,
    TWO_BLOCK_BYTES,
    check_error,
    check_forcing,
    check_live,
    check_strat,
    check_tracers,
    forcing_args,
    forcing_smem_bytes,
    check_tensor,
    host_stencil,
    lattice_dims,
    level_split,
    nl_arms,
    nl_plan,
    nl_run,
    nl_slice,
    nl_smem_bytes,
    slab_rows,
    state_shapes,
    strat_smem_bytes,
    tracer_args,
)

__all__ = ["MAX_CLUSTER", "SMEM_BYTES", "TWO_BLOCK_BYTES", "forced_launches", "launches",
           "level_split",
           "nl_plan", "nl_slice", "nl_smem_bytes", "occupancy", "smem_bytes",
           "strat_launches", "tiled_nl_rollout", "tiled_rollout", "tracer_launches",
           "window_launches"]

_PLANES = 16  # kPlanes in csrc/tiled_step.cu

# kernel launches made by tiled_rollout and tiled_nl_rollout (one per q
# steps), and those of them that ran the forced arm, the tracer arm and the
# stratified arm; ``window_launches`` those of the nonlinear q-step kernel
# (csrc/nl_tiled.cuh, q > 1)
launches = 0
forced_launches = 0
tracer_launches = 0
strat_launches = 0
window_launches = 0


def smem_bytes(sites: int, kc: int, q: int, itemsize: int, forced: bool = False,
               n_tracers: int = 0, strat_levels: int = 0, fb: bool = False) -> int:
    """Dynamic shared memory of one block for a window of ``sites`` lattice
    sites, ``kc`` levels and q steps (``smem_bytes`` in csrc/tiled_step.cu):
    one state copy [8 + 2 n_tracers][sites][kc] at q = 1, two at q > 1; ssh,
    partial sums, f_edge and rts; the sites' indices and live bits (the
    masked arm's, reserved either way, as in ``fe_step.smem_bytes``); with
    ``forced``, the forced arm's (``fe_step.forcing_smem_bytes``); with
    ``strat_levels`` = K > 0, the stratified arm's at K levels, with FB's
    fresh h' for ``fb`` (``fe_step.strat_smem_bytes``)."""
    return (itemsize * sites * ((8 + 2 * n_tracers) * (2 if q > 1 else 1) * kc + _PLANES)
            + (4 + LIVE_BYTES) * sites
            + (forcing_smem_bytes(sites, 0, itemsize) if forced else 0)
            + (strat_smem_bytes(sites, kc, strat_levels, itemsize, fb) if strat_levels else 0))


_ARGTYPES = ([ctypes.c_void_p] * 21 + [ctypes.c_double] * 8 + [ctypes.c_int] * 15
             + [ctypes.c_void_p])


def _entry(dtype: torch.dtype):
    lib = build.load()
    fn = {torch.float32: lib.mot_tiled_steps_f32,
          torch.float64: lib.mot_tiled_steps_f64}[dtype]
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def occupancy(row_tile: int, col_tile: int, q: int, halo, k: int, fb: bool = False,
              strat: bool = False):
    """(clusters the card holds at once, blocks per SM) of an f32 plan of
    the unstratified arm or (``strat``) the stratified one (CUDA's occupancy
    calculator): with the grid's clusters, one per tile, the number of
    waves."""
    hm, hi = halo
    sites = (row_tile + 2 * hm * q) * (col_tile + 2 * hi * q)
    fn = build.load().mot_tiled_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    err = fn(sites, k, q, int(fb), int(strat), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"the occupancy query failed with CUDA error {err}")
    return out[0], out[1]


def tiled_rollout(ssh, h, u, f_edge, rts, stencil_table, coriolis_weight,
                  dt: float, inv_dc: float, s_div: float, n_steps: int, *,
                  row_tile: int, col_tile: int, q: int, halo, fb: bool = False, live=None,
                  forcing=None, tracers=None, strat_w=None, halo_rows: int = 0, out=None,
                  tr_out=None):
    """n_steps FE (or FB) steps of the linear core on the card, q per launch
    over row_tile x col_tile tiles whose windows carry q ``halo`` = (rows,
    columns) per side. Arguments as for ``fe_step.fe_rollout``; ``live``
    (the wall mask's live bits, or None) runs the masked arm, ``forcing``
    (``fused_model.kernel_forcing``'s operands, or None) the forced arm,
    ``tracers`` (``fused_model.kernel_tracers``' operands, or None) the
    tracer arm, ``strat_w`` (``fused_model.kernel_strat``'s W, or None) the
    stratified arm, in any combination. Returns new (ssh, h, u) tensors,
    and new tracer planes fourth with tracers, or writes them into ``out``
    (and ``tr_out``) where given; the inputs are left as they are.

    ``halo_rows`` > 0, the received-halo arm (the sharded superstep,
    structured/sharded.py): every lattice operand is a slab buffer of its
    own rows with ``halo_rows`` = halo[0] * q received halo rows per side
    (``fe_step.slab_rows``), which the windows read unwrapped; the launches
    write the slab's own rows of the outputs and leave their halo rows as
    they are (csrc/step_window.cuh, buffer_plane)."""
    rows, nx, k = lattice_dims(h, "tiled_step")
    dtype, device = h.dtype, h.device
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    if q < 1 or n_steps % q:
        raise ValueError(f"q={q} must be >= 1 and divide n_steps={n_steps}")
    hm, hi = halo
    ny2 = slab_rows(rows, halo_rows, hm, q, "tiled_step")
    if row_tile < 1 or col_tile < 1 or ny2 % row_tile or nx % col_tile:
        raise ValueError(f"tile {row_tile}x{col_tile} must divide the {ny2}x{nx} "
                         f"{'slab' if halo_rows else 'lattice'}")
    _, kc = level_split(k)
    sites = (row_tile + 2 * hm * q) * (col_tile + 2 * hi * q)
    n_tr = 0 if tracers is None else tracers.planes.shape[0] // 2
    need = smem_bytes(sites, kc, q, h.element_size(), forcing is not None, n_tr,
                      0 if strat_w is None else k, fb)
    if need > SMEM_BYTES:
        raise ValueError(f"a {row_tile}x{col_tile} tile at q={q} needs {need} bytes of "
                         f"shared memory per block, more than {SMEM_BYTES}")
    check_tensor("f_edge", f_edge, (3, 2, rows, nx), dtype, device)
    check_tensor("rts", rts, (2, rows, nx), dtype, device)
    check_live(live, rows, nx, device)
    check_forcing(forcing, rows, nx, dtype, device)
    check_tracers(tracers, live, rows, nx, k, dtype, device)
    check_strat(strat_w, k, dtype, device)
    table, weights, n_terms = host_stencil(stencil_table, coriolis_weight)
    src = tuple(x.contiguous() for x in (ssh, h, u))
    for x, shape, f in zip(src, state_shapes(rows, nx, k), ("ssh", "h", "u")):
        check_tensor(f, x, shape, dtype, device)
    if n_steps == 0:
        out = tuple(x.clone() for x in src)
        return out if tracers is None else (*out, tracers.planes.clone())
    if out is None:
        out = tuple(torch.empty_like(x) for x in src)
    for x, y, f in zip(out, src, ("ssh", "h", "u")):
        check_tensor(f"out {f}", x, y.shape, dtype, device)
    tmp = out if n_steps == q else tuple(torch.empty_like(x) for x in src)
    tr_tmp = None
    if tracers is not None:
        if tr_out is None:
            tr_out = torch.empty_like(tracers.planes)
        check_tensor("tracer out", tr_out, tracers.planes.shape, dtype, device)
        tr_tmp = tr_out if n_steps == q else torch.empty_like(tr_out)
    tr_ptrs, tr_opts, n_tr = tracer_args(tracers, tr_out, tr_tmp)
    fn = _entry(dtype)
    ptrs, coefs = forcing_args(forcing, kc)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            f_edge.data_ptr(), rts.data_ptr(), None if live is None else live.data_ptr(),
            *ptrs, table.ctypes.data, weights.ctypes.data,
            *[x.data_ptr() for x in (*src, *out, *tmp)], *tr_ptrs,
            None if strat_w is None else strat_w.data_ptr(), float(dt), float(inv_dc),
            float(s_div), *tr_opts, *coefs, ny2, nx, k, n_steps, n_terms, halo_rows, row_tile,
            col_tile, q, hm, hi, int(fb), n_tr, stream,
        )
    check_error("tiled_step", err)
    count_launches(n_steps // q, forcing, tracers, strat_w)
    return out if tracers is None else (*out, tr_out)


def count_launches(n: int, forcing, tracers, strat_w) -> None:
    """Count n launches of tiled_step, of both cores: in ``launches``, and
    in the counters of the arms they ran."""
    global launches, forced_launches, tracer_launches, strat_launches
    launches += n
    forced_launches += n if forcing is not None else 0
    tracer_launches += n if tracers is not None else 0
    strat_launches += n if strat_w is not None else 0


def tiled_nl_rollout(ssh, h, u, rts, stencil_table, coriolis_weight, fv, vertex_cell_terms,
                     edge_vertex_terms, dt: float, inv_dc: float, s_div: float, s_ke: float,
                     s_curl: float, n_steps: int, live=None, tile=None, ks=None, forcing=None,
                     tracers=None, strat_w=None, q: int = 1, fb: bool = True,
                     halo_rows: int = 0, out=None, tr_out=None):
    """n_steps steps of the nonlinear core on the card: at q = 1
    forward-backward, one launch of the tiled kernel's nonlinear FB arm
    (reach 3) each (its FE arm at q = 1 is ``fe_step.fe_nl_rollout``'s);
    at q > 1 FB or (``fb=False``) FE, one launch of the q-step kernel
    (csrc/nl_tiled.cuh) per q steps over tiles that divide the lattice.
    Arguments as for ``fe_step.fe_nl_rollout`` (``forcing``, ``tracers`` and
    ``strat_w`` too); the tile (rows, columns) defaults to ``nl_plan``'s
    plan at q (over the tiles that divide the lattice at q > 1) and the
    slice ks to the largest that fits it, with the composed arms' shared
    memory; a plan that does not fit raises ValueError. Returns new
    (ssh, h, u), and new tracer planes fourth with tracers, or writes them
    into ``out`` (and ``tr_out``) where given. ``halo_rows`` > 0 runs the
    received-halo arm (``fe_step.nl_run``'s ro: q reaches of rows per side;
    the tile given, dividing the slab)."""
    if halo_rows and tile is None:
        raise ValueError("the received-halo arm takes its tile from the caller")
    ny2, nx, k = lattice_dims(h, "tiled_step")
    if q < 1 or (q == 1 and not fb):
        raise ValueError(f"tiled_nl_rollout runs FB at q = 1 and FE or FB at q > 1, not "
                         f"{'FB' if fb else 'FE'} at q = {q}")
    size = h.element_size()
    arms = dict(nl_arms(forcing, tracers, strat_w), q=q)
    if tile is None:
        tiles = None if q == 1 else [(r, c) for r in range(1, ny2 + 1) if ny2 % r == 0
                                     for c in range(1, nx + 1) if nx % c == 0]
        tile = nl_plan(ny2, nx, k, size, fb, tiles, **arms)[:2]
    tile = tuple(tile)
    ks = nl_slice(tile, k, size, fb, **arms) if ks is None else ks
    lib = build.load()
    suffix = {torch.float32: "f32", torch.float64: "f64"}[h.dtype]
    if q == 1:
        fn, kind = getattr(lib, f"mot_tiled_nl_steps_{suffix}"), "nl_steps"
    else:
        fn, kind = getattr(lib, f"mot_nl_tiled_{'fb' if fb else 'fe'}_{suffix}"), "nl_tiled"
    fn.argtypes = _FE_ARGTYPES[kind]
    fn.restype = ctypes.c_int
    name = f"tiled_step (nonlinear {'FB' if fb else 'FE'}{f', q={q}' if q > 1 else ''})"
    out = nl_run(name, fn, ssh, h, u, rts, stencil_table, coriolis_weight, fv,
                 vertex_cell_terms, edge_vertex_terms, (dt, inv_dc, s_div, s_ke, s_curl),
                 n_steps, tile, ks, live, fb=fb, out=out, forcing=forcing, tracers=tracers,
                 strat_w=strat_w, tr_out=tr_out, q=q, ro=halo_rows)
    count_launches(n_steps // q, forcing, tracers, strat_w)
    if q > 1:
        global window_launches
        window_launches += n_steps // q
    return out
