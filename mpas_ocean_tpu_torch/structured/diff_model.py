"""Differentiable rollout of the structured core, linear or nonlinear: the
forward-Euler step kernel (kernels/fe_step.py) forward, and a reverse sweep
through a hand-written reverse-step kernel (kernels/adjoint_step.py: the
linear adjoint_step, or for ``nonlinear`` the nonlinear reverse,
csrc/nl_adjoint.cuh).

Counterpart of mpas_ocean_tpu/structured/pallas_model.py:1460-1960 (the fused
adjoint segments: ``_adjoint_plan``, ``_pallas_forward_ckpts``,
``_adjoint_segment``, ``_pallas_adjoint_from_ckpts``,
``pallas_adjoint_rollout``) and :2587-3034 (``pallas_rollout_diff``,
``pallas_step``), for the linear and the nonlinear core with forward Euler,
on periodic lattices and on coastal channels (a mesh with a wall mask runs
the masked arms of the kernels, and the plain masked steps on the CPU).

Plan. The forward runs in groups of ``group`` steps and keeps each group's
start state (the outer checkpoints). The reverse takes the groups last to
first: it rebuilds the group's states in a stack with the forward kernel,
from its checkpoint, then runs the adjoint kernel back through the stack.
So ceil(n / group) + group states live in device memory, and the forward
runs about twice. The TPU kernel rebuilt b-step segments inside VMEM under a
fitted VMEM model; on the card the limit is device memory, so there is one
level of groups and no recompute inside a kernel.

Tracers (a state's ``tracers``, with ``tracer_kappa=`` and
``tracer_upwind=`` as on the forward entry points) are a fourth field,
differentiated (the JAX ``custom_vjp`` keeps kappa and upwind
nondifferentiable, :2619). Inside the sweep they are held as the kernels'
planes (``fused_model.tracer_planes``: (2 nT, ny2, nx, K), a stack
(S, 2 nT, ny2, nx, K)), on the CPU as on the card; the entry points take and
return the lattice layout (2, ny2, nx, nT, K). On the card the kernels'
tracer arms run them, with either core and with forcing and
stratification. The reverse kernels
read the step's h' and T' from the next slot of the stack, and for a
group's last step from the state after it: the next checkpoint, or the
rollout's final state, which the forward keeps for that.

Layered stratification (``strat=``, ``make_stratification``): its W
(``phi_weights``) is a differentiated input; the densities get none, since
they build W on the host only (the JAX package returns zeros for them). On
the card the stratified arms of the kernels run: fe_step's to rebuild each
group's states, and the reverse kernels', which accumulate d(W) in double
beside d(dt) (``dstrat``).

Momentum forcing (``forcing=``, struct layout) is a differentiated input:
its wind and its three coefficients get cotangents (the level masks none,
as in the JAX package's ``_forcing_cotangent``, :1939-1955). On the card the
forced arms of the kernels run; the reverse kernels accumulate d(wind) per
edge and d(r_lin, Cd, lambda) in double beside d(dt).

The three compose with each other and with either core, on the card (the
kernels' composed arms: the linear reverse's and the nonlinear reverse's
take every combination) as on the CPU.

State on a CUDA device runs the kernels, and a failed build or launch
raises. State on the CPU runs the same plan with the plain step
(``model.structured_step``) and the plain adjoint step
(``adjoint.structured_adjoint_step``, or ``structured_nl_adjoint_step`` for
the nonlinear core). Nothing falls back from one to the other. A mesh
without the vertex constants, asked for the nonlinear core, raises
(``model.check_nl_mesh``).
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from ..kernels import adjoint_step, fe_step
from ..models.forcing import Forcing
from ..models.stratification import Stratification
from .adjoint import ForcingCot, structured_adjoint_step, structured_nl_adjoint_step
from .fused_model import (
    KernelTracers,
    _scal,
    fused_run_loop,
    kernel_forcing,
    kernel_live,
    kernel_strat,
    nl_adjoint_scal,
    nl_scal,
    nl_setup,
    tracer_opts,
    tracer_planes,
    tracer_unplanes,
)
from .model import (
    StructMesh,
    StructState,
    check_nl_mesh,
    structured_run_loop,
    structured_step,
)

__all__ = [
    "MEMORY_SHARE",
    "FusedRolloutDiff",
    "FusedStep",
    "adjoint_from_ckpts",
    "adjoint_plan",
    "adjoint_segment",
    "auto_rollout_diff",
    "forward_ckpts",
    "fused_adjoint_rollout",
    "fused_rollout_diff",
    "fused_step",
]

# share of the card's free memory that the checkpoints may take by default
MEMORY_SHARE = 0.5

_FIELDS = ("ssh", "layer_thickness", "normal_velocity")


def _fields(state: StructState) -> tuple:
    """(ssh, h, u), and the tracers fourth where the state has them."""
    out = tuple(getattr(state, f) for f in _FIELDS)
    return out if state.tracers is None else (*out, state.tracers)


def _planes_state(state: StructState) -> StructState:
    """The state with its tracers as the kernels' planes (2 nT, ny2, nx, K)."""
    if state.tracers is None:
        return state
    return StructState(state.ssh, state.layer_thickness, state.normal_velocity,
                       tracer_planes(state.tracers))


def _lattice_state(state: StructState) -> StructState:
    """The inverse of ``_planes_state``: tracers (2, ny2, nx, nT, K)."""
    if state.tracers is None:
        return state
    return StructState(state.ssh, state.layer_thickness, state.normal_velocity,
                       tracer_unplanes(state.tracers))


def _state_bytes(state: StructState) -> int:
    return sum(x.numel() * x.element_size() for x in _fields(state))


def _default_budget(device: torch.device) -> float:
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return MEMORY_SHARE * free
    return math.inf


def adjoint_plan(n_steps: int, state_bytes: int, budget: float) -> int:
    """Steps per group for an n-step reverse sweep: the group that keeps
    the fewest states resident, ceil(n / group) checkpoints plus group
    rebuilt states, which is group = ceil(sqrt(n)). The last group takes the
    remainder, so every n >= 1 has a plan. Raises ValueError when those
    states take more than ``budget`` bytes."""
    if n_steps < 1:
        raise ValueError("a reverse sweep needs n_steps >= 1")
    group = math.isqrt(n_steps - 1) + 1
    need = (-(-n_steps // group) + group) * state_bytes
    if need > budget:
        raise ValueError(
            f"the reverse sweep of {n_steps} steps keeps {need / 2**20:.1f} MiB "
            f"of states, over the budget of {budget / 2**20:.1f} MiB"
        )
    return group


class _Steps:
    """The forward and reverse steps one device runs: the kernels for a
    CUDA state, the plain versions for a CPU state; both forward and
    reverse take the mesh's wall mask where it has one, the ``forcing``
    (the kernels' forced arms on the card), and with ``nonlinear`` the
    vector-invariant core (forward: fe_step's nonlinear arm at
    ``fe_step.nl_plan``'s plan, the forward path's own; reverse: the
    nonlinear reverse kernel over ``nl_tile`` tiles, by default
    ``adjoint_step.nl_adjoint_plan``'s). States are StructStates of
    preallocated tensors, their tracers (with ``tracers``) as planes;
    stacks carry a leading slot axis. With forcing, the reverse adds d(wind)
    and d(r_lin, Cd, lambda) to ``dforc``. ``tracers`` (the states carry
    tracers) runs the tracer arms with ``tracer_kappa`` and
    ``tracer_upwind``. ``strat`` runs the stratified arms (on the card, W
    cast once to the state dtype: ``fused_model.kernel_strat``), and the
    reverse adds d(W) to ``dstrat``, (K, K) in double."""

    def __init__(self, mesh: StructMesh, dt, like: torch.Tensor, nonlinear: bool = False,
                 nl_tile=None, forcing: Forcing | None = None, tracers: bool = False,
                 tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                 strat: Stratification | None = None):
        self.mesh, self.dt, self.nonlinear, self.forcing = mesh, dt, nonlinear, forcing
        self.tracers, self.kappa, self.upwind = tracers, tracer_kappa, tracer_upwind
        self.strat = strat
        self.cuda = like.device.type == "cuda"
        if not self.cuda and like.device.type != "cpu":
            raise ValueError(f"no rollout for state on {like.device}")
        if nonlinear:
            check_nl_mesh(mesh)
        self.dforc = None
        if forcing is not None:
            # d(wind) in the state dtype, per edge channel; the coefficients' in double
            self.dforc = ForcingCot(
                torch.zeros((6, mesh.ny2, mesh.nx), dtype=like.dtype, device=like.device),
                torch.zeros(3, dtype=torch.float64, device=like.device))
        self.dstrat = self.sw = None
        if strat is not None:
            self.dstrat = torch.zeros(tuple(strat.phi_weights.shape), dtype=torch.float64,
                                      device=like.device)
        if self.cuda:
            self.sw = kernel_strat(strat, like.dtype, like.device)
            dtype = like.dtype
            self.scal = _scal(mesh, dt, dtype)
            f_edge = mesh.f_edge.to(dtype).contiguous()
            rts = mesh.resting_thickness_sum.to(dtype).contiguous()
            self.fwd = (f_edge, rts, *mesh.host_stencil)
            self.adj = (f_edge, *mesh.host_adjoint_stencil)
            self.live = kernel_live(mesh)
            self.kf = kernel_forcing(forcing, mesh, dtype, like.device)
            cmask = None if mesh.cell_mask is None else mesh.cell_mask.to(dtype).contiguous()
            self.topts = (cmask, *tracer_opts(tracer_kappa, tracer_upwind, dtype))
            if nonlinear:
                nl = (nl_setup(mesh, dtype), mesh.vertex_cell_terms, mesh.edge_vertex_terms)
                self.nl_fwd = (rts, *mesh.host_stencil, *nl)
                self.nl_adj = (nl[0], *mesh.host_stencil, *mesh.host_adjoint_stencil, *nl[1:])
                self.nl_scal = (*self.scal, *nl_scal(mesh, dtype))
                self.nl_adj_scal = (*self.nl_scal, *nl_adjoint_scal(mesh, dt, dtype))
                self.nl_tile = nl_tile

    def forcing_cot(self) -> ForcingCot | None:
        """The accumulated forcing cotangent: d(wind) (3, 2, ny2, nx) and
        d(r_lin, Cd, lambda) (3,), or None unforced."""
        if self.dforc is None:
            return None
        m = self.mesh
        return ForcingCot(self.dforc.wind.reshape(3, 2, m.ny2, m.nx), self.dforc.coefs)

    def add_forcing_cot(self, d: ForcingCot) -> None:
        """Add a plain reverse's ForcingCot (d(wind) (3, 2, ny2, nx)) to ``dforc``."""
        self.dforc.wind.add_(d.wind.reshape(self.dforc.wind.shape))
        self.dforc.coefs.add_(d.coefs.to(self.dforc.coefs.dtype))

    def cots(self, result: tuple) -> tuple:
        """A reverse's (d_state, d_dt), then the accumulated ForcingCot
        (d(wind) (3, 2, ny2, nx)) where forced, then d(W) where
        stratified."""
        d = self.forcing_cot()
        return ((*result, *(() if d is None else (d,)))
                + (() if self.dstrat is None else (self.dstrat,)))

    def kernel_tracers(self, planes: torch.Tensor | None) -> KernelTracers | None:
        """The tracer arms' operands for ``planes`` (a state's or a
        stack's), or None without tracers."""
        return None if planes is None else KernelTracers(planes, *self.topts)

    def plain_step(self, state: StructState) -> StructState:
        """One plain step of a state whose tracers are planes, the tracers
        of the result planes too."""
        return _planes_state(structured_step(_lattice_state(state), self.mesh, self.dt,
                                             self.nonlinear, self.forcing, self.kappa,
                                             self.upwind, self.strat))

    def advance(self, src: StructState, out: StructState, n: int, scratch: StructState):
        """n >= 1 steps from src into out."""
        if self.cuda and self.nonlinear:
            fe_step.fe_nl_rollout(*_fields(src)[:3], *self.nl_fwd, *self.nl_scal, n,
                                  live=self.live, out=_fields(out)[:3],
                                  scratch=_fields(scratch)[:3], forcing=self.kf,
                                  tracers=self.kernel_tracers(src.tracers), strat_w=self.sw,
                                  tr_out=out.tracers, tr_scratch=scratch.tracers)
        elif self.cuda:
            fe_step.fe_rollout_into(_fields(src)[:3], _fields(out)[:3], *self.fwd, *self.scal,
                                    n, _fields(scratch)[:3], live=self.live, forcing=self.kf,
                                    tracers=self.kernel_tracers(src.tracers),
                                    tr_out=out.tracers, tr_scratch=scratch.tracers,
                                    strat_w=self.sw)
        else:
            res = _planes_state(structured_run_loop(
                _lattice_state(src), self.mesh, self.dt, n, nonlinear=self.nonlinear,
                forcing=self.forcing, tracer_kappa=self.kappa, tracer_upwind=self.upwind,
                strat=self.strat))
            for dst, x in zip(_fields(out), _fields(res)):
                dst.copy_(x)

    def fill(self, stack: StructState, n: int):
        """Slot j + 1 = one step of slot j, for j < n."""
        if self.cuda and self.nonlinear:
            fe_step.fe_nl_fill_stack(_fields(stack)[:3], *self.nl_fwd, *self.nl_scal, n,
                                     live=self.live, forcing=self.kf,
                                     tracers=self.kernel_tracers(stack.tracers), strat_w=self.sw)
        elif self.cuda:
            fe_step.fe_fill_stack(_fields(stack)[:3], *self.fwd, *self.scal, n, live=self.live,
                                  forcing=self.kf, tracers=self.kernel_tracers(stack.tracers),
                                  strat_w=self.sw)
        else:
            for j in range(n):
                nxt = self.plain_step(_slot(stack, j))
                for dst, x in zip(_fields(_slot(stack, j + 1)), _fields(nxt)):
                    dst.copy_(x)

    def plain_reverse(self, state: StructState, g: StructState):
        """One plain reverse step through ``state`` for the cotangent ``g``,
        both with tracers as planes: (d_state with its tracers as planes,
        d(dt)[, ForcingCot][, d(W)])."""
        step = structured_nl_adjoint_step if self.nonlinear else structured_adjoint_step
        res = step(_lattice_state(state), _lattice_state(g), self.mesh, self.dt, self.forcing,
                   tracer_kappa=self.kappa, tracer_upwind=self.upwind, strat=self.strat)
        return (_planes_state(res[0]), *res[1:])

    def add_plain_cots(self, res: tuple) -> None:
        """Add a plain reverse's ForcingCot and d(W) to the accumulators."""
        if self.forcing is not None:
            self.add_forcing_cot(res[2])
        if self.strat is not None:
            self.dstrat.add_(res[-1].to(self.dstrat.dtype))

    def reverse(self, stack: StructState, g: StructState, n: int, ddt: torch.Tensor,
                out: StructState, scratch: StructState, end: StructState | None = None):
        """n >= 1 reverse steps through the stack's slots n - 1 .. 0, from
        the cotangent g at step n into out; d(dt) is added to ddt, with
        forcing d(wind) and d(r_lin, Cd, lambda) to ``dforc``, with
        stratification d(W) to ``dstrat``. With tracers on the card, ``end``
        is the state after slot n - 1 (its h and tracers are read)."""
        if self.cuda and self.nonlinear:
            adjoint_step.nl_adjoint_rollout(_fields(stack)[:3], _fields(g), *self.nl_adj,
                                            *self.nl_adj_scal, n, ddt, _fields(out),
                                            _fields(scratch), live=self.live,
                                            tile=self.nl_tile, forcing=self.kf,
                                            dforc=self.dforc,
                                            tracers=self.kernel_tracers(stack.tracers),
                                            end=_end(end, self.tracers), strat_w=self.sw,
                                            dstrat=self.dstrat)
            return
        if self.cuda:
            adjoint_step.adjoint_rollout(_fields(stack)[:3], _fields(g), *self.adj,
                                         *self.scal, n, ddt, _fields(out),
                                         _fields(scratch), live=self.live, forcing=self.kf,
                                         dforc=self.dforc, tracers=self.kernel_tracers(
                                             stack.tracers), end=_end(end, self.tracers),
                                         strat_w=self.sw, dstrat=self.dstrat)
            return
        for j in reversed(range(n)):
            res = self.plain_reverse(_slot(stack, j), g)
            g = res[0]
            ddt += res[1]
            self.add_plain_cots(res)
        for dst, x in zip(_fields(out), _fields(g)):
            dst.copy_(x)


def _end(end: StructState | None, tracers: bool):
    """(h, tracer planes) of the state after a stack's last slot, which a
    tracer reverse reads; None without tracers."""
    if not tracers:
        return None
    if end is None:
        raise ValueError("a reverse with tracers on the card reads the state after the "
                         "last step it reverses (the segment's or the rollout's final "
                         "state: end= or final=)")
    return end.layer_thickness, end.tracers


def _slot(stack: StructState, j: int) -> StructState:
    return StructState(*(x[j] for x in _fields(stack)))


def _empty(like: StructState, slots: int | None = None) -> StructState:
    lead = () if slots is None else (slots,)
    return StructState(*(torch.empty(lead + tuple(x.shape), dtype=x.dtype, device=x.device)
                         for x in _fields(like)))


def _copy(state: StructState) -> StructState:
    return StructState(*(x.clone(memory_format=torch.contiguous_format)
                         for x in _fields(state)))


def _steps(mesh: StructMesh, dt, state: StructState, nonlinear: bool, forcing, tropts,
           strat=None, **kw) -> "_Steps":
    """The steps for ``state`` (its tracers, if any, with ``tropts`` =
    (kappa, upwind))."""
    return _Steps(mesh, dt, state.layer_thickness, nonlinear, forcing=forcing,
                  tracers=state.tracers is not None, tracer_kappa=tropts[0],
                  tracer_upwind=tropts[1], strat=strat, **kw)


def _forward(state: StructState, mesh: StructMesh, dt, n_steps: int, group: int,
             nonlinear: bool, forcing, tropts, steps=None,
             strat=None) -> tuple[StructState, StructState]:
    """``forward_ckpts`` on a state whose tracers are planes: (final state,
    checkpoints), both with tracers as planes."""
    starts = range(0, n_steps, group)
    ckpts = _empty(state, len(starts))
    if nonlinear:
        check_nl_mesh(mesh)
    if n_steps == 0:
        return _copy(state), ckpts
    steps = steps or _steps(mesh, dt, state, nonlinear, forcing, tropts, strat)
    for dst, x in zip(_fields(_slot(ckpts, 0)), _fields(state)):
        dst.copy_(x)
    final, scratch = _empty(state), _empty(state)
    for gi, start in enumerate(starts):
        dst = _slot(ckpts, gi + 1) if gi + 1 < len(starts) else final
        steps.advance(_slot(ckpts, gi), dst, min(group, n_steps - start), scratch)
    return final, ckpts


def forward_ckpts(state: StructState, mesh: StructMesh, dt, n_steps: int,
                  group: int, nonlinear: bool = False, forcing: Forcing | None = None, *,
                  tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                  strat: Stratification | None = None) -> tuple[StructState, StructState]:
    """The forward in groups of ``group`` steps (the last takes the
    remainder), keeping each group's start state. Returns (final state,
    checkpoints as a StructState of stacks with one slot per group; their
    tracers, if any, as planes (slots, 2 nT, ny2, nx, K)). The per-step
    arithmetic is that of one ``fused_run_loop`` call (with ``nonlinear``,
    of the vector-invariant core; with ``forcing``, forced; the state's
    tracers with ``tracer_kappa`` and ``tracer_upwind``; with ``strat``,
    stratified), so the final state is bitwise the same. Counterpart of
    ``_pallas_forward_ckpts``."""
    final, ckpts = _forward(_planes_state(state), mesh, dt, n_steps, group, nonlinear,
                            forcing, (tracer_kappa, tracer_upwind), strat=strat)
    return _lattice_state(final), ckpts


def _segment(steps: _Steps, ckpt: StructState, cot: StructState, n: int,
             stack: StructState, ddt: torch.Tensor, out: StructState,
             scratch: StructState, end: StructState | None = None):
    for dst, x in zip(_fields(_slot(stack, 0)), _fields(ckpt)):
        dst.copy_(x)
    steps.fill(stack, n - 1)
    steps.reverse(stack, cot, n, ddt, out, scratch, end)


def _cotangent(g: StructState, like: StructState) -> StructState:
    """The output cotangent ``g`` (tracers as planes) in ``like``'s dtype,
    contiguous; tracers that ``g`` lacks are zeros."""
    if like.tracers is not None and g.tracers is None:
        g = StructState(g.ssh, g.layer_thickness, g.normal_velocity,
                        torch.zeros_like(like.tracers))
    return StructState(*(x.to(y.dtype).contiguous()
                         for x, y in zip(_fields(g), _fields(like))))


def _dt_meta(dt, device) -> tuple:
    """(dtype, device) of d(dt): dt's own for a tensor, float64 on the
    state's device for a Python number."""
    if torch.is_tensor(dt):
        return dt.dtype, dt.device
    return torch.float64, device


def _plan(state: StructState, n_steps: int, plan) -> int:
    """Steps per group: ``plan``, or ``adjoint_plan``'s within the default
    budget."""
    if plan:
        return plan
    if n_steps == 0:
        return 1
    return adjoint_plan(n_steps, _state_bytes(state),
                        _default_budget(state.layer_thickness.device))


def adjoint_segment(ckpt: StructState, cot: StructState, mesh: StructMesh, dt,
                    n_steps: int, nonlinear: bool = False, forcing: Forcing | None = None, *,
                    end: StructState | None = None, tracer_kappa: float = 0.0,
                    tracer_upwind: float = 1.0, strat: Stratification | None = None):
    """Reverse of one n-step segment (of the nonlinear core with
    ``nonlinear``, forced with ``forcing``, the state's tracers with
    ``tracer_kappa`` and ``tracer_upwind``, stratified with ``strat``):
    rebuild its states from its start state ``ckpt``, then step the
    cotangent ``cot`` at its end back to its start. ``end``, the segment's
    final state, is what a tracer reverse on the card reads after its last
    step (it raises ValueError without). Returns (cotangent at the start,
    d(dt) as a 0-d float64 tensor), with forcing the ForcingCot third, with
    ``strat`` d(W) (K, K) in float64 last. Counterpart of
    ``_adjoint_segment``."""
    if n_steps < 1:
        raise ValueError("a segment has n_steps >= 1")
    ckpt = _planes_state(ckpt)
    steps = _steps(mesh, dt, ckpt, nonlinear, forcing, (tracer_kappa, tracer_upwind), strat)
    ddt = torch.zeros(1, dtype=torch.float64, device=ckpt.layer_thickness.device)
    out = _empty(ckpt)
    _segment(steps, ckpt, _cotangent(_planes_state(cot), ckpt), n_steps,
             _empty(ckpt, n_steps), ddt, out, _empty(ckpt),
             None if end is None else _planes_state(end))
    return steps.cots((_lattice_state(out), ddt.reshape(())))


def _sweep(steps: _Steps, ckpts: StructState, n: int, group: int, g: StructState,
           final: StructState | None = None) -> tuple:
    """The reverse sweep over n slots from the checkpoints, one per group of
    ``group`` slots (the last takes the remainder): per group, last to
    first, rebuild its slots with ``steps.fill`` and step the cotangent back
    through them with ``steps.reverse``, whose end state is the next
    checkpoint or, for the last group, ``final``. A slot is a step here and
    a superstep in tiled_diff. States with tracers as planes. Returns
    (cotangent of the rollout's input, d(dt) as a 0-d float64 tensor), with
    forcing the ForcingCot third, with stratification d(W) last."""
    x = ckpts.layer_thickness
    ddt = torch.zeros(1, dtype=torch.float64, device=x.device)
    if n == 0:
        return steps.cots((g, ddt.reshape(())))
    like = _slot(ckpts, 0)
    stack = _empty(like, min(group, n))
    bufs, scratch = (_empty(like), _empty(like)), _empty(like)
    cot = _cotangent(g, like)
    n_groups = len(range(0, n, group))
    for gi in reversed(range(n_groups)):
        out = bufs[gi % 2]
        end = _slot(ckpts, gi + 1) if gi + 1 < n_groups else final
        _segment(steps, _slot(ckpts, gi), cot, min(group, n - gi * group), stack,
                 ddt, out, scratch, end)
        cot = out
    return steps.cots((cot, ddt.reshape(())))


def adjoint_from_ckpts(ckpts: StructState, mesh: StructMesh, dt, n_steps: int,
                       group: int, g: StructState, nonlinear: bool = False,
                       forcing: Forcing | None = None, *, final: StructState | None = None,
                       tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                       strat: Stratification | None = None) -> tuple:
    """The reverse sweep from the checkpoints of ``forward_ckpts`` (of the
    nonlinear core with ``nonlinear``, forced with ``forcing``, the tracers
    with ``tracer_kappa`` and ``tracer_upwind``, stratified with ``strat``):
    per group, last to first, rebuild its states and step the cotangent back
    through them. ``final``, the rollout's final state (``forward_ckpts``'
    first item), is what the last group's tracer reverse on the card reads
    after its last step (it raises ValueError without). Returns (cotangent
    of the rollout's input, d(dt) as a 0-d float64 tensor), with forcing the
    ForcingCot third, with ``strat`` d(W) (K, K) in float64 last, as
    ``_pallas_adjoint_from_ckpts`` returns dsw. Counterpart of
    ``_pallas_adjoint_from_ckpts``."""
    steps = _steps(mesh, dt, ckpts, nonlinear, forcing, (tracer_kappa, tracer_upwind), strat)
    return _reverse(steps, ckpts, n_steps, group, g,
                    None if final is None else _planes_state(final))


def _reverse(steps: _Steps, ckpts: StructState, n: int, group: int, g: StructState,
             final: StructState | None) -> tuple:
    """``_sweep`` for the output cotangent ``g`` (tracers in the lattice
    layout) and the rollout's ``final`` state with its tracers as planes;
    the input cotangent's tracers in the lattice layout."""
    res = _sweep(steps, ckpts, n, group, _planes_state(g), final)
    return (_lattice_state(res[0]), *res[1:])


def fused_adjoint_rollout(state: StructState, mesh: StructMesh, dt, n_steps: int,
                          g: StructState, *, plan: int | None = None, nonlinear: bool = False,
                          forcing: Forcing | None = None, tracer_kappa: float = 0.0,
                          tracer_upwind: float = 1.0, strat: Stratification | None = None):
    """VJP of an n-step rollout (of the nonlinear core with ``nonlinear``,
    forced with ``forcing``, the state's tracers with ``tracer_kappa`` and
    ``tracer_upwind``, stratified with ``strat``): given its input ``state``
    and an output cotangent ``g``, returns (d_state, d_dt), d_dt as a 0-d
    tensor in dt's dtype (float64 for a Python dt), and with forcing the
    ForcingCot third; d(W) is dropped, as ``pallas_adjoint_rollout`` drops
    it (``adjoint_from_ckpts`` returns it). ``plan`` (steps per group)
    overrides ``adjoint_plan``, whose budget is MEMORY_SHARE of the card's
    free memory (unbounded on the CPU). Counterpart of
    ``pallas_adjoint_rollout``."""
    dtype, device = _dt_meta(dt, state.layer_thickness.device)
    group = _plan(state, n_steps, plan)
    kw = dict(tracer_kappa=tracer_kappa, tracer_upwind=tracer_upwind, strat=strat)
    final, ckpts = forward_ckpts(state, mesh, dt, n_steps, group, nonlinear, forcing, **kw)
    res = adjoint_from_ckpts(ckpts, mesh, dt, n_steps, group, g, nonlinear, forcing,
                             final=final, **kw)
    return (res[0], res[1].to(dtype=dtype, device=device), *res[2:3 if forcing is not None else 2])


def _dt_value(dt) -> float:
    return float(dt.detach()) if torch.is_tensor(dt) else float(dt)


def _save_dt(ctx, dt, device):
    ctx.dt_v, ctx.dt_meta = _dt_value(dt), _dt_meta(dt, device)


# The inputs of the autograd Functions below: the state (ssh, h, u and the
# tracers, None without), dt, the forcing's differentiable parts (wind and
# the three coefficients, None unforced), the stratification's W (None
# unstratified), then the rest, which get no cotangent.
_DIFF_INPUTS = 10
_DT_INPUT = 4


def _forcing_inputs(forcing: Forcing | None) -> tuple:
    if forcing is None:
        return (None,) * 4
    return (forcing.wind_edge, forcing.drag_linear, forcing.drag_quadratic, forcing.rayleigh)


def _strat_input(strat: Stratification | None):
    return None if strat is None else strat.phi_weights


def _save_strat(ctx, strat: Stratification | None, w) -> Stratification | None:
    """The stratification with its W as given (detached), kept on ctx with
    W's dtype and device for its cotangent."""
    if strat is not None:
        strat = Stratification(w.detach(), strat.densities)
        ctx.strat_meta = (w.dtype, w.device)
    ctx.strat = strat
    return strat


def _state_inputs(state: StructState) -> tuple:
    """(ssh, h, u, tracers) of a state, tracers None without."""
    return (state.ssh, state.layer_thickness, state.normal_velocity, state.tracers)


def _save_forcing(ctx, forcing: Forcing | None, wind, dlin, dquad, rayl) -> Forcing | None:
    """The forcing with its differentiable parts as given (detached), kept on
    ctx with the inputs' dtypes for the cotangents."""
    if forcing is not None:
        forcing = Forcing(wind.detach(), forcing.top_mask, forcing.bottom_mask,
                          *(x.detach() for x in (dlin, dquad, rayl)))
        ctx.forc_meta = [(x.dtype, x.device) for x in (wind, dlin, dquad, rayl)]
    ctx.forcing = forcing
    return forcing


def _grads(ctx, res) -> tuple:
    """The cotangents of the first _DIFF_INPUTS inputs from a reverse's
    (d_state, ddt[, ForcingCot][, d(W)]), d_state's tracers (None without)
    in the lattice layout."""
    d_state, ddt = res[:2]
    d_dt = None
    if ctx.needs_input_grad[_DT_INPUT]:
        dtype, device = ctx.dt_meta
        d_dt = ddt.to(dtype=dtype, device=device)
    d_forc = [None] * 4
    if ctx.forcing is not None:
        d = res[2]
        d_forc = [x.to(dtype=t, device=v)
                  for x, (t, v) in zip((d.wind, *d.coefs), ctx.forc_meta)]
    d_w = None
    if ctx.strat is not None:
        dtype, device = ctx.strat_meta
        d_w = res[-1].to(dtype=dtype, device=device)
    return (*_state_inputs(d_state), d_dt, *d_forc, d_w)


def _kept_end(final: StructState, tracers) -> StructState | None:
    """The end state a tracer reverse reads (None without tracers), for
    ctx: detached aliases, since the outputs themselves on ctx would tie
    them to their own grad_fn, a cycle through autograd's nodes that
    Python's collector cannot break, keeping the outputs and the
    checkpoints on the device for good."""
    if tracers is None:
        return None
    return StructState(*(None if x is None else x.detach() for x in _state_inputs(final)))


def _output_cotangent(like: StructState, grads) -> StructState:
    """The outputs' cotangents as a state like ``like`` (tracers in the
    lattice layout where ``like`` has them): zeros where autograd gave
    None."""
    return StructState(*(torch.zeros_like(x) if gx is None else gx
                         for x, gx in zip(_fields(like), grads)))


class FusedRolloutDiff(torch.autograd.Function):
    """n-step rollout whose backward is the checkpointed reverse sweep
    (``forward_ckpts`` forward, ``adjoint_from_ckpts`` backward). Inputs:
    ssh, h, u, the tracers (lattice layout, or None), dt (float or tensor),
    the forcing's wind and r_lin, Cd, lambda (None unforced), the
    stratification's W (None unstratified), mesh, n_steps, plan, nonlinear,
    forcing (its level masks), tracer_kappa, tracer_upwind, strat (its
    densities). The mesh, the masks, kappa, upwind and the densities get no
    cotangent (None; the JAX package returns zeros for the mesh and the
    densities and keeps kappa and upwind nondifferentiable)."""

    @staticmethod
    def forward(ctx, ssh, h, u, tracers, dt, wind, dlin, dquad, rayl, w, mesh, n_steps,
                plan=None, nonlinear=False, forcing=None, tracer_kappa=0.0, tracer_upwind=1.0,
                strat=None):
        state = _planes_state(StructState(ssh, h, u, tracers))
        _save_dt(ctx, dt, h.device)
        forcing = _save_forcing(ctx, forcing, wind, dlin, dquad, rayl)
        strat = _save_strat(ctx, strat, w)
        group = _plan(state, n_steps, plan)
        ctx.tropts = (tracer_kappa, tracer_upwind)
        final, ckpts = _forward(state, mesh, ctx.dt_v, n_steps, group, nonlinear, forcing,
                                ctx.tropts, strat=strat)
        ctx.ckpts, ctx.mesh, ctx.n_steps, ctx.group = ckpts, mesh, n_steps, group
        ctx.nonlinear = nonlinear
        # the end state of the last group, which a tracer reverse reads
        ctx.final = _kept_end(final, tracers)
        return _state_inputs(_lattice_state(final))

    @staticmethod
    @once_differentiable
    def backward(ctx, gs, gh, gu, gtr):
        rest = (None,) * 8
        if ctx.n_steps == 0:
            return gs, gh, gu, gtr, *(None,) * (_DIFF_INPUTS - 4), *rest
        like = _lattice_state(_slot(ctx.ckpts, 0))
        g = _output_cotangent(like, (gs, gh, gu, gtr))
        steps = _steps(ctx.mesh, ctx.dt_v, ctx.ckpts, ctx.nonlinear, ctx.forcing, ctx.tropts,
                       ctx.strat)
        res = _reverse(steps, ctx.ckpts, ctx.n_steps, ctx.group, g, ctx.final)
        return (*_grads(ctx, res), *rest)


def fused_rollout_diff(state: StructState, mesh: StructMesh, dt, n_steps: int, *,
                       plan: int | None = None, nonlinear: bool = False,
                       forcing: Forcing | None = None, tracer_kappa: float = 0.0,
                       tracer_upwind: float = 1.0,
                       strat: Stratification | None = None) -> StructState:
    """n-step rollout of the linear core, or with ``nonlinear`` of the
    vector-invariant one (periodic, or masked where the mesh has a wall
    mask), forced with ``forcing`` (struct layout), the state's tracers
    carried with ``tracer_kappa`` and ``tracer_upwind``, stratified with
    ``strat``, differentiable with respect to the state (its tracers among
    it), a tensor ``dt``, the forcing's wind and coefficients and the
    stratification's W: the reverse-mode pass through the whole loop, which
    the reference validates with Enzyme against finite differences. Forward
    through ``fe_step`` on the card, backward through ``adjoint_step`` (the
    nonlinear core: the nonlinear reverse kernel), every combination of the
    core, forcing, tracers and stratification through the kernels' composed
    arms. Counterpart of ``pallas_rollout_diff``."""
    return StructState(*FusedRolloutDiff.apply(*_state_inputs(state), dt,
                                               *_forcing_inputs(forcing), _strat_input(strat),
                                               mesh, n_steps, plan, nonlinear, forcing,
                                               tracer_kappa, tracer_upwind, strat))


class FusedStep(torch.autograd.Function):
    """One differentiable step: the forward kernel forward, the reverse
    kernel backward. Inputs: ssh, h, u, the tracers (or None), dt, the
    forcing's wind and coefficients (None unforced), the stratification's W
    (or None), mesh, nonlinear, forcing, tracer_kappa, tracer_upwind,
    strat."""

    @staticmethod
    def forward(ctx, ssh, h, u, tracers, dt, wind, dlin, dquad, rayl, w, mesh, nonlinear=False,
                forcing=None, tracer_kappa=0.0, tracer_upwind=1.0, strat=None):
        ctx.save_for_backward(ssh, h, u, tracers)
        ctx.mesh, ctx.nonlinear = mesh, nonlinear
        ctx.tropts = dict(tracer_kappa=tracer_kappa, tracer_upwind=tracer_upwind)
        _save_dt(ctx, dt, h.device)
        forcing = _save_forcing(ctx, forcing, wind, dlin, dquad, rayl)
        strat = _save_strat(ctx, strat, w)
        final = fused_run_loop(StructState(ssh, h, u, tracers), mesh, ctx.dt_v, 1,
                               nonlinear=nonlinear, forcing=forcing, strat=strat, **ctx.tropts)
        # the step's end state, which a tracer reverse reads
        ctx.final = _kept_end(final, tracers)
        return _state_inputs(final)

    @staticmethod
    @once_differentiable
    def backward(ctx, gs, gh, gu, gtr):
        state = StructState(*ctx.saved_tensors)
        res = adjoint_segment(state, _output_cotangent(state, (gs, gh, gu, gtr)), ctx.mesh,
                              ctx.dt_v, 1, ctx.nonlinear, ctx.forcing, end=ctx.final,
                              strat=ctx.strat, **ctx.tropts)
        return (*_grads(ctx, res), *(None,) * 6)


def fused_step(state: StructState, mesh: StructMesh, dt, *, nonlinear: bool = False,
               forcing: Forcing | None = None, tracer_kappa: float = 0.0,
               tracer_upwind: float = 1.0, strat: Stratification | None = None) -> StructState:
    """One differentiable forward-Euler step (of the nonlinear core with
    ``nonlinear``, forced with ``forcing``, the state's tracers with
    ``tracer_kappa`` and ``tracer_upwind``, stratified with ``strat``, its W
    differentiated). Counterpart of ``pallas_step``."""
    return StructState(*FusedStep.apply(*_state_inputs(state), dt, *_forcing_inputs(forcing),
                                        _strat_input(strat), mesh, nonlinear, forcing,
                                        tracer_kappa, tracer_upwind, strat))


# The size rule of auto_rollout_diff on the card: lattices of at least this
# many sites (2 * ny2 * nx, the cells) take the tiled reverse; none do.
# Measured on an H100 (chip_smoke.py phase 8, PERF.md section 5), grad of
# sum(ssh^2) over 100 levels in f32, with both reverse kernels redesigned:
# the tiled reverse took 0.99-1.01x the fused one's time at 64^2 (both on
# (4, 8) tiles), 1.05-1.08x at 128^2 and 1.08-1.09x at 256^2 (two runs),
# where adjoint_step's (4, 12) tile, which does not divide the lattice, is
# 10-13% faster per launch than the tiled kernel's (4, 8). The tiled reverse
# stays the route of tiled_rollout_diff and of q > 1.
TILED_REVERSE_SITES = math.inf


def auto_rollout_diff(state: StructState, mesh: StructMesh, dt, n_steps: int, *,
                      plan=None, nonlinear: bool = False,
                      forcing: Forcing | None = None, tracer_kappa: float = 0.0,
                      tracer_upwind: float = 1.0,
                      strat: Stratification | None = None) -> StructState:
    """The differentiable lattice rollout's entry point, the routing half of
    ``pallas_rollout_diff``'s forward (pallas_model.py:2779-2823). A CPU
    state takes ``fused_rollout_diff``, whose plain route runs the plain
    step and adjoint step. On the card the forward runs ``fe_step`` either
    way, and the reverse is ``adjoint_step`` (``fused_rollout_diff``) on
    lattices of fewer than TILED_REVERSE_SITES sites and ``tiled_adjoint``
    (``tiled_diff.tiled_rollout_diff``) on larger ones. ``nonlinear`` runs
    the vector-invariant core through the same routes (the kernels'
    nonlinear arms), ``forcing`` (struct layout, a differentiated input)
    through their forced arms, and the state's tracers (differentiated, with
    ``tracer_kappa`` and ``tracer_upwind``) through their tracer arms, and
    ``strat`` (its W a differentiated input) through their stratified arms.
    ``plan`` is the chosen route's: steps per group for the fused reverse,
    (row_tile, col_tile, q, group) for the tiled one."""
    sites = 2 * mesh.ny2 * mesh.nx
    kw = dict(plan=plan, nonlinear=nonlinear, forcing=forcing, tracer_kappa=tracer_kappa,
              tracer_upwind=tracer_upwind, strat=strat)
    if state.layer_thickness.device.type == "cuda" and sites >= TILED_REVERSE_SITES:
        from .tiled_diff import tiled_rollout_diff

        return tiled_rollout_diff(state, mesh, dt, n_steps, **kw)
    return fused_rollout_diff(state, mesh, dt, n_steps, **kw)
