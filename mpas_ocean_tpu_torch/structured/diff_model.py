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

Momentum forcing (``forcing=``, struct layout) is a differentiated input:
its wind and its three coefficients get cotangents (the level masks none,
as in the JAX package's ``_forcing_cotangent``, :1939-1955). On the card the
forced arms of the kernels run, linear core only (``nonlinear`` with
``forcing`` raises there); the reverse kernels accumulate d(wind) per edge
and d(r_lin, Cd, lambda) in double beside d(dt).

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
from .adjoint import ForcingCot, structured_adjoint_step, structured_nl_adjoint_step
from .fused_model import (
    _scal,
    check_forced_core,
    fused_run_loop,
    kernel_forcing,
    kernel_live,
    nl_adjoint_scal,
    nl_scal,
    nl_setup,
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
    "check_no_tracers",
    "forward_ckpts",
    "fused_adjoint_rollout",
    "fused_rollout_diff",
    "fused_step",
]

# share of the card's free memory that the checkpoints may take by default
MEMORY_SHARE = 0.5

_FIELDS = ("ssh", "layer_thickness", "normal_velocity")


def _fields(state: StructState) -> tuple:
    return tuple(getattr(state, f) for f in _FIELDS)


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
    preallocated tensors; stacks carry a leading slot axis. With forcing,
    the reverse adds d(wind) and d(r_lin, Cd, lambda) to ``dforc``."""

    def __init__(self, mesh: StructMesh, dt, like: torch.Tensor, nonlinear: bool = False,
                 nl_tile=None, forcing: Forcing | None = None):
        self.mesh, self.dt, self.nonlinear, self.forcing = mesh, dt, nonlinear, forcing
        self.cuda = like.device.type == "cuda"
        if not self.cuda and like.device.type != "cpu":
            raise ValueError(f"no rollout for state on {like.device}")
        if nonlinear:
            check_nl_mesh(mesh)
        check_forced_core(forcing, nonlinear, like.device)
        self.dforc = None
        if forcing is not None:
            # d(wind) in the state dtype, per edge channel; the coefficients' in double
            self.dforc = ForcingCot(
                torch.zeros((6, mesh.ny2, mesh.nx), dtype=like.dtype, device=like.device),
                torch.zeros(3, dtype=torch.float64, device=like.device))
        if self.cuda:
            dtype = like.dtype
            self.scal = _scal(mesh, dt, dtype)
            f_edge = mesh.f_edge.to(dtype).contiguous()
            rts = mesh.resting_thickness_sum.to(dtype).contiguous()
            self.fwd = (f_edge, rts, *mesh.host_stencil)
            self.adj = (f_edge, *mesh.host_adjoint_stencil)
            self.live = kernel_live(mesh)
            self.kf = kernel_forcing(forcing, mesh, dtype, like.device)
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

    def advance(self, src: StructState, out: StructState, n: int, scratch: StructState):
        """n >= 1 steps from src into out."""
        if self.cuda and self.nonlinear:
            fe_step.fe_nl_rollout(*_fields(src), *self.nl_fwd, *self.nl_scal, n,
                                  live=self.live, out=_fields(out), scratch=_fields(scratch))
        elif self.cuda:
            fe_step.fe_rollout_into(_fields(src), _fields(out), *self.fwd, *self.scal,
                                    n, _fields(scratch), live=self.live, forcing=self.kf)
        else:
            for dst, x in zip(_fields(out), _fields(structured_run_loop(
                    src, self.mesh, self.dt, n, nonlinear=self.nonlinear,
                    forcing=self.forcing))):
                dst.copy_(x)

    def fill(self, stack: StructState, n: int):
        """Slot j + 1 = one step of slot j, for j < n."""
        if self.cuda and self.nonlinear:
            fe_step.fe_nl_fill_stack(_fields(stack), *self.nl_fwd, *self.nl_scal, n,
                                     live=self.live)
        elif self.cuda:
            fe_step.fe_fill_stack(_fields(stack), *self.fwd, *self.scal, n, live=self.live,
                                  forcing=self.kf)
        else:
            for j in range(n):
                nxt = structured_step(_slot(stack, j), self.mesh, self.dt, self.nonlinear,
                                      self.forcing)
                for dst, x in zip(_fields(_slot(stack, j + 1)), _fields(nxt)):
                    dst.copy_(x)

    def reverse(self, stack: StructState, g: StructState, n: int, ddt: torch.Tensor,
                out: StructState, scratch: StructState):
        """n >= 1 reverse steps through the stack's slots n - 1 .. 0, from
        the cotangent g at step n into out; d(dt) is added to ddt, and with
        forcing d(wind) and d(r_lin, Cd, lambda) to ``dforc``."""
        if self.cuda and self.nonlinear:
            adjoint_step.nl_adjoint_rollout(_fields(stack), _fields(g), *self.nl_adj,
                                            *self.nl_adj_scal, n, ddt, _fields(out),
                                            _fields(scratch), live=self.live,
                                            tile=self.nl_tile)
            return
        if self.cuda:
            adjoint_step.adjoint_rollout(_fields(stack), _fields(g), *self.adj,
                                         *self.scal, n, ddt, _fields(out),
                                         _fields(scratch), live=self.live, forcing=self.kf,
                                         dforc=self.dforc)
            return
        step = structured_nl_adjoint_step if self.nonlinear else structured_adjoint_step
        for j in reversed(range(n)):
            res = step(_slot(stack, j), g, self.mesh, self.dt, self.forcing)
            g = res[0]
            ddt += res[1]
            if self.forcing is not None:
                self.add_forcing_cot(res[2])
        for dst, x in zip(_fields(out), _fields(g)):
            dst.copy_(x)


def _slot(stack: StructState, j: int) -> StructState:
    return StructState(*(x[j] for x in _fields(stack)))


def _empty(like: StructState, slots: int | None = None) -> StructState:
    lead = () if slots is None else (slots,)
    return StructState(*(torch.empty(lead + tuple(x.shape), dtype=x.dtype, device=x.device)
                         for x in _fields(like)))


def _copy(state: StructState) -> StructState:
    return StructState(*(x.clone(memory_format=torch.contiguous_format)
                         for x in _fields(state)))


def check_no_tracers(state: StructState) -> None:
    """The gradients carry no tracers yet (the tracer arms of the reverse
    kernels are still to port): a state with tracers raises rather than
    losing them."""
    if state.tracers is not None:
        raise NotImplementedError("the gradient entry points carry no tracers yet; run a "
                                  "state with tracers forward (structured_auto_run_loop)")


def forward_ckpts(state: StructState, mesh: StructMesh, dt, n_steps: int,
                  group: int, nonlinear: bool = False, forcing: Forcing | None = None
                  ) -> tuple[StructState, StructState]:
    """The forward in groups of ``group`` steps (the last takes the
    remainder), keeping each group's start state. Returns (final state,
    checkpoints as a StructState of stacks with one slot per group). The
    per-step arithmetic is that of one ``fused_run_loop`` call (with
    ``nonlinear``, of the vector-invariant core; with ``forcing``, forced),
    so the final state is bitwise the same. Counterpart of
    ``_pallas_forward_ckpts``."""
    check_no_tracers(state)
    starts = range(0, n_steps, group)
    ckpts = _empty(state, len(starts))
    if nonlinear:
        check_nl_mesh(mesh)
    check_forced_core(forcing, nonlinear, state.layer_thickness.device)
    if n_steps == 0:
        return _copy(state), ckpts
    steps = _Steps(mesh, dt, state.layer_thickness, nonlinear, forcing=forcing)
    for dst, x in zip(_fields(_slot(ckpts, 0)), _fields(state)):
        dst.copy_(x)
    final, scratch = _empty(state), _empty(state)
    for gi, start in enumerate(starts):
        dst = _slot(ckpts, gi + 1) if gi + 1 < len(starts) else final
        steps.advance(_slot(ckpts, gi), dst, min(group, n_steps - start), scratch)
    return final, ckpts


def _segment(steps: _Steps, ckpt: StructState, cot: StructState, n: int,
             stack: StructState, ddt: torch.Tensor, out: StructState,
             scratch: StructState):
    for dst, x in zip(_fields(_slot(stack, 0)), _fields(ckpt)):
        dst.copy_(x)
    steps.fill(stack, n - 1)
    steps.reverse(stack, cot, n, ddt, out, scratch)


def _cotangent(g: StructState, like: StructState) -> StructState:
    return StructState(*(x.to(y.dtype).contiguous()
                         for x, y in zip(_fields(g), _fields(like))))


def _dt_meta(dt, device) -> tuple:
    """(dtype, device) of d(dt): dt's own for a tensor, float64 on the
    state's device for a Python number."""
    if torch.is_tensor(dt):
        return dt.dtype, dt.device
    return torch.float64, device


def _plan(state: StructState, n_steps: int, plan) -> int:
    if plan:
        return plan
    if n_steps == 0:
        return 1
    return adjoint_plan(n_steps, _state_bytes(state),
                        _default_budget(state.layer_thickness.device))


def _with_forcing(result: tuple, steps: _Steps) -> tuple:
    """(d_state, d_dt), and the ForcingCot third where the steps are forced."""
    d = steps.forcing_cot()
    return result if d is None else (*result, d)


def adjoint_segment(ckpt: StructState, cot: StructState, mesh: StructMesh, dt,
                    n_steps: int, nonlinear: bool = False, forcing: Forcing | None = None):
    """Reverse of one n-step segment (of the nonlinear core with
    ``nonlinear``, forced with ``forcing``): rebuild its states from its
    start state ``ckpt``, then step the cotangent ``cot`` at its end back to
    its start. Returns (cotangent at the start, d(dt) as a 0-d float64
    tensor), and with forcing the ForcingCot third. Counterpart of
    ``_adjoint_segment``."""
    if n_steps < 1:
        raise ValueError("a segment has n_steps >= 1")
    check_no_tracers(ckpt)
    steps = _Steps(mesh, dt, ckpt.layer_thickness, nonlinear, forcing=forcing)
    ddt = torch.zeros(1, dtype=torch.float64, device=ckpt.layer_thickness.device)
    out = _empty(ckpt)
    _segment(steps, ckpt, _cotangent(cot, ckpt), n_steps, _empty(ckpt, n_steps), ddt,
             out, _empty(ckpt))
    return _with_forcing((out, ddt.reshape(())), steps)


def _sweep(steps: _Steps, ckpts: StructState, n: int, group: int, g: StructState) -> tuple:
    """The reverse sweep over n slots from the checkpoints, one per group of
    ``group`` slots (the last takes the remainder): per group, last to
    first, rebuild its slots with ``steps.fill`` and step the cotangent back
    through them with ``steps.reverse``. A slot is a step here and a
    superstep in tiled_diff. Returns (cotangent of the rollout's input,
    d(dt) as a 0-d float64 tensor), and with forcing the ForcingCot third."""
    x = ckpts.layer_thickness
    ddt = torch.zeros(1, dtype=torch.float64, device=x.device)
    if n == 0:
        return _with_forcing((g, ddt.reshape(())), steps)
    like = _slot(ckpts, 0)
    stack = _empty(like, min(group, n))
    bufs, scratch = (_empty(like), _empty(like)), _empty(like)
    cot = _cotangent(g, like)
    for gi in reversed(range(len(range(0, n, group)))):
        out = bufs[gi % 2]
        _segment(steps, _slot(ckpts, gi), cot, min(group, n - gi * group), stack,
                 ddt, out, scratch)
        cot = out
    return _with_forcing((cot, ddt.reshape(())), steps)


def adjoint_from_ckpts(ckpts: StructState, mesh: StructMesh, dt, n_steps: int,
                       group: int, g: StructState, nonlinear: bool = False,
                       forcing: Forcing | None = None) -> tuple:
    """The reverse sweep from the checkpoints of ``forward_ckpts`` (of the
    nonlinear core with ``nonlinear``, forced with ``forcing``): per group,
    last to first, rebuild its states and step the cotangent back through
    them. Returns (cotangent of the rollout's input, d(dt) as a 0-d float64
    tensor), and with forcing the ForcingCot third. Counterpart of
    ``_pallas_adjoint_from_ckpts``."""
    return _sweep(_Steps(mesh, dt, ckpts.layer_thickness, nonlinear, forcing=forcing), ckpts,
                  n_steps, group, g)


def fused_adjoint_rollout(state: StructState, mesh: StructMesh, dt, n_steps: int,
                          g: StructState, *, plan: int | None = None, nonlinear: bool = False,
                          forcing: Forcing | None = None):
    """VJP of an n-step rollout (of the nonlinear core with ``nonlinear``,
    forced with ``forcing``): given its input ``state`` and an output
    cotangent ``g``, returns (d_state, d_dt), d_dt as a 0-d tensor in dt's
    dtype (float64 for a Python dt), and with forcing the ForcingCot third.
    ``plan`` (steps per group) overrides ``adjoint_plan``, whose budget is
    MEMORY_SHARE of the card's free memory (unbounded on the CPU).
    Counterpart of ``pallas_adjoint_rollout``."""
    dtype, device = _dt_meta(dt, state.layer_thickness.device)
    group = _plan(state, n_steps, plan)
    _, ckpts = forward_ckpts(state, mesh, dt, n_steps, group, nonlinear, forcing)
    res = adjoint_from_ckpts(ckpts, mesh, dt, n_steps, group, g, nonlinear, forcing)
    return (res[0], res[1].to(dtype=dtype, device=device), *res[2:])


def _dt_value(dt) -> float:
    return float(dt.detach()) if torch.is_tensor(dt) else float(dt)


def _save_dt(ctx, dt, device):
    ctx.dt_v, ctx.dt_meta = _dt_value(dt), _dt_meta(dt, device)


# The inputs of the autograd Functions below: the state, dt, the forcing's
# differentiable parts (wind and the three coefficients, None unforced),
# then the rest, which get no cotangent.
_DIFF_INPUTS = 8


def _forcing_inputs(forcing: Forcing | None) -> tuple:
    if forcing is None:
        return (None,) * 4
    return (forcing.wind_edge, forcing.drag_linear, forcing.drag_quadratic, forcing.rayleigh)


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
    (d_state, ddt[, ForcingCot])."""
    d_state, ddt = res[:2]
    d_dt = None
    if ctx.needs_input_grad[3]:
        dtype, device = ctx.dt_meta
        d_dt = ddt.to(dtype=dtype, device=device)
    d_forc = [None] * 4
    if ctx.forcing is not None:
        d = res[2]
        d_forc = [x.to(dtype=t, device=v)
                  for x, (t, v) in zip((d.wind, *d.coefs), ctx.forc_meta)]
    return (*_fields(d_state), d_dt, *d_forc)


def _output_cotangent(like: StructState, grads) -> StructState:
    return StructState(*(torch.zeros_like(x) if gx is None else gx
                         for x, gx in zip(_fields(like), grads)))


class FusedRolloutDiff(torch.autograd.Function):
    """n-step rollout whose backward is the checkpointed reverse sweep
    (``forward_ckpts`` forward, ``adjoint_from_ckpts`` backward). Inputs:
    ssh, h, u, dt (float or tensor), the forcing's wind and r_lin, Cd,
    lambda (None unforced), mesh, n_steps, plan, nonlinear, forcing (its
    level masks). The mesh and the masks get no cotangent (None; the JAX
    package returns zeros for them)."""

    @staticmethod
    def forward(ctx, ssh, h, u, dt, wind, dlin, dquad, rayl, mesh, n_steps, plan=None,
                nonlinear=False, forcing=None):
        state = StructState(ssh, h, u)
        _save_dt(ctx, dt, h.device)
        forcing = _save_forcing(ctx, forcing, wind, dlin, dquad, rayl)
        group = _plan(state, n_steps, plan)
        final, ckpts = forward_ckpts(state, mesh, ctx.dt_v, n_steps, group, nonlinear, forcing)
        ctx.ckpts, ctx.mesh, ctx.n_steps, ctx.group = ckpts, mesh, n_steps, group
        ctx.nonlinear = nonlinear
        return _fields(final)

    @staticmethod
    @once_differentiable
    def backward(ctx, gs, gh, gu):
        rest = (None,) * 5
        if ctx.n_steps == 0:
            return gs, gh, gu, *(None,) * (_DIFF_INPUTS - 3), *rest
        g = _output_cotangent(_slot(ctx.ckpts, 0), (gs, gh, gu))
        res = adjoint_from_ckpts(ctx.ckpts, ctx.mesh, ctx.dt_v, ctx.n_steps, ctx.group, g,
                                 ctx.nonlinear, ctx.forcing)
        return (*_grads(ctx, res), *rest)


def fused_rollout_diff(state: StructState, mesh: StructMesh, dt, n_steps: int, *,
                       plan: int | None = None, nonlinear: bool = False,
                       forcing: Forcing | None = None) -> StructState:
    """n-step rollout of the linear core, or with ``nonlinear`` of the
    vector-invariant one (periodic, or masked where the mesh has a wall
    mask), forced with ``forcing`` (struct layout), differentiable with
    respect to the state, a tensor ``dt`` and the forcing's wind and
    coefficients: the reverse-mode pass through the whole loop, which the
    reference validates with Enzyme against finite differences. Forward
    through ``fe_step`` on the card, backward through ``adjoint_step`` (the
    nonlinear core: the nonlinear reverse kernel; forcing with the
    nonlinear core raises there). A state with tracers raises
    NotImplementedError. Counterpart of ``pallas_rollout_diff``."""
    check_no_tracers(state)
    return StructState(*FusedRolloutDiff.apply(*_fields(state), dt, *_forcing_inputs(forcing),
                                               mesh, n_steps, plan, nonlinear, forcing))


class FusedStep(torch.autograd.Function):
    """One differentiable step: the forward kernel forward, the reverse
    kernel backward. Inputs: ssh, h, u, dt, the forcing's wind and
    coefficients (None unforced), mesh, nonlinear, forcing."""

    @staticmethod
    def forward(ctx, ssh, h, u, dt, wind, dlin, dquad, rayl, mesh, nonlinear=False,
                forcing=None):
        ctx.save_for_backward(ssh, h, u)
        ctx.mesh, ctx.nonlinear = mesh, nonlinear
        _save_dt(ctx, dt, h.device)
        forcing = _save_forcing(ctx, forcing, wind, dlin, dquad, rayl)
        return _fields(fused_run_loop(StructState(ssh, h, u), mesh, ctx.dt_v, 1,
                                      nonlinear=nonlinear, forcing=forcing))

    @staticmethod
    @once_differentiable
    def backward(ctx, gs, gh, gu):
        state = StructState(*ctx.saved_tensors)
        res = adjoint_segment(state, _output_cotangent(state, (gs, gh, gu)), ctx.mesh,
                              ctx.dt_v, 1, ctx.nonlinear, ctx.forcing)
        return (*_grads(ctx, res), None, None, None)


def fused_step(state: StructState, mesh: StructMesh, dt, *, nonlinear: bool = False,
               forcing: Forcing | None = None) -> StructState:
    """One differentiable forward-Euler step (of the nonlinear core with
    ``nonlinear``, forced with ``forcing``); a state with tracers raises.
    Counterpart of ``pallas_step``."""
    check_no_tracers(state)
    return StructState(*FusedStep.apply(*_fields(state), dt, *_forcing_inputs(forcing), mesh,
                                        nonlinear, forcing))


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
                      forcing: Forcing | None = None) -> StructState:
    """The differentiable lattice rollout's entry point, the routing half of
    ``pallas_rollout_diff``'s forward (pallas_model.py:2779-2823). A CPU
    state takes ``fused_rollout_diff``, whose plain route runs the plain
    step and adjoint step. On the card the forward runs ``fe_step`` either
    way, and the reverse is ``adjoint_step`` (``fused_rollout_diff``) on
    lattices of fewer than TILED_REVERSE_SITES sites and ``tiled_adjoint``
    (``tiled_diff.tiled_rollout_diff``) on larger ones. ``nonlinear`` runs
    the vector-invariant core through the same routes (the kernels'
    nonlinear arms), and ``forcing`` (struct layout, a differentiated input)
    through their forced arms. ``plan`` is the chosen route's: steps per
    group for the fused reverse, (row_tile, col_tile, q, group) for the
    tiled one. A state with tracers raises NotImplementedError (from either
    route), on the CPU and on the card."""
    sites = 2 * mesh.ny2 * mesh.nx
    if state.layer_thickness.device.type == "cuda" and sites >= TILED_REVERSE_SITES:
        from .tiled_diff import tiled_rollout_diff

        return tiled_rollout_diff(state, mesh, dt, n_steps, plan=plan, nonlinear=nonlinear,
                                  forcing=forcing)
    return fused_rollout_diff(state, mesh, dt, n_steps, plan=plan, nonlinear=nonlinear,
                              forcing=forcing)
