"""The composed arms of the hand-written reverse kernels (every combination
of two or more of the nonlinear core, forcing, tracers and stratification:
the nonlinear reverse kernel's composed arms, adjoint_step's and
tiled_adjoint's at q = 1) and of the stack rebuild against the plain
reverse, on a CUDA card. These tests skip on machines without a card. They
import no JAX, so on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_composed_adjoint_kernel.py
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
from mpas_ocean_tpu_torch.structured import StructState, auto_rollout_diff, diff_model

from torch_gpu_cases import (  # noqa: F401 (fixture)
    COMPOSED_COMBOS,
    TRACER_FIELDS,
    composed_case,
    composed_ddt_scale,
    composed_errors,
    composed_reverse,
    composed_stack,
    composed_state,
    composed_steps,
    cuda,
    plain_composed_reverse,
)

pytestmark = pytest.mark.gpu

N = 6
DT = 10.0


def _cotangent(st, seed=11):
    rng = np.random.default_rng(seed)
    return StructState(*(None if getattr(st, f) is None else torch.from_numpy(
        rng.normal(size=tuple(getattr(st, f).shape))).to(getattr(st, f)) for f in TRACER_FIELDS))


def _run(model, st, opts, forcing, strat, g, plan=None, stack=None):
    """(the kernels' reverse of the combination over N steps, its stack)."""
    sm = model.struct_mesh
    steps = composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat, plan)
    st = composed_state(st, opts)
    if stack is None:
        stack = composed_stack(steps, st, N)
    return composed_reverse(steps, stack, composed_state(g, opts), N), stack


@pytest.mark.parametrize("route", ["fused", "tiled"])
@pytest.mark.parametrize("n, k", [(16, 4), (64, 36)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("opts", COMPOSED_COMBOS)
def test_composed_reverse_matches_plain_f64(cuda, opts, masked, n, k, route):
    """6 reverse steps of a combination through the kernel-built stack of a
    random f64 state (forced with random winds, levels and coefficients,
    two tracers at kappa 5 and upwind 0.5, a dense W): every cotangent
    (the tracers', d(wind) among them) within 1e-12 of its scale, d(dt),
    d(r_lin, Cd, lambda) and d(W) within 1e-12 of their Cauchy-Schwarz
    scales; a rerun bitwise equal; the launches counted in every arm's
    counter of the kernel that ran (the nonlinear reverse with N,
    adjoint_step or tiled_adjoint without); each run with one option
    dropped at least 100x off in the fields both carry. The tiled route's
    tile is 4 x 8, which divides every lattice here."""
    model, st, forcing, strat = composed_case(opts, n, k, masked, cuda)
    sm = model.struct_mesh
    g = _cotangent(st)
    plan = None if route == "fused" else (4, 8)
    for m in (adjoint_step, tiled_adjoint):
        for c in [c for c, v in vars(m).items() if c.endswith("launches") and isinstance(v, int)]:
            setattr(m, c, 0)
    out, stack = _run(model, st, opts, forcing, strat, g, plan)
    again, _ = _run(model, st, opts, forcing, strat, g, plan, stack)
    ref, scales = plain_composed_reverse(stack, g, sm, DT, N, opts, forcing, strat)
    scales["d_dt"] = composed_ddt_scale(st, sm, DT, N, g, opts, forcing, strat)
    errs = composed_errors(out, ref, scales)
    assert max(r for _, r in errs.values()) <= 1e-12, errs
    for a, b in zip(out, again):
        if isinstance(a, StructState):
            assert all(getattr(a, f) is None or torch.equal(getattr(a, f), getattr(b, f))
                       for f in TRACER_FIELDS)
        else:
            assert a is None or torch.equal(a, b)
    arms = [o in opts for o in "FTS"]
    if "N" in opts:
        got = [adjoint_step.nl_launches, adjoint_step.nl_forced_launches,
               adjoint_step.nl_tracer_launches, adjoint_step.nl_strat_launches]
    else:
        m = adjoint_step if route == "fused" else tiled_adjoint
        got = [m.launches, m.forced_launches, m.tracer_launches, m.strat_launches]
    assert got == [2 * N] + [2 * N * a for a in arms]
    for drop in opts:
        rest = opts.replace(drop, "")
        bare, _ = _run(model, st, rest, forcing, strat, g, plan, None if drop == "T" else stack)
        miss = max(float((getattr(bare[0], f) - getattr(ref[0], f)).abs().max()
                         / getattr(ref[0], f).abs().max())
                   for f in TRACER_FIELDS if getattr(bare[0], f) is not None)
        assert miss >= 100 * 1e-12, (drop, miss)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nonlinear", [False, True])
def test_composed_stack_rebuild_is_the_forward_bitwise(cuda, nonlinear, masked):
    """The gradient's rebuild with every arm (fe_fill_stack, or
    fe_nl_fill_stack with N): slot j is bitwise the forward path's state
    after j steps (fe_rollout_into, or fe_nl_rollout on the same plan)."""
    opts = ("N" if nonlinear else "") + "FTS"
    model, st, forcing, strat = composed_case(opts, 64, 36, masked, cuda)
    sm = model.struct_mesh
    steps = composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat)
    stack = composed_stack(steps, st, N)
    src = diff_model._planes_state(st)
    for j in (1, N - 1, N):
        out, scratch = diff_model._empty(src), diff_model._empty(src)
        steps.advance(src, out, j, scratch)
        want = diff_model._slot(stack, j)
        assert all(torch.equal(a, b) for a, b in zip(diff_model._fields(out),
                                                     diff_model._fields(want))), j


@pytest.mark.parametrize("route", ["auto_rollout_diff", "tiled_rollout_diff"])
def test_full_physics_gradient_runs_the_composed_arms(cuda, route):
    """The full-physics gradient (all four options) of sum ssh^2 + sum T^2
    over 7 steps in groups of 3 through auto_rollout_diff and
    tiled_rollout_diff (q = 1) on a 32 x 32 x 8 f64 channel: w.r.t. the
    state, dt, W, the wind and the coefficients, within 1e-10 of the same
    gradient on the CPU (the plain reverse); every launch of fe_step and of
    the nonlinear reverse composed (7 forward and 4 rebuild launches, 7
    reverse), the reruns bitwise equal."""
    from mpas_ocean_tpu_torch.models import Stratification
    from mpas_ocean_tpu_torch.models.forcing import Forcing
    from mpas_ocean_tpu_torch.structured import tiled_rollout_diff

    fn = {"auto_rollout_diff": lambda *a, **kw: auto_rollout_diff(*a, plan=3, **kw),
          "tiled_rollout_diff": lambda *a, **kw: tiled_rollout_diff(*a, plan=(4, 8, 1, 3),
                                                                    **kw)}[route]
    model, st, forcing, strat = composed_case("NFTS", 32, 8, True, cuda)
    sm = model.struct_mesh

    def grad(device):
        x = [getattr(st, f).to(device).clone().requires_grad_(True) for f in TRACER_FIELDS]
        dt = torch.tensor(DT, dtype=torch.float64, device=device, requires_grad=True)
        w = strat.phi_weights.to(device).clone().requires_grad_(True)
        fd = [getattr(forcing, c).to(device).clone().requires_grad_(True)
              for c in ("wind_edge", "drag_linear", "drag_quadratic", "rayleigh")]
        f = Forcing(fd[0], forcing.top_mask.to(device), forcing.bottom_mask.to(device), *fd[1:])
        mesh = sm if device.type == "cuda" else model_cpu.struct_mesh
        out = fn(StructState(*x), mesh, dt, 7, nonlinear=True, forcing=f, tracer_kappa=5.0,
                 tracer_upwind=0.5, strat=Stratification(w, strat.densities.to(device)))
        return torch.autograd.grad((out.ssh ** 2).sum() + (out.tracers ** 2).sum(),
                                   x + [dt, w] + fd)

    model_cpu, _, _, _ = composed_case("NFTS", 32, 8, True, torch.device("cpu"))
    for m in (fe_step, adjoint_step, tiled_adjoint):
        for c in [c for c, v in vars(m).items() if c.endswith("launches") and isinstance(v, int)]:
            setattr(m, c, 0)
    card, again = grad(cuda), grad(cuda)
    assert [fe_step.launches, fe_step.forced_launches, fe_step.tracer_launches,
            fe_step.strat_launches] == [22] * 4
    assert [adjoint_step.nl_launches, adjoint_step.nl_forced_launches,
            adjoint_step.nl_tracer_launches, adjoint_step.nl_strat_launches] == [14] * 4
    assert adjoint_step.launches == 0 and tiled_adjoint.launches == 0
    assert all(torch.equal(a, b) for a, b in zip(card, again))
    host = grad(torch.device("cpu"))
    for a, b in zip(card, host):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-10
