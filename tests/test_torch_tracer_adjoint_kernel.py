"""The tracer arms of the hand-written reverse kernels (adjoint_step, and
tiled_adjoint at q = 1 and q = 2) and of fe_step's stack entry against their plain
PyTorch versions, on a CUDA card, and the gradient entry points with tracers
on the card against the same on the CPU. These tests skip on machines
without a card. They import no JAX, so on a GPU machine without JAX they run
with

    python -m pytest --noconftest -m gpu tests/test_torch_tracer_adjoint_kernel.py
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
from mpas_ocean_tpu_torch.structured import (
    StructState,
    auto_rollout_diff,
    fused_model,
    fused_rollout_diff,
    tiled_rollout_diff,
)

from torch_gpu_cases import (  # noqa: F401 (fixture)
    TRACER_FIELDS,
    channel_lattice,
    cuda,
    ddt_scale,
    plain_tracer_reverse,
    random_forcing,
    random_lattice,
    reverse_errors,
    tracer_reverse,
    tracer_stack,
    with_tracers,
)

pytestmark = pytest.mark.gpu

OPTS = [(0.0, 1.0), (5.0, 0.5), (5.0, 0.0)]
N = 6


def _lattice(masked, device, n=32, k=6, dtype=np.float64, u_amp=0.5):
    model, st = (channel_lattice if masked else random_lattice)(n, n, k, device, seed=9,
                                                                dtype=dtype, u_amp=u_amp)
    return model, with_tracers(model, st)


def _cotangent(st, seed=11):
    rng = np.random.default_rng(seed)
    return StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(st, f).shape))).to(
        getattr(st, f)) for f in TRACER_FIELDS))


@pytest.mark.parametrize("kappa, upwind", OPTS)
@pytest.mark.parametrize("tile", [None, (4, 8)], ids=["adjoint_step", "tiled_adjoint"])
@pytest.mark.parametrize("masked", [False, True])
def test_tracer_reverse_matches_plain_f64(cuda, masked, tile, kappa, upwind):
    """6 reverse steps with two tracers through the kernel-built stack of a
    random 32 x 32 x 6 f64 state (u of 0.5 m/s, so that sign(F) is not 0 on
    most edges): every cotangent, the tracers' and d(dt) among them, within
    1e-12 of its scale (d(dt)'s: ``ddt_scale``, since a d(dt) of random
    cotangents may cancel to 1e-3 of its terms) of the plain reverse on the
    same primal states; a
    rerun bitwise equal; every launch counted as a tracer launch; the
    tracer-free arm on the same states and cotangents of ssh, h and u (the
    h' feedback missing) at least 100x off in d_h."""
    model, st = _lattice(masked, cuda)
    mesh = model.struct_mesh
    stack, kt, end = tracer_stack(st, mesh, 10.0, N, kappa, upwind)
    g = _cotangent(st)
    mod = adjoint_step if tile is None else tiled_adjoint
    mod.launches = mod.tracer_launches = 0
    out = tracer_reverse(stack, kt, end, g, mesh, 10.0, N, tile)
    again = tracer_reverse(stack, kt, end, g, mesh, 10.0, N, tile)
    assert (mod.launches, mod.tracer_launches) == (2 * N, 2 * N)
    ref = plain_tracer_reverse(stack, kt, end, g, mesh, 10.0, N)
    scale = ddt_scale(st, mesh, 10.0, N, g, tracer_kappa=kappa, tracer_upwind=upwind)
    errs = reverse_errors(out, ref, scale)
    assert max(errs.values()) <= 1e-12, errs
    assert torch.equal(out[1], again[1]) and all(
        torch.equal(getattr(out[0], f), getattr(again[0], f)) for f in TRACER_FIELDS)
    bare = tracer_reverse(stack, kt, end, g, mesh, 10.0, N, tile, tracers=False)
    miss = reverse_errors(bare, ref)["layer_thickness"]
    assert miss >= 100 * 1e-12, miss


@pytest.mark.parametrize("masked", [False, True])
def test_tracer_stack_is_the_forward_bitwise(cuda, masked):
    """fe_fill_stack's tracer arm fills slot j with what fe_rollout_into's
    j steps with tracers give, bit for bit (the reverse's primal states are
    the forward path's own)."""
    model, st = _lattice(masked, cuda)
    mesh = model.struct_mesh
    stack, kt, end = tracer_stack(st, mesh, 10.0, N, 5.0, 0.5)
    dtype = st.layer_thickness.dtype
    consts = (mesh.f_edge.to(dtype).contiguous(), mesh.resting_thickness_sum.to(dtype).contiguous(),
              *mesh.host_stencil, *fused_model._scal(mesh, 10.0, dtype))
    src = tuple(x[0] for x in stack)
    for j in range(1, N + 1):
        out = tuple(torch.empty_like(x) for x in src)
        tr_out = torch.empty_like(kt.planes[0])
        fe_step.fe_rollout_into(src, out, *consts, j, live=fused_model.kernel_live(mesh),
                                tracers=kt._replace(planes=kt.planes[0]), tr_out=tr_out)
        want = (end[0], end[1]) if j == N else (stack[1][j], kt.planes[j])
        assert torch.equal(out[1], want[0]) and torch.equal(tr_out, want[1]), j


ROUTES = {
    "auto_rollout_diff": lambda st, sm, dt, n: auto_rollout_diff(st, sm, dt, n, plan=3,
                                                                tracer_kappa=5.0,
                                                                tracer_upwind=0.5),
    "fused_rollout_diff": lambda st, sm, dt, n: fused_rollout_diff(st, sm, dt, n,
                                                                  tracer_kappa=5.0,
                                                                  tracer_upwind=0.5),
    "tiled_rollout_diff": lambda st, sm, dt, n: tiled_rollout_diff(st, sm, dt, n,
                                                                  plan=(4, 8, 1, 3),
                                                                  tracer_kappa=5.0,
                                                                  tracer_upwind=0.5),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("masked", [False, True])
def test_tracer_gradients_on_the_card_match_the_cpu(cuda, masked, route):
    """grad of sum ssh^2 + sum T^2 over 7 steps w.r.t. the state (tracers
    among it) and dt through each gradient route on the card (the kernels'
    tracer arms) against the same route on the CPU (the plain steps), f64:
    within 1e-11 of each field's scale."""
    grads = {}
    for where, device in (("card", cuda), ("cpu", torch.device("cpu"))):
        model, s = _lattice(masked, device)
        sm = model.struct_mesh
        x = [getattr(s, f).clone().requires_grad_(True) for f in TRACER_FIELDS]
        dt = torch.tensor(10.0, dtype=torch.float64, device=x[0].device, requires_grad=True)
        out = ROUTES[route](StructState(*x), sm, dt, 7)
        loss = (out.ssh ** 2).sum() + (out.tracers ** 2).sum()
        grads[where] = [g.cpu() for g in torch.autograd.grad(loss, x + [dt])]
    for name, a, b in zip(TRACER_FIELDS + ("dt",), grads["card"], grads["cpu"]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-11, name


def test_card_refuses_tracers_where_no_arm_runs_them(cuda):
    """On the card, the gradients of a tracer state run with the nonlinear
    core and with forcing (the composed arms: the tracers' cotangent finite
    and nonzero), and on the tiled route at q > 1 (tiled_adjoint's tracer
    arm at q > 1): the q = 2 gradient of a 32 x 32 x 6 f64 state through
    tiled_rollout_diff within 1e-11 of the same on the CPU, in 2 tracer
    launches, and tiled_adjoint's wrapper, one superstep of q = 2 through
    the stack's first slot to the state after two steps, within 1e-12 of
    the plain tracer reverse of both steps (d(dt) over its Cauchy-Schwarz
    scale); with the nonlinear core at q > 1 too (the q-step nonlinear
    reverse's tracer arm: a finite, nonzero tracer cotangent in 2 of its
    launches)."""
    model, st = _lattice(False, cuda, dtype=np.float32)
    sm = model.struct_mesh
    forcing = random_forcing(model)
    for route, kw in ((fused_rollout_diff, dict(nonlinear=True)),
                      (auto_rollout_diff, dict(forcing=forcing))):
        x = [getattr(st, f).clone().requires_grad_(True) for f in TRACER_FIELDS]
        out = route(StructState(*x), sm, 10.0, 2, **kw)
        d_tr = torch.autograd.grad((out.tracers ** 2).sum(), x[3])[0]
        assert bool(torch.isfinite(d_tr).all()) and float(d_tr.abs().max()) > 0
    x = [getattr(st, f).clone().requires_grad_(True) for f in TRACER_FIELDS]
    adjoint_step.nl_window_tracer_launches = 0
    out = tiled_rollout_diff(StructState(*x), sm, 10.0, 4, plan=(4, 8, 2, 1), nonlinear=True)
    d_tr = torch.autograd.grad((out.tracers ** 2).sum(), x[3])[0]
    assert bool(torch.isfinite(d_tr).all()) and float(d_tr.abs().max()) > 0
    assert adjoint_step.nl_window_tracer_launches == 2
    grads = {}
    for where, device in (("card", cuda), ("cpu", torch.device("cpu"))):
        model64, s64 = _lattice(False, device)
        x = [getattr(s64, f).clone().requires_grad_(True) for f in TRACER_FIELDS]
        tiled_adjoint.tracer_launches = 0
        out = tiled_rollout_diff(StructState(*x), model64.struct_mesh, 10.0, 4,
                                 plan=(4, 8, 2, 1), tracer_kappa=5.0, tracer_upwind=0.5)
        loss = (out.ssh ** 2).sum() + (out.tracers ** 2).sum()
        grads[where] = [gr.cpu() for gr in torch.autograd.grad(loss, x)]
        if where == "card":
            assert tiled_adjoint.tracer_launches == 2
    for name, a, b in zip(TRACER_FIELDS, grads["card"], grads["cpu"]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-11, name
    model64, st64 = _lattice(False, cuda)
    sm64 = model64.struct_mesh
    stack, kt, end = tracer_stack(st64, sm64, 10.0, 2, 5.0, 0.5)
    g = _cotangent(st64)
    first = tuple(x[:1].contiguous() for x in stack)
    out = tracer_reverse(first, kt._replace(planes=kt.planes[:1].contiguous()), end, g, sm64,
                         10.0, 1, tile=(4, 8), q=2)
    ref = plain_tracer_reverse(stack, kt, end, g, sm64, 10.0, 2)
    errs = reverse_errors(out, ref, ddt_scale(st64, sm64, 10.0, 2, g, tracer_kappa=5.0,
                                              tracer_upwind=0.5))
    assert max(errs.values()) <= 1e-12, errs
