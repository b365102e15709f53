"""The stratified arms of the hand-written reverse kernels (adjoint_step, and
tiled_adjoint at q = 1 and q = 2) and of fe_step's stack entry against their plain
PyTorch versions, on a CUDA card, and the gradient entry points with strat=
on the card against the same on the CPU. These tests skip on machines
without a card. They import no JAX, so on a GPU machine without JAX they run
with

    python -m pytest --noconftest -m gpu tests/test_torch_strat_adjoint_kernel.py
"""

import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
from mpas_ocean_tpu_torch.models import Stratification
from mpas_ocean_tpu_torch.structured import (
    StructState,
    auto_rollout_diff,
    fused_model,
    fused_rollout_diff,
    structured_run_loop,
    tiled_adjoint_plan,
    tiled_rollout_diff,
)
from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo

from torch_gpu_cases import (  # noqa: F401 (fixture)
    FIELDS,
    channel_lattice,
    cuda,
    integer_strat_case,
    plain_strat_reverse,
    random_forcing,
    random_lattice,
    strat_ddt_scale,
    strat_reverse,
    strat_reverse_errors,
    strat_stack,
    stratification,
    wave_lattice,
    with_tracers,
)

pytestmark = pytest.mark.gpu

N = 6
DT = 10.0


def _lattice(masked, n, k, device, dtype=np.float64):
    """A random n x n lattice (or channel) of k 10 m levels at 10 km
    spacing, u of 0.5 m/s."""
    return (channel_lattice if masked else random_lattice)(n, n, k, device, seed=9, dc=1e4,
                                                           dtype=dtype, u_amp=0.5)


def _cotangent(st, seed=11):
    rng = np.random.default_rng(seed)
    return StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(st, f).shape))).to(
        getattr(st, f)) for f in FIELDS))


def _tile(arm, mesh, k, itemsize, n_steps=N):
    """None for adjoint_step (its planner's tile); the stratified tiled
    plan's tile for tiled_adjoint."""
    if arm == "adjoint_step":
        return None
    return tiled_adjoint_plan(mesh.ny2, mesh.nx, k, itemsize, n_steps,
                              halo=reverse_halo(mesh.coriolis_terms), strat=True)[:2]


@pytest.mark.parametrize("kind", ["rho", "dense"])
@pytest.mark.parametrize("n, k", [(16, 4), (64, 36), (64, 100)])
@pytest.mark.parametrize("arm", ["adjoint_step", "tiled_adjoint"])
@pytest.mark.parametrize("masked", [False, True])
def test_strat_reverse_matches_plain_f64(cuda, masked, arm, n, k, kind):
    """6 reverse steps through the kernel-built stack of a random n x n x k
    f64 state, make_stratification's W and a dense random one: the
    cotangent within 1e-12 of each field's scale of the plain reverse on the
    same primal states, d(dt) and d(W) within 1e-12 of their Cauchy-Schwarz
    scales; a rerun bitwise equal; every launch counted as a stratified
    launch; the unstratified arm on the same states at least 100x off in
    d_h."""
    model, st = _lattice(masked, n, k, cuda)
    mesh, strat = model.struct_mesh, stratification(k, kind)
    stack, w, _ = strat_stack(st, mesh, DT, N, strat)
    g = _cotangent(st)
    tile = _tile(arm, mesh, k, 8)
    mod = adjoint_step if tile is None else tiled_adjoint
    mod.launches = mod.strat_launches = 0
    out = strat_reverse(stack, w, g, mesh, DT, N, tile)
    again = strat_reverse(stack, w, g, mesh, DT, N, tile)
    assert (mod.launches, mod.strat_launches) == (2 * N, 2 * N)
    ref, w_scale, _ = plain_strat_reverse(stack, w, g, mesh, DT, N)
    st0 = StructState(*(x[0] for x in stack))
    errs = strat_reverse_errors(out, ref, strat_ddt_scale(st0, mesh, DT, N, g, strat), w_scale)
    assert max(r for _, r in errs.values()) <= 1e-12, errs
    assert torch.equal(out[1], again[1]) and torch.equal(out[2], again[2]) and all(
        torch.equal(getattr(out[0], f), getattr(again[0], f)) for f in FIELDS)
    bare = strat_reverse(stack, w, g, mesh, DT, N, tile, strat=False)
    miss = float((bare[0].layer_thickness - ref[0].layer_thickness).abs().max()
                 / ref[0].layer_thickness.abs().max())
    assert miss >= 100 * 1e-12, miss


@pytest.mark.parametrize("masked", [False, True])
def test_strat_stack_is_the_forward_bitwise(cuda, masked):
    """fe_fill_stack's stratified arm fills slot j with what
    fe_rollout_into's j stratified steps give, bit for bit (the reverse's
    primal states are the forward path's own), at 36 levels."""
    model, st = _lattice(masked, 32, 36, cuda)
    mesh = model.struct_mesh
    stack, w, end = strat_stack(st, mesh, DT, N, stratification(36, "dense"))
    dtype = st.layer_thickness.dtype
    consts = (mesh.f_edge.to(dtype).contiguous(), mesh.resting_thickness_sum.to(dtype).contiguous(),
              *mesh.host_stencil, *fused_model._scal(mesh, DT, dtype))
    src = tuple(x[0] for x in stack)
    for j in range(1, N + 1):
        out = tuple(torch.empty_like(x) for x in src)
        fe_step.fe_rollout_into(src, out, *consts, j, live=fused_model.kernel_live(mesh),
                                strat_w=w)
        want = end if j == N else tuple(x[j] for x in stack)
        assert all(torch.equal(a, b) for a, b in zip(out, want)), j


ROUTES = {
    "auto_rollout_diff": lambda st, sm, dt, n, strat: auto_rollout_diff(st, sm, dt, n, plan=3,
                                                                       strat=strat),
    "fused_rollout_diff": lambda st, sm, dt, n, strat: fused_rollout_diff(st, sm, dt, n,
                                                                         strat=strat),
    "tiled_rollout_diff": lambda st, sm, dt, n, strat: tiled_rollout_diff(st, sm, dt, n,
                                                                         plan=(4, 8, 1, 3),
                                                                         strat=strat),
}


@pytest.mark.parametrize("route", ["fused_rollout_diff", "tiled_rollout_diff"])
def test_dot_product_identity_with_a_direction_in_w(cuda, route):
    """<J v, g> = <v, J^T g> over 7 stratified steps at f64 on a 32 x 32 x 6
    lattice, v a random direction in the state and in W, J v by
    forward-mode AD of the plain rollout and J^T g through the route's
    kernels: within 1e-12 relative."""
    model, st = _lattice(False, 32, 6, cuda)
    sm, base = model.struct_mesh, stratification(6, "dense")
    v, gbar = _cotangent(st, 18), _cotangent(st, 19)
    v_w = torch.from_numpy(0.05 * np.random.default_rng(20).normal(size=(6, 6))).to(cuda)

    def rollout7(*xs):
        out = structured_run_loop(StructState(*xs[:3]), sm, DT, 7,
                                  strat=Stratification(xs[3], base.densities))
        return tuple(getattr(out, f) for f in FIELDS)

    w0 = base.phi_weights.to(cuda)
    _, jv = torch.func.jvp(rollout7, (*(getattr(st, f) for f in FIELDS), w0),
                           (*(getattr(v, f) for f in FIELDS), v_w))
    lhs = sum(float((x * getattr(gbar, f)).sum()) for x, f in zip(jv, FIELDS))
    x = [getattr(st, f).clone().requires_grad_(True) for f in FIELDS]
    w = w0.clone().requires_grad_(True)
    out = ROUTES[route](StructState(*x), sm, DT, 7, Stratification(w, base.densities))
    inner = sum((getattr(out, f) * getattr(gbar, f)).sum() for f in FIELDS)
    jtg = torch.autograd.grad(inner, x + [w])
    rhs = sum(float((getattr(v, f) * d).sum()) for f, d in zip(FIELDS, jtg))
    rhs += float((v_w * jtg[3]).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs), (lhs, rhs)


@pytest.mark.parametrize("arm", ["adjoint_step", "tiled_adjoint"])
def test_strat_reverse_f32_at_full_depth(cuda, arm):
    """bench.py's baroclinic cell in reverse: the 64 x 64 x 100 f32 IGW with
    densities 1025 + linspace(0, 1, 100), 100 reverse steps from the
    cotangent of sum ssh^2 through the kernel-built stack: each cotangent's
    distance from an f64 plain reverse of the same f32 states within 3x the
    plain f32 reverse's (PERF.md section 2's rule); the plain reverse with
    its cotangent stored in bf16 after each step misses that bound in some
    cotangent."""
    model, st = wave_lattice("igw", 64, 100, cuda)
    mesh, n = model.struct_mesh, 100
    strat = mt.make_stratification(1025.0 + np.linspace(0.0, 1.0, 100), dtype=np.float32)
    stack, w, end = strat_stack(st, mesh, 30.0, n, strat)
    g = StructState(2 * end[0], torch.zeros_like(end[1]), torch.zeros_like(end[2]))
    out = strat_reverse(stack, w, g, mesh, 30.0, n, _tile(arm, mesh, 100, 4, n))
    ref64, w_scale, _ = plain_strat_reverse(stack, w, g, mesh, 30.0, n, dtype=torch.float64)
    p32, _, _ = plain_strat_reverse(stack, w, g, mesh, 30.0, n)
    bf, _, _ = plain_strat_reverse(stack, w, g, mesh, 30.0, n,
                                   store=lambda x: x.bfloat16().float())
    st0 = StructState(*(x[0] for x in stack))
    scales = {f: float(getattr(ref64[0], f).abs().max()) for f in FIELDS}
    scales["d_dt"] = strat_ddt_scale(st0, mesh, 30.0, n, g, strat)
    scales["d_w"] = w_scale
    e_k, e_p, e_b = (strat_reverse_errors(x, ref64, scales["d_dt"], w_scale)
                     for x in (out, p32, bf))
    control_fails = False
    for f, (e, _) in e_k.items():
        limit = 3 * e_p[f][0]
        assert e <= limit, (f, e, e_p[f][0], limit)
        control_fails = control_fails or e_b[f][0] > limit
    assert control_fails


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("arm", ["adjoint_step", "tiled_adjoint"])
def test_strat_reverse_f32_sums_dw_in_double(cuda, arm, n):
    """One f32 reverse step at 100 levels on integer data whose d(W) sums are
    exact in double (integer_strat_case): the arm's d(W) is bitwise the
    plain f64 reverse's, and the plain f32 reverse's sums over the cells in
    float (the control) are not."""
    mesh, stack, g = integer_strat_case(n, 100, cuda)
    strat = mt.make_stratification(1025.0 + np.linspace(0.0, 1.0, 100), dtype=np.float32)
    w = fused_model.kernel_strat(strat, torch.float32, cuda)
    (_, _, exact), _, _ = plain_strat_reverse(stack, w, g, mesh, 1.0, 1, dtype=torch.float64)
    _, _, dw_float = plain_strat_reverse(stack, w, g, mesh, 1.0, 1)
    assert not torch.equal(dw_float, exact)
    _, _, dw = strat_reverse(stack, w, g, mesh, 1.0, 1, _tile(arm, mesh, 100, 4, 1))
    assert torch.equal(dw, exact), float((dw - exact).abs().max())


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("masked", [False, True])
def test_strat_gradients_on_the_card_match_the_cpu(cuda, masked, route):
    """grad of sum ssh^2 over 7 steps w.r.t. the state, dt and W through each
    gradient route on the card (the kernels' stratified arms) against the
    same route on the CPU (the plain steps), f64, a dense W on 32 x 32 x 6:
    within 1e-11 of each field's scale."""
    grads = {}
    for where, device in (("card", cuda), ("cpu", torch.device("cpu"))):
        model, s = _lattice(masked, 32, 6, device)
        sm, strat = model.struct_mesh, stratification(6, "dense")
        x = [getattr(s, f).clone().requires_grad_(True) for f in FIELDS]
        dt = torch.tensor(DT, dtype=torch.float64, device=device, requires_grad=True)
        w = strat.phi_weights.to(device).requires_grad_(True)
        out = ROUTES[route](StructState(*x), sm, dt, 7, Stratification(w, strat.densities))
        grads[where] = [g.cpu() for g in torch.autograd.grad((out.ssh ** 2).sum(), x + [dt, w])]
    for name, a, b in zip(FIELDS + ("dt", "W"), grads["card"], grads["cpu"]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-11, name


@pytest.mark.parametrize("route", ["auto_rollout_diff", "tiled_rollout_diff"])
def test_strat_grad_launch_counts(cuda, route):
    """A stratified 7-step gradient in groups of 3 makes 7 forward and 4
    rebuild launches of fe_step's stratified arm and 7 of the reverse's,
    every one counted as a stratified launch, and no other kernel launch."""
    model, st = _lattice(False, 32, 6, cuda, np.float32)
    sm, strat = model.struct_mesh, stratification(6, "rho", np.float32)
    mods = (fe_step, adjoint_step, tiled_adjoint)
    for m in mods:
        m.launches = m.strat_launches = 0
    x = [getattr(st, f).clone().requires_grad_(True) for f in FIELDS]
    out = ROUTES[route](StructState(*x), sm, DT, 7, strat)
    torch.autograd.grad((out.ssh ** 2).sum(), x)
    want = {"fe_step": (11, 11), "adjoint_step": (7, 7) if route == "auto_rollout_diff"
            else (0, 0), "tiled_adjoint": (7, 7) if route == "tiled_rollout_diff" else (0, 0)}
    assert {m.__name__.rsplit(".", 1)[-1]: (m.launches, m.strat_launches) for m in mods} == want


def test_card_refuses_the_stratified_reverse_where_no_arm_runs_it(cuda):
    """On the card the stratified gradients run with the nonlinear core,
    with forcing and with tracers (the composed arms: a finite, nonzero
    d(W)), and on the tiled route at q > 1 (tiled_adjoint's stratified arm
    at q > 1): tiled_adjoint's wrapper, two supersteps of q = 2 through the
    stack's slots 0 and 2, within 1e-12 of the plain stratified reverse of
    the four steps (d(dt) and d(W) over their Cauchy-Schwarz scales) in two
    stratified launches, and the q = 2 gradient through tiled_rollout_diff
    a finite, nonzero d(W), with the nonlinear core too (the q-step
    nonlinear reverse's stratified arm, 2 of its launches)."""
    model, st = _lattice(False, 32, 6, cuda, np.float32)
    sm, strat = model.struct_mesh, stratification(6, "rho", np.float32)
    forcing = random_forcing(model)

    def d_w(route, s, **kw):
        w = strat.phi_weights.clone().requires_grad_(True)
        x = [getattr(s, f).clone().requires_grad_(True) for f in FIELDS]
        out = route(StructState(*x, s.tracers), sm, DT, 4,
                    strat=Stratification(w, strat.densities), **kw)
        return torch.autograd.grad((out.ssh ** 2).sum(), [w])[0]

    for route, s, kw in ((fused_rollout_diff, st, dict(nonlinear=True)),
                         (auto_rollout_diff, st, dict(forcing=forcing)),
                         (auto_rollout_diff, with_tracers(model, st), {}),
                         (tiled_rollout_diff, st, dict(plan=(4, 8, 2, 1))),
                         (tiled_rollout_diff, st, dict(plan=(4, 8, 2, 1), nonlinear=True))):
        adjoint_step.nl_window_strat_launches = 0
        dw = d_w(route, s, **kw)
        assert bool(torch.isfinite(dw).all()) and float(dw.abs().max()) > 0
    assert adjoint_step.nl_window_strat_launches == 2
    model64, st64 = _lattice(False, 32, 6, cuda)
    sm64, strat64 = model64.struct_mesh, stratification(6, "dense")
    stack, w, _ = strat_stack(st64, sm64, DT, 4, strat64)
    g = _cotangent(st64)
    sup = tuple(x[0::2].contiguous() for x in stack)
    tiled_adjoint.strat_launches = 0
    out = strat_reverse(sup, w, g, sm64, DT, 2, tile=(4, 8), q=2)
    assert tiled_adjoint.strat_launches == 2
    ref, w_scale, _ = plain_strat_reverse(stack, w, g, sm64, DT, 4)
    errs = strat_reverse_errors(out, ref, strat_ddt_scale(st64, sm64, DT, 4, g, strat64),
                                w_scale)
    assert max(r for _, r in errs.values()) <= 1e-12, errs
