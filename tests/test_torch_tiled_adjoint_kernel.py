"""The hand-written tiled adjoint kernel against its plain PyTorch version, on
a CUDA card. These tests skip on machines without one. They import no JAX,
so on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_tiled_adjoint_kernel.py
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu_torch.kernels import fe_step, tiled_adjoint
from mpas_ocean_tpu_torch.structured import (
    StructState,
    diff_model,
    fused_run_loop,
    plain_tiled_adjoint_superstep,
    structured_run_loop,
    tiled_adjoint_rollout,
    tiled_diff,
    tiled_rollout_diff,
)

from torch_gpu_cases import (  # noqa: F401 (fixture)
    FIELDS,
    channel_lattice,
    cuda,
    forced_reverse,
    forced_reverse_errors,
    plain_forced_reverse,
    plain_nl_reverse,
    random_forcing,
    random_lattice,
    reversed_terms_mesh,
)

pytestmark = pytest.mark.gpu

DT = 10.0


def _cotangent(state, seed):
    rng = np.random.default_rng(seed)
    return StructState(*(
        torch.from_numpy(rng.normal(size=tuple(getattr(state, f).shape))).to(
            getattr(state, f).device)
        for f in FIELDS))


def _plain_reverse(st, sm, n, g, rt, ct, q):
    """The plain superstep back through the superstep-start states that the
    forward kernel gives (which the kernel sweep rebuilds bit for bit)."""
    starts = [st]
    for _ in range(n // q - 1):
        starts.append(fused_run_loop(starts[-1], sm, DT, q))
    ddt = 0.0
    for s in reversed(starts):
        g, dd = plain_tiled_adjoint_superstep(s, g, sm, DT, rt, ct, q)
        ddt += float(dd)
    return g, ddt


@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("shape, tile", [
    ((16, 16, 4), (8, 16)),   # one tile, its window wraps onto itself
    ((16, 16, 4), (2, 4)),
    ((64, 64, 4), (1, 8)),
    ((64, 64, 4), (4, 4)),
    ((64, 64, 4), (8, 16)),
    ((64, 64, 4), (16, 2)),
    ((10, 12, 33), (3, 5)),   # 33 levels: q = 1 in 5 chunks of 8, q = 2 in 7 of 5
    ((64, 64, 4), (4, 8)),    # the planner's tile at 100 f32 levels
])
def test_kernel_matches_plain_f64(cuda, shape, tile, q):
    """6 steps, f64: the kernel sweep and the plain superstep on the same
    primal states differ only in summation order, so 1e-12 of each field's
    magnitude and of d(dt); a rerun gives the same bits (no atomics)."""
    model, st = random_lattice(*shape, cuda)
    sm = model.struct_mesh
    rt, ct = tile
    n = 6
    g = _cotangent(st, 3)
    out, ddt = tiled_adjoint_rollout(st, sm, DT, n, g, plan=(rt, ct, q, 2))
    again, ddt_again = tiled_adjoint_rollout(st, sm, DT, n, g, plan=(rt, ct, q, 2))
    ref, ref_dt = _plain_reverse(st, sm, n, g, rt, ct, q)
    torch.cuda.synchronize()
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert a.shape == b.shape and a.dtype == torch.float64 and a.device.type == "cuda"
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-12, (f, err)
        assert torch.equal(a, getattr(again, f)), f
    assert abs(float(ddt) - ref_dt) <= 1e-12 * abs(ref_dt)
    assert torch.equal(ddt, ddt_again)


@pytest.mark.parametrize("shape, tile", [((32, 32, 100), (4, 8)), ((16, 16, 100), (2, 8))])
def test_kernel_matches_plain_f64_at_full_depth(cuda, shape, tile):
    """q = 1 at 100 levels, f64: 7 chunks of 16 levels (the last of 4)
    moved by 16-byte copies; 3 reverse steps against the plain superstep,
    1e-12 of each field's magnitude and of d(dt), bitwise reruns."""
    model, st = random_lattice(*shape, cuda)
    sm = model.struct_mesh
    g = _cotangent(st, 10)
    plan = (*tile, 1, 3)
    out, ddt = tiled_adjoint_rollout(st, sm, DT, 3, g, plan=plan)
    again, ddt_again = tiled_adjoint_rollout(st, sm, DT, 3, g, plan=plan)
    ref, ref_dt = _plain_reverse(st, sm, 3, g, *tile, 1)
    torch.cuda.synchronize()
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-12, f
        assert torch.equal(a, getattr(again, f)), f
    assert abs(float(ddt) - ref_dt) <= 1e-12 * abs(ref_dt)
    assert torch.equal(ddt, ddt_again)


def test_occupancy_matches_the_wrappers_reckoning(cuda):
    """The kernel's own shared memory per block is what
    tiled_adjoint.smem_bytes reckons, at q = 1 and 2; the planner's plan at
    100 f32 levels puts two blocks on an SM."""
    halo = (1, 2)
    for rt, ct, q, k in ((4, 8, 1, 100), (2, 4, 2, 100), (3, 5, 2, 33), (8, 16, 1, 4)):
        smem, per_sm = tiled_adjoint.occupancy(rt, ct, q, halo, k)
        assert smem == tiled_adjoint.smem_bytes(tiled_adjoint.window_sites(rt, ct, q, halo),
                                                rt * ct, k, q, 4)
        if (rt, ct, q, k) == (4, 8, 1, 100):
            assert per_sm == 2
    assert tiled_diff.tiled_adjoint_plan(128, 256, 100, 4, 100, halo=halo)[:3] == (4, 8, 1)


@pytest.mark.parametrize("q", [1, 2])
def test_kernel_refuses_a_table_that_does_not_map(cuda, q):
    """The same stencil with each channel's terms in reverse order maps
    neither as hex:: nor as hex_adj:: lists it: the wrapper raises
    ValueError for either table."""
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    bad = reversed_terms_mesh(sm)
    stack = tuple(getattr(st, f)[None] for f in FIELDS)
    g_in = tuple(getattr(_cotangent(st, 9), f) for f in FIELDS)
    ddt = torch.zeros(1, dtype=torch.float64, device=cuda)
    consts = (sm.f_edge, sm.resting_thickness_sum)
    run = lambda fwd, adj: tiled_adjoint.tiled_adjoint_rollout(
        stack, g_in, *consts, *fwd, *adj, DT, 1e-3, 1e-3, 1, ddt, row_tile=4, col_tile=8,
        q=q, halo=(1, 2))
    run(sm.host_stencil, sm.host_adjoint_stencil)
    for fwd, adj in ((sm.host_stencil, bad.host_adjoint_stencil),
                     (bad.host_stencil, sm.host_adjoint_stencil)):
        with pytest.raises(ValueError, match="hex lattice"):
            run(fwd, adj)


@pytest.mark.parametrize("q", [1, 2])
def test_launch_counts(cuda, q):
    """n = 12 in groups of 2 supersteps: tiled_adjoint n / q launches;
    fe_step n forward launches and q per rebuilt superstep; the inputs are
    left as they are."""
    model, st = random_lattice(16, 16, 4, cuda)
    g = _cotangent(st, 4)
    before = [getattr(x, f).clone() for x in (st, g) for f in FIELDS]
    fe_step.launches = tiled_adjoint.launches = 0
    tiled_adjoint_rollout(st, model.struct_mesh, DT, 12, g, plan=(4, 8, q, 2))
    n_ss = 12 // q
    n_groups = -(-n_ss // 2)
    assert tiled_adjoint.launches == n_ss
    assert fe_step.launches == 12 + q * (n_ss - n_groups)
    after = [getattr(x, f) for x in (st, g) for f in FIELDS]
    for x, y in zip(before, after):
        assert torch.equal(x, y)


def test_kernel_passes_the_dot_product_identity(cuda):
    """<J v, g> = <v, J^T g> for J the Jacobian of the 7-step rollout, f64:
    J v by forward-mode AD of the plain rollout, J^T g by the kernels."""
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    n = 7
    v, g = _cotangent(st, 5), _cotangent(st, 6)

    def rollout(*fields):
        out = structured_run_loop(StructState(*fields), sm, DT, n)
        return tuple(getattr(out, f) for f in FIELDS)

    _, jv = torch.func.jvp(rollout, tuple(getattr(st, f) for f in FIELDS),
                           tuple(getattr(v, f) for f in FIELDS))
    lhs = sum(float((x * getattr(g, f)).sum()) for x, f in zip(jv, FIELDS))
    d, _ = tiled_adjoint_rollout(st, sm, DT, n, g, plan=(2, 4, 1, 3))
    rhs = sum(float((getattr(v, f) * getattr(d, f)).sum()) for f in FIELDS)
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


def test_tiled_rollout_diff_forward_is_the_fused_run_loop_bitwise(cuda):
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    out = tiled_rollout_diff(st, sm, DT, 8, plan=(4, 8, 2, 2))
    ref = fused_run_loop(st, sm, DT, 8)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(ref, f))


def test_cuda_state_never_runs_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA state reached a plain version")

    monkeypatch.setattr(tiled_diff, "plain_tiled_adjoint_superstep", refuse)
    monkeypatch.setattr(diff_model, "structured_run_loop", refuse)
    monkeypatch.setattr(diff_model, "structured_step", refuse)
    model, st = random_lattice(16, 16, 4, cuda)
    x = [getattr(st, f).clone().requires_grad_(True) for f in FIELDS]
    tiled_adjoint.launches = 0
    out = tiled_rollout_diff(StructState(*x), model.struct_mesh, DT, 6, plan=(4, 8, 2, 2))
    torch.autograd.grad((out.ssh ** 2).sum(), x)
    torch.cuda.synchronize()
    assert tiled_adjoint.launches == 3


def test_kernel_rejects_what_it_does_not_take(cuda):
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    g = _cotangent(st, 7)
    stack = tuple(getattr(st, f)[None] for f in FIELDS)
    ddt = torch.zeros(1, dtype=torch.float64, device=cuda)
    args = (sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil, *sm.host_adjoint_stencil,
            DT, 1e-3, 1e-3, 1, ddt)
    g_in = tuple(getattr(g, f) for f in FIELDS)
    with pytest.raises(ValueError, match="shared memory"):
        tiled_adjoint.tiled_adjoint_rollout(stack, g_in, *args, row_tile=8, col_tile=16,
                                            q=8, halo=(1, 2))
    with pytest.raises(ValueError, match="divide"):
        tiled_adjoint.tiled_adjoint_rollout(stack, g_in, *args, row_tile=3, col_tile=4,
                                            q=1, halo=(1, 2))
    with pytest.raises(ValueError):
        tiled_adjoint.tiled_adjoint_rollout(
            stack, (g.ssh, g.layer_thickness[..., :-1], g.normal_velocity), *args,
            row_tile=2, col_tile=4, q=1, halo=(1, 2))


@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("shape, tile", [
    ((16, 16, 4), (2, 4)),
    ((64, 64, 4), (4, 8)),    # the planner's tile at 100 f32 levels
    ((64, 64, 4), (8, 16)),
    ((12, 16, 33), (2, 4)),   # 33 levels; the walls cut through the windows
])
def test_masked_kernel_matches_plain_f64(cuda, shape, tile, q):
    """tiled_adjoint's masked arm on a coastal channel, 6 steps, f64: the
    kernel sweep and the plain masked superstep on the same primal states
    differ only in summation order, so 1e-12 of each field's magnitude and
    of d(dt); a rerun gives the same bits. At q = 2 the recompute runs the
    forward mask and the middle cotangent is folded again."""
    model, st = channel_lattice(*shape, cuda)
    sm = model.struct_mesh
    rt, ct = tile
    n = 6
    g = _cotangent(st, 4)
    out, ddt = tiled_adjoint_rollout(st, sm, DT, n, g, plan=(rt, ct, q, 2))
    again, ddt_again = tiled_adjoint_rollout(st, sm, DT, n, g, plan=(rt, ct, q, 2))
    ref, ref_dt = _plain_reverse(st, sm, n, g, rt, ct, q)
    torch.cuda.synchronize()
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-12, (f, err)
        assert torch.equal(a, getattr(again, f)), f
    assert abs(float(ddt) - ref_dt) <= 1e-12 * abs(ref_dt)
    assert torch.equal(ddt, ddt_again)


# ---- the nonlinear tiled reverse: the nonlinear reverse kernel at q = 1 -------

@pytest.mark.parametrize("case", ["periodic", "channel"])
@pytest.mark.parametrize("plan", [(8, 16, 1, 2), (2, 4, 1, 3), (4, 8, 1, 2)])
def test_nonlinear_tiled_reverse_matches_plain_f64(cuda, case, plan):
    """tiled_adjoint_rollout(nonlinear=True) at q = 1 over tiles that divide
    the lattice (one tile whose window wraps onto itself; 16 and 8 tiles),
    f64, 6 steps: against the plain superstep (the VJP of slab.window_steps
    with the vertex constants) back through the forward kernel's states,
    and against the plain nonlinear reverse step, 1e-12 of scale and of
    d(dt); tiled_rollout_diff's forward is fused_run_loop's bit for bit; at
    q = 2 the same plan's tiles run the q-step nonlinear reverse, n / 2
    launches, within 1e-12 of the q = 1 result's scale and d(dt)."""
    from mpas_ocean_tpu_torch.kernels import adjoint_step

    lattice = random_lattice if case == "periodic" else channel_lattice
    model, st = lattice(16, 16, 4, cuda, u_amp=0.5)
    sm = model.struct_mesh
    g = _cotangent(st, 6)
    n = 6
    adjoint_step.nl_launches = tiled_adjoint.launches = 0
    out, ddt = tiled_adjoint_rollout(st, sm, DT, n, g, plan=plan, nonlinear=True)
    assert (adjoint_step.nl_launches, tiled_adjoint.launches) == (n, 0)
    states = [st]
    for _ in range(n - 1):
        states.append(fused_run_loop(states[-1], sm, DT, 1, nonlinear=True))
    ref, ref_dt = g, 0.0
    for s in reversed(states):
        ref, dd = plain_tiled_adjoint_superstep(s, ref, sm, DT, *plan[:3], nonlinear=True)
        ref_dt += float(dd)
    stack = tuple(torch.stack([getattr(s, f) for s in states]) for f in FIELDS)
    step_ref, step_dt = plain_nl_reverse(stack, g, sm, DT, n)
    torch.cuda.synchronize()
    for f in FIELDS:
        for want in (ref, step_ref):
            a, b = getattr(out, f), getattr(want, f)
            assert float((a - b).abs().max() / b.abs().max()) <= 1e-12, f
    assert abs(float(ddt) - ref_dt) <= 1e-12 * abs(ref_dt)
    assert abs(float(ddt) - float(step_dt)) <= 1e-12 * abs(float(step_dt))
    fwd = tiled_rollout_diff(st, sm, DT, n, plan=plan, nonlinear=True)
    want = fused_run_loop(st, sm, DT, n, nonlinear=True)
    assert all(torch.equal(getattr(fwd, f), getattr(want, f)) for f in FIELDS)
    adjoint_step.nl_window_launches = 0
    out2, ddt2 = tiled_adjoint_rollout(st, sm, DT, n, g, plan=(plan[0], plan[1], 2, 1),
                                       nonlinear=True)
    assert adjoint_step.nl_window_launches == n // 2
    for f in FIELDS:
        a, b = getattr(out2, f), getattr(out, f)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-12, f
    assert abs(float(ddt2) - float(ddt)) <= 1e-12 * abs(float(ddt))


# ---- the forced arm (momentum forcing) --------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("q, tile", [(1, (4, 8)), (2, (4, 8)), (2, (2, 16)), (1, (8, 16))])
def test_forced_kernel_matches_plain_f64(cuda, masked, q, tile):
    """tiled_adjoint's forced arm at q = 1 and 2 against its plain version
    with forcing (plain_tiled_adjoint_superstep, the vjp of the forced
    windows) through the same superstep starts, 3 supersteps on 64 x 64 x 4,
    f64: d_ssh, d_h, d_u, d(dt), d(wind) and d(r_lin, Cd, lambda) within
    1e-12 of their scales; a rerun bitwise equal; the unforced arm at least
    100x that limit away."""
    model, st = (channel_lattice if masked else random_lattice)(64, 64, 4, cuda)
    sm = model.struct_mesh
    forcing = random_forcing(model)
    n = 3
    starts = [st]
    for _ in range(n - 1):
        starts.append(fused_run_loop(starts[-1], sm, DT, q, forcing=forcing))
    stack = tuple(torch.stack([getattr(s, f) for s in starts]) for f in FIELDS)
    g = _cotangent(st, 5)
    plan = (*tile, q)
    out = forced_reverse(stack, g, sm, DT, n, forcing, plan)
    again = forced_reverse(stack, g, sm, DT, n, forcing, plan)
    ref = plain_forced_reverse(stack, g, sm, DT, n, forcing, plan)
    control = forced_reverse(stack, g, sm, DT, n, None, plan)
    torch.cuda.synchronize()
    errs = forced_reverse_errors(out, ref)
    assert max(errs.values()) <= 1e-12, errs
    miss = forced_reverse_errors(control, ref)
    assert max(miss[f] for f in FIELDS) >= 100 * 1e-12, miss
    for f in FIELDS:
        assert torch.equal(getattr(out[0], f), getattr(again[0], f)), f
    for a, b in zip(out[1:], again[1:]):
        assert torch.equal(a, b)
