"""The hand-written CUDA reverse-step kernels against their plain PyTorch
versions, on a CUDA card: adjoint_step (linear) and the nonlinear reverse
(csrc/nl_adjoint.cuh; ``-k nonlinear``). These tests skip on machines
without one. They import no JAX, so on a GPU machine without JAX they run
with

    python -m pytest --noconftest -m gpu tests/test_torch_adjoint_kernel.py
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step
from mpas_ocean_tpu_torch.structured import (
    StructState,
    fused_adjoint_rollout,
    fused_rollout_diff,
    fused_run_loop,
    structured_adjoint_run_loop,
    structured_adjoint_step,
    structured_run_loop,
)
from mpas_ocean_tpu_torch.structured.fused_model import _scal

from torch_gpu_cases import (  # noqa: F401 (fixture)
    FIELDS,
    assert_nl_reverse_f32,
    channel_lattice,
    cuda,
    forced_reverse,
    forced_reverse_errors,
    forced_stack,
    linear_reverse,
    nl_reverse,
    nl_stack,
    plain_forced_reverse,
    plain_nl_reverse,
    random_forcing,
    random_lattice,
    reverse_gaps,
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


def _plain_reverse(states, g, sm):
    """The plain adjoint step back through the given primal states."""
    ddt = 0.0
    for s in reversed(states):
        g, dd = structured_adjoint_step(s, g, sm, DT)
        ddt += float(dd)
    return g, ddt


@pytest.mark.parametrize("n_steps", [0, 1, 2, 7])
@pytest.mark.parametrize(
    "shape, dc", [((16, 16, 4), 1e3), ((10, 12, 33), 1e3), ((8, 8, 300), 1e5)]
)
def test_adjoint_kernel_matches_plain_f64(cuda, shape, dc, n_steps):
    """f64: the kernel sweep against the plain adjoint step run back through
    the same primal states (the forward kernel's, which the sweep rebuilds
    bit for bit), so the two differ only in summation order: 1e-12 of each
    field's magnitude, and of d(dt). K = 33 and 300 cover ragged warps and
    k-striding; plan 3 makes n = 7 a 3 + 3 + 1 sweep. Against the plain
    forward's states instead, d(dt) would differ by ~1e-10: it carries the
    pressure gradient of ssh = sum_k h - rts, which the two forwards round
    apart by ~1e-12 of ssh (tests/test_torch_kernel.py)."""
    model, st = random_lattice(*shape, cuda, dc=dc)
    sm = model.struct_mesh
    g = _cotangent(st, 3)
    out, ddt = fused_adjoint_rollout(st, sm, DT, n_steps, g, plan=3)
    states = [st]
    for _ in range(n_steps - 1):
        states.append(fused_run_loop(states[-1], sm, DT, 1))
    ref, ref_dt = _plain_reverse(states if n_steps else [], g, sm)
    torch.cuda.synchronize()
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64
        assert a.device.type == "cuda"
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-12, (f, err)
    if n_steps:
        assert abs(float(ddt) - ref_dt) <= 1e-12 * abs(ref_dt)
    whole, _ = structured_adjoint_run_loop(st, sm, DT, n_steps, g)
    for f in FIELDS:
        a, b = getattr(out, f), getattr(whole, f)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-12, f


@pytest.mark.parametrize("shape, tile", [
    ((16, 16, 4), (4, 8)),     # the planner's tile at 100 f32 levels
    ((16, 16, 4), (3, 5)),     # ragged tiles in both directions
    ((10, 12, 33), (4, 8)),    # ragged rows and columns; 33 levels in chunks of 8, the last of 1
    ((32, 32, 100), (4, 8)),   # 7 chunks of 16 levels, the last of 4; 16-byte copies
    ((8, 8, 4), (4, 8)),       # one tile, its window wraps over the 4 x 8 lattice
])
def test_adjoint_kernel_tiles_match_plain_f64(cuda, shape, tile):
    """f64, 5 reverse steps over the given tile: against the plain adjoint
    step back through the same primal states, 1e-12 of each field's
    magnitude and of d(dt); a rerun gives the same bits; one launch per
    step."""
    model, st = random_lattice(*shape, cuda)
    sm = model.struct_mesh
    g = _cotangent(st, 8)
    n = 5
    stack = tuple(torch.empty((n, *getattr(st, f).shape), dtype=torch.float64, device=cuda)
                  for f in FIELDS)
    states = [st]
    for _ in range(n - 1):
        states.append(fused_run_loop(states[-1], sm, DT, 1))
    for j, s in enumerate(states):
        for dst, f in zip(stack, FIELDS):
            dst[j].copy_(getattr(s, f))
    scal = _scal(sm, DT, torch.float64)

    def run():
        ddt = torch.zeros(1, dtype=torch.float64, device=cuda)
        out = adjoint_step._rollout(stack, tuple(getattr(g, f) for f in FIELDS), sm.f_edge,
                                    *sm.host_adjoint_stencil, scal, n, ddt, None, None, tile)
        return out, ddt

    adjoint_step.launches = 0
    (out, ddt), (again, ddt_again) = run(), run()
    assert adjoint_step.launches == 2 * n
    ref, ref_dt = _plain_reverse(states, g, sm)
    torch.cuda.synchronize()
    for x, y, z, f in zip(out, again, (ref.ssh, ref.layer_thickness, ref.normal_velocity),
                          FIELDS):
        assert float((x - z).abs().max() / z.abs().max()) <= 1e-12, f
        assert torch.equal(x, y), f
    assert abs(float(ddt) - ref_dt) <= 1e-12 * abs(ref_dt)
    assert torch.equal(ddt, ddt_again)


def test_adjoint_kernel_plan_matches_the_wrappers_reckoning(cuda):
    """The kernel's own shared memory per block for the planner's tile is
    what adjoint_step.smem_bytes reckons, and at 100 f32 levels two blocks
    share an SM: (4, 8) at 64x64, (4, 12) at 256x256."""
    model, st = random_lattice(64, 64, 4, cuda)
    table = model.struct_mesh.host_adjoint_stencil[0]
    for ny2, nx, k in ((32, 64, 100), (128, 256, 100), (32, 64, 33)):
        tile = adjoint_step.adjoint_tile(ny2, nx, k, 4)
        plan = adjoint_step.launch_plan(table, ny2, nx, k, tile)
        assert plan["smem_bytes"] == adjoint_step.smem_bytes(tile, k, 4)
        assert plan["clusters"] == -(-ny2 // tile[0]) * -(-nx // tile[1])
        if k == 100:
            assert tile == ((4, 8) if nx == 64 else (4, 12)) and plan["blocks_per_sm"] == 2


def test_adjoint_kernel_refuses_a_table_that_does_not_map(cuda):
    """The same stencil with each channel's terms in reverse order does not
    map as hex_adj:: lists it: the wrapper raises ValueError."""
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    stack = tuple(getattr(st, f)[None] for f in FIELDS)
    g_in = tuple(getattr(_cotangent(st, 9), f) for f in FIELDS)
    ddt = torch.zeros(1, dtype=torch.float64, device=cuda)
    args = (DT, 1e-3, 1e-3, 1, ddt)
    adjoint_step.adjoint_rollout(stack, g_in, sm.f_edge, *sm.host_adjoint_stencil, *args)
    with pytest.raises(ValueError, match="hex lattice"):
        adjoint_step.adjoint_rollout(stack, g_in, sm.f_edge,
                                     *reversed_terms_mesh(sm).host_adjoint_stencil, *args)


def test_adjoint_kernel_counts_launches_and_repeats_bitwise(cuda):
    """n = 7 in groups of 3: 7 forward launches, 2 + 2 + 0 rebuild
    launches, 7 adjoint launches; an f64 rerun gives the same bits (no
    atomics)."""
    model, st = random_lattice(16, 16, 4, cuda)
    g = _cotangent(st, 4)
    before = [getattr(st, f).clone() for f in FIELDS] + [getattr(g, f).clone() for f in FIELDS]
    fe_step.launches = adjoint_step.launches = 0
    a, a_dt = fused_adjoint_rollout(st, model.struct_mesh, DT, 7, g, plan=3)
    assert (fe_step.launches, adjoint_step.launches) == (11, 7)
    b, b_dt = fused_adjoint_rollout(st, model.struct_mesh, DT, 7, g, plan=3)
    assert torch.equal(a_dt, b_dt)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f))
    after = [getattr(st, f) for f in FIELDS] + [getattr(g, f) for f in FIELDS]
    for x, y in zip(before, after):
        assert torch.equal(x, y)


def test_adjoint_kernel_passes_the_dot_product_identity(cuda):
    """<J v, g> = <v, J^T g> for J the Jacobian of the 7-step rollout, f64:
    J v by forward-mode AD (torch.func.jvp) of the plain rollout, which the
    kernel rollout matches to 1e-12, and J^T g by the kernels."""
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    n = 7
    v = _cotangent(st, 5)
    g = _cotangent(st, 6)

    def rollout(*fields):
        out = structured_run_loop(StructState(*fields), sm, DT, n)
        return tuple(getattr(out, f) for f in FIELDS)

    _, jv = torch.func.jvp(rollout, tuple(getattr(st, f) for f in FIELDS),
                           tuple(getattr(v, f) for f in FIELDS))
    lhs = sum(float((x * getattr(g, f)).sum()) for x, f in zip(jv, FIELDS))
    d, _ = fused_adjoint_rollout(st, sm, DT, n, g)
    rhs = sum(float((getattr(v, f) * getattr(d, f)).sum()) for f in FIELDS)
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


def test_rollout_diff_forward_is_the_fused_run_loop_bitwise(cuda):
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    out = fused_rollout_diff(st, sm, DT, 9, plan=4)
    ref = fused_run_loop(st, sm, DT, 9)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(ref, f))


def test_adjoint_kernel_rejects_what_it_does_not_take(cuda):
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    g = _cotangent(st, 7)
    with pytest.raises(TypeError):
        half = StructState(*(getattr(st, f).half() for f in FIELDS))
        fused_adjoint_rollout(half, sm, DT, 1, g)
    stack = tuple(getattr(st, f)[None] for f in FIELDS)
    ddt = torch.zeros(1, dtype=torch.float64, device=cuda)
    args = (sm.f_edge, *sm.host_adjoint_stencil, DT, 1e-3, 1e-3, 1, ddt)
    with pytest.raises(ValueError):
        bad = (stack[0], stack[1], stack[2][:, :, :, :, :-1])
        adjoint_step.adjoint_rollout(bad, tuple(getattr(g, f) for f in FIELDS), *args)
    with pytest.raises(ValueError):
        adjoint_step.adjoint_rollout(stack, (g.ssh, g.layer_thickness[..., :-1],
                                             g.normal_velocity), *args)
    with pytest.raises(ValueError):
        adjoint_step.adjoint_rollout(stack, tuple(getattr(g, f) for f in FIELDS),
                                     *args[:6], 2, ddt)


@pytest.mark.parametrize("n_steps", [1, 7])
@pytest.mark.parametrize("shape", [(16, 16, 4), (12, 16, 33), (32, 32, 100)])
def test_masked_adjoint_kernel_matches_plain_f64(cuda, shape, n_steps):
    """adjoint_step's masked arm on a coastal channel, f64: against the
    plain masked adjoint step back through the same primal states (the
    masked forward kernel's), 1e-12 of each field's magnitude and of d(dt);
    a rerun bitwise equal."""
    model, st = channel_lattice(*shape, cuda)
    sm = model.struct_mesh
    g = _cotangent(st, 5)
    out, ddt = fused_adjoint_rollout(st, sm, DT, n_steps, g, plan=3)
    again, ddt_again = fused_adjoint_rollout(st, sm, DT, n_steps, g, plan=3)
    states = [st]
    for _ in range(n_steps - 1):
        states.append(fused_run_loop(states[-1], sm, DT, 1))
    ref, ref_dt = _plain_reverse(states, g, sm)
    torch.cuda.synchronize()
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-12, (f, err)
        assert torch.equal(a, getattr(again, f)), f
    assert abs(float(ddt) - ref_dt) <= 1e-12 * abs(ref_dt)
    assert torch.equal(ddt, ddt_again)


def test_masked_adjoint_kernel_passes_the_dot_product_identity(cuda):
    """<J v, g> = <v, J^T g> on a 16x16x4 coastal channel over 7 steps, f64,
    J^T g by fused_rollout_diff's kernels (fe_step's and adjoint_step's
    masked arms), J v by forward-mode AD of the plain masked rollout: 1e-12
    relative."""
    model, st = channel_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    v, g = _cotangent(st, 12), _cotangent(st, 14)
    fields = lambda s: tuple(getattr(s, f) for f in FIELDS)
    _, jv = torch.func.jvp(
        lambda *xs: fields(structured_run_loop(StructState(*xs), sm, DT, 7)),
        fields(st), fields(v))
    lhs = sum(float((x * y).sum()) for x, y in zip(jv, fields(g)))
    leaves = [x.clone().requires_grad_(True) for x in fields(st)]
    out = fused_rollout_diff(StructState(*leaves), sm, DT, 7)
    jtg = torch.autograd.grad(fields(out), leaves, fields(g))
    rhs = sum(float((x * y).sum()) for x, y in zip(fields(v), jtg))
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


# ---- the nonlinear reverse (csrc/nl_adjoint.cuh) ---------------------------------

def _nl_lattice(case, shape, device, dtype=np.float64, seed=7, dc=1000.0):
    lattice = random_lattice if case == "periodic" else channel_lattice
    return lattice(*shape, device, seed=seed, dc=dc, dtype=dtype, u_amp=0.5)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("case", ["periodic", "channel"])
@pytest.mark.parametrize("shape, tile", [
    ((16, 16, 4), (8, 16)),    # one tile, its window wraps onto itself
    ((16, 16, 4), (2, 4)),     # 16 tiles whose windows do not wrap onto themselves
    ((16, 16, 4), (3, 5)),     # ragged tiles in both directions
    ((12, 16, 33), (2, 8)),    # 33 levels in chunks of 8, the last of 1
    ((32, 32, 100), (4, 4)),   # the f64 plan's tile: 7 chunks of 16, the last of 4
])
def test_nonlinear_reverse_matches_plain_f64(cuda, case, shape, tile):
    """f64, 5 reverse steps through the nonlinear forward kernel's states
    (u of 0.5 m/s, where the nonlinear terms matter): the kernel at the
    given tile (the largest slice that fits) against the plain
    structured_nl_adjoint_step back through the same states, 1e-12 of each
    field's magnitude and of d(dt); a rerun gives the same bits; the linear
    adjoint_step on the same inputs misses by >= 100x; one launch per step."""
    model, st = _nl_lattice(case, shape, cuda)
    sm = model.struct_mesh
    g = _cotangent(st, 8)
    n = 5
    stack = nl_stack(st, sm, DT, n)
    adjoint_step.nl_launches = 0
    (out, ddt), (again, ddt_again) = (nl_reverse(stack, g, sm, DT, n, tile=tile)
                                      for _ in range(2))
    assert adjoint_step.nl_launches == 2 * n
    ref, ref_dt = plain_nl_reverse(stack, g, sm, DT, n)
    lin, _ = linear_reverse(stack, g, sm, DT, n)
    torch.cuda.synchronize()
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert _rel(a, b) <= 1e-12, (f, _rel(a, b))
        assert torch.equal(a, getattr(again, f)), f
    assert abs(float(ddt) - float(ref_dt)) <= 1e-12 * abs(float(ref_dt))
    assert torch.equal(ddt, ddt_again)
    assert max(_rel(getattr(lin, f), getattr(ref, f)) for f in FIELDS) >= 100 * 1e-12


@pytest.mark.parametrize("case", ["periodic", "channel"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nonlinear_fill_stack_is_the_rollouts_bitwise(cuda, case, dtype):
    """fe_step.fe_nl_fill_stack's slot j is fe_nl_rollout's state after j
    steps, bit for bit (the same kernel and plan), periodic and masked."""
    model, st = _nl_lattice(case, (16, 16, 8), cuda, dtype)
    sm = model.struct_mesh
    stack = nl_stack(st, sm, DT, 5)
    for j in range(5):
        ref = fused_run_loop(st, sm, DT, j, nonlinear=True)
        for x, f in zip(stack, FIELDS):
            assert torch.equal(x[j], getattr(ref, f)), (j, f)


@pytest.mark.parametrize("case", ["periodic", "channel"])
def test_nonlinear_reverse_route_counts_launches_and_passes_the_dot_product(cuda, case):
    """fused_adjoint_rollout(nonlinear=True), 7 steps in groups of 3: 7
    forward launches and 2 + 2 + 0 rebuilds of fe_step's nonlinear arm, 7
    nonlinear reverse launches and no linear one; an f64 rerun bitwise equal;
    fused_rollout_diff's forward is fused_run_loop's bit for bit; <J v, g> =
    <v, J^T g> to 1e-12 relative, J v by torch.func.jvp of the plain
    nonlinear rollout."""
    model, st = _nl_lattice(case, (16, 16, 4), cuda)
    sm = model.struct_mesh
    v, g = _cotangent(st, 12), _cotangent(st, 14)
    if sm.edge_mask is not None:
        v = StructState(v.ssh, v.layer_thickness, v.normal_velocity * sm.edge_mask[..., None])
    fe_step.launches = adjoint_step.launches = adjoint_step.nl_launches = 0
    a, a_dt = fused_adjoint_rollout(st, sm, DT, 7, g, plan=3, nonlinear=True)
    assert (fe_step.launches, adjoint_step.nl_launches, adjoint_step.launches) == (11, 7, 0)
    b, b_dt = fused_adjoint_rollout(st, sm, DT, 7, g, plan=3, nonlinear=True)
    assert torch.equal(a_dt, b_dt) and all(torch.equal(getattr(a, f), getattr(b, f))
                                           for f in FIELDS)
    fields = lambda s: tuple(getattr(s, f) for f in FIELDS)  # noqa: E731
    _, jv = torch.func.jvp(
        lambda *xs: fields(structured_run_loop(StructState(*xs), sm, DT, 7, nonlinear=True)),
        fields(st), fields(v))
    lhs = sum(float((x * y).sum()) for x, y in zip(jv, fields(g)))
    rhs = sum(float((x * y).sum()) for x, y in zip(fields(v), fields(a)))
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)
    out = fused_rollout_diff(st, sm, DT, 9, plan=4, nonlinear=True)
    ref = fused_run_loop(st, sm, DT, 9, nonlinear=True)
    assert all(torch.equal(getattr(out, f), getattr(ref, f)) for f in FIELDS)


@pytest.mark.parametrize("case", ["periodic", "channel"])
@pytest.mark.parametrize("tile, ks", [((8, 8), 4), ((8, 16), 2)])  # the plan; a 2-level one
def test_nonlinear_reverse_main_path_plans_f32(cuda, case, tile, ks):
    """The f32 main paths' own plan ((8, 8, 4) at 64^2 and 256^2) and a plan
    of 2-level slices, (8, 16, 2), on a random 32 x 32 x 100 f32 lattice (or
    channel) at 10 km spacing with
    u of 0.5 m/s, 20 reverse steps of dt = 10 s from a random cotangent:
    each cotangent's distance from an f64 reverse from the same f32 values
    at most 3x the plain f32 reverse's, the linear reverse 100x past that
    limit (PERF.md section 2); and in f64 at the same tile (the largest
    slice that fits f64), within 1e-12 of the plain reverse."""
    model, st = _nl_lattice(case, (32, 32, 100), cuda, np.float32, seed=5, dc=1e4)
    model64, st64 = _nl_lattice(case, (32, 32, 100), cuda, np.float64, seed=5, dc=1e4)
    sm, sm64 = model.struct_mesh, model64.struct_mesh
    n = 20
    g = _cotangent(st, 3)
    stack = nl_stack(st, sm, DT, n)
    out = nl_reverse(stack, g, sm, DT, n, tile=tile, ks=ks)
    runs = {"kernel": out, "plain": plain_nl_reverse(stack, g, sm, DT, n),
            "linear": linear_reverse(stack, g, sm, DT, n)}
    ref64 = plain_nl_reverse(stack, g, sm64, DT, n, dtype=torch.float64)
    assert_nl_reverse_f32(reverse_gaps(runs, *ref64))
    if case == "channel":
        assert bool(torch.isfinite(out[0].normal_velocity).all())
    stack64 = nl_stack(st64, sm64, DT, 4)
    g64 = _cotangent(st64, 4)
    got, ddt = nl_reverse(stack64, g64, sm64, DT, 4, tile=tile)
    ref, ref_dt = plain_nl_reverse(stack64, g64, sm64, DT, 4)
    for f in FIELDS:
        assert _rel(getattr(got, f), getattr(ref, f)) <= 1e-12, f
    assert abs(float(ddt) - float(ref_dt)) <= 1e-12 * abs(float(ref_dt))


def test_nonlinear_reverse_plan_matches_the_wrappers_reckoning(cuda):
    """The kernel's shared memory per block for the planner's plans is what
    adjoint_step.nl_adjoint_smem_bytes reckons, one block per SM: f32
    (8, 8, 4) at 64x64x100 and 256x256x100."""
    for ny2, nx in ((32, 64), (128, 256)):
        rt, ct, ks = adjoint_step.nl_adjoint_plan(ny2, nx, 100, 4)
        plan = adjoint_step.nl_adjoint_launch_plan(ny2, nx, 100, (rt, ct), ks)
        assert plan["smem_bytes"] == adjoint_step.nl_adjoint_smem_bytes((rt, ct), 4, ks)
        assert plan["clusters"] == -(-ny2 // rt) * -(-nx // ct)
        assert plan["blocks_per_sm"] == 1


def test_nonlinear_reverse_refuses_what_it_does_not_take(cuda):
    """A Coriolis table that does not map as hex:: / hex_adj:: list it, and a
    slice that is not a power of two, raise ValueError."""
    model, st = _nl_lattice("periodic", (16, 16, 4), cuda)
    sm = model.struct_mesh
    stack = nl_stack(st, sm, DT, 1)
    g = _cotangent(st, 9)
    nl_reverse(stack, g, sm, DT, 1)
    with pytest.raises(ValueError, match="hex lattice"):
        nl_reverse(stack, g, reversed_terms_mesh(sm), DT, 1)
    with pytest.raises(ValueError, match="power of two"):
        nl_reverse(stack, g, sm, DT, 1, ks=3)


# ---- the forced arm (momentum forcing) --------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(16, 16, 4), (64, 64, 6)])
def test_forced_kernel_matches_plain_f64(cuda, shape, masked):
    """adjoint_step's forced arm against the plain forced reverse (the
    hand-written transpose of structured/adjoint.py) back through the same
    forced primal states, 7 steps, f64: d_ssh, d_h, d_u, d(dt), d(wind) and
    d(r_lin, Cd, lambda) within 1e-12 of their scales; a rerun bitwise
    equal; the unforced arm's cotangent at least 100x that limit away."""
    model, st = (channel_lattice if masked else random_lattice)(*shape, cuda)
    sm = model.struct_mesh
    forcing = random_forcing(model)
    n = 7
    stack = forced_stack(st, sm, DT, n, forcing)
    g = _cotangent(st, 3)
    out = forced_reverse(stack, g, sm, DT, n, forcing)
    again = forced_reverse(stack, g, sm, DT, n, forcing)
    ref = plain_forced_reverse(stack, g, sm, DT, n, forcing)
    control = forced_reverse(stack, g, sm, DT, n, None)
    torch.cuda.synchronize()
    errs = forced_reverse_errors(out, ref)
    assert max(errs.values()) <= 1e-12, errs
    miss = forced_reverse_errors(control, ref)
    assert max(miss[f] for f in FIELDS) >= 100 * 1e-12, miss
    for a, b in zip(out[0:1], again[0:1]):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for a, b in zip(out[1:], again[1:]):
        assert torch.equal(a, b)


def test_forced_gradient_matches_plain_f64(cuda):
    """fused_rollout_diff with forcing on the card against the same on the
    CPU (the plain forced steps and reverse), 6 steps in groups of 4, f64:
    the gradients of sum(ssh^2) with respect to the state, dt, the wind and
    the three coefficients within 1e-11 of their scales."""
    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.models.forcing import Forcing

    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    forcing = random_forcing(model)

    def grads(device):
        xs = [getattr(st, f).to(device).clone().requires_grad_(True) for f in FIELDS]
        dt = torch.tensor(DT, dtype=torch.float64, device=device, requires_grad=True)
        parts = [x.to(device).clone().requires_grad_(True) for x in (
            forcing.wind_edge, forcing.drag_linear, forcing.drag_quadratic, forcing.rayleigh)]
        f = Forcing(parts[0], forcing.top_mask.to(device), forcing.bottom_mask.to(device),
                    *parts[1:])
        out = mt.fused_rollout_diff(StructState(*xs), sm.to(device), dt, 6, plan=4, forcing=f)
        return [g.cpu() for g in torch.autograd.grad((out.ssh ** 2).sum(), xs + [dt] + parts)]

    for a, b in zip(grads("cuda"), grads("cpu")):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-11
