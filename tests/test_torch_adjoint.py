"""The port's reverse mode against the JAX package's, on the CPU, f64.

* the transposed Coriolis stencil is the exact transpose;
* the plain adjoint step (``structured_adjoint_step``) against
  ``torch.autograd`` of the port's ``structured_step``;
* ``fused_adjoint_rollout`` (the checkpointed sweep, plain steps for CPU
  tensors) against ``jax.vjp`` of the JAX roll model and against the JAX
  Pallas adjoint segments in interpret mode;
* ``fused_rollout_diff`` and ``fused_step`` gradients against ``jax.grad``;
* a finite-difference check of the whole-rollout gradient;
* the checkpoint plan;
* a numpy walk of the adjoint kernel's tables, step for step as
  csrc/adjoint_step.cu reads them, against the plain adjoint step: the
  tables' semantics are checked here, the CUDA arithmetic on the card
  (tests/test_torch_adjoint_kernel.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_ocean_tpu.structured import pallas_rollout_diff, pallas_step
from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.model import structured_step as jax_step
from mpas_ocean_tpu.structured.pallas_model import pallas_adjoint_rollout
from mpas_ocean_tpu_torch.constants import GRAVITY
from mpas_ocean_tpu_torch.kernels import adjoint_step
from mpas_ocean_tpu_torch.kernels.fe_step import pack_stencil
from mpas_ocean_tpu_torch.structured import (
    StructState,
    StructuredModel,
    adjoint_plan,
    adjoint_segment,
    forward_ckpts,
    fused_adjoint_rollout,
    fused_rollout_diff,
    fused_step,
    struct_mesh_from_numpy,
    struct_state_from_numpy,
    structured_adjoint_run_loop,
    structured_adjoint_step,
    structured_run_loop,
    structured_step,
)
from mpas_ocean_tpu_torch.structured.fused_model import _scal
from mpas_ocean_tpu_torch.structured.model import apply_stencil
from mpas_ocean_tpu_torch.structured.stencils import transpose_coriolis_terms

from torch_port_cases import (
    STATE_FIELDS,
    both_meshes,
    jax_lattice,
    jax_struct_mesh_dict,
    jax_struct_state_dict,
    max_rel_err,
)

DT = 10.0


def _port(sm, st):
    return (
        struct_state_from_numpy(jax_struct_state_dict(st)),
        struct_mesh_from_numpy(jax_struct_mesh_dict(sm.struct_mesh)),
    )


def _fields(state):
    return [getattr(state, f) for f in STATE_FIELDS]


def _random_cotangent(state, seed):
    rng = np.random.default_rng(seed)
    return StructState(*(torch.from_numpy(rng.normal(size=tuple(x.shape)))
                         for x in _fields(state)))


def _leaves(state):
    return [x.clone().requires_grad_(True) for x in _fields(state)]


def _objective(out):
    return (out.ssh ** 2).sum() + (out.normal_velocity ** 2).sum()


@pytest.fixture(scope="module")
def lattice():
    sm, st = jax_lattice(8, 8, 4, seed=7)
    return sm, st, *_port(sm, st)


def test_transposed_coriolis_stencil_is_the_transpose(lattice):
    *_, mesh = lattice
    rng = np.random.default_rng(3)
    shape = (3, 2, mesh.ny2, mesh.nx, 4)
    x = torch.from_numpy(rng.normal(size=shape))
    y = torch.from_numpy(rng.normal(size=shape))
    terms = mesh.coriolis_terms
    lhs = float((apply_stencil(x, terms) * y).sum())
    rhs = float((x * apply_stencil(y, transpose_coriolis_terms(terms))).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    assert transpose_coriolis_terms(transpose_coriolis_terms(terms)) == terms


@pytest.mark.parametrize("shape, seed", [((8, 8, 4), 7), ((16, 16, 4), 4)])
def test_plain_adjoint_step_matches_autograd(shape, seed):
    sm, st = jax_lattice(*shape, seed=seed)
    state, mesh = _port(sm, st)
    x = _leaves(state)
    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    out = structured_step(StructState(*x), mesh, dt)
    g = _random_cotangent(state, seed + 1)
    ref = torch.autograd.grad(_fields(out), x + [dt], _fields(g))
    d, d_dt = structured_adjoint_step(state, g, mesh, DT)
    for f, r in zip(STATE_FIELDS, ref):
        assert max_rel_err(getattr(d, f).numpy(), r.numpy()) <= 1e-12, f
    assert abs(float(d_dt) - float(ref[3])) <= 1e-12 * abs(float(ref[3]))


def _jax_vjp(sm, st, n):
    out, vjp = jax.vjp(lambda s, t: jax_run_loop(s, sm.struct_mesh, t, n), st, DT)
    g = jax.tree.map(lambda a: a + 0.5, out)  # dense arbitrary cotangent
    d_ref, ddt_ref = vjp(g)
    return g, d_ref, float(ddt_ref)


def _assert_matches(d, d_dt, d_ref, ddt_ref, tol):
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(d, f).numpy(), np.asarray(getattr(d_ref, f))) <= tol, f
    assert abs(float(d_dt) - ddt_ref) <= tol * abs(ddt_ref)


@pytest.mark.parametrize("plan", [None, 4])
def test_fused_adjoint_rollout_matches_jax_vjp(lattice, plan):
    """n = 6 as tests/test_pallas.py:183-206; plan 4 leaves a 2-step
    remainder group."""
    sm, st, state, mesh = lattice
    n = 6
    g, d_ref, ddt_ref = _jax_vjp(sm, st, n)
    d, d_dt = fused_adjoint_rollout(
        state, mesh, DT, n, struct_state_from_numpy(jax_struct_state_dict(g)), plan=plan)
    assert d_dt.dtype == torch.float64 and d_dt.shape == ()
    _assert_matches(d, d_dt, d_ref, ddt_ref, 1e-12)


def test_fused_adjoint_rollout_matches_pallas_adjoint_segments(lattice):
    """The JAX TPU path (Pallas segment kernels, plan (2, 3)) in interpret
    mode, as the JAX package's own tests run it."""
    sm, st, state, mesh = lattice
    n = 6
    out = jax_run_loop(st, sm.struct_mesh, DT, n)
    g = jax.tree.map(lambda a: a + 0.5, out)
    d_ref, ddt_ref = pallas_adjoint_rollout(
        st, sm.struct_mesh, DT, n, g, plan=(2, 3), interpret=True)
    d, d_dt = fused_adjoint_rollout(
        state, mesh, DT, n, struct_state_from_numpy(jax_struct_state_dict(g)), plan=3)
    _assert_matches(d, d_dt, d_ref, float(ddt_ref), 1e-12)


def test_rollout_diff_grad_matches_jax_pallas_rollout_diff(lattice):
    """tests/test_pallas.py:110-138 across the two packages: n = 7."""
    sm, st, state, mesh = lattice
    n = 7

    def obj_jax(s, dt):
        out = pallas_rollout_diff(s, sm.struct_mesh, dt, n)
        return jnp.sum(out.ssh**2) + jnp.sum(out.normal_velocity**2)

    (r_s, r_dt) = jax.grad(obj_jax, argnums=(0, 1))(st, jnp.float64(DT))
    x = _leaves(state)
    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    loss = _objective(fused_rollout_diff(StructState(*x), mesh, dt, n))
    grads = torch.autograd.grad(loss, x + [dt])
    for f, got in zip(STATE_FIELDS, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(r_s, f)),
                                   rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(float(grads[3]), float(r_dt), rtol=1e-9)
    assert grads[3].dtype == torch.float64
    np.testing.assert_allclose(float(loss.detach()), float(obj_jax(st, DT)), rtol=1e-12)


def test_fused_step_grad_matches_roll_grad(lattice):
    """tests/test_pallas.py:63-78 across the two packages."""
    sm, st, state, mesh = lattice

    def obj_roll(s):
        out = jax_step(s, sm.struct_mesh, DT)
        return jnp.sum(out.ssh**2) + jnp.sum(out.normal_velocity**2)

    def obj_pallas(s):
        out = pallas_step(s, sm.struct_mesh, DT)
        return jnp.sum(out.ssh**2) + jnp.sum(out.normal_velocity**2)

    ref = jax.grad(obj_roll)(st)
    x = _leaves(state)
    grads = torch.autograd.grad(_objective(fused_step(StructState(*x), mesh, DT)), x)
    for f, got in zip(STATE_FIELDS, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, f)), rtol=1e-10)
    ref_p = jax.grad(obj_pallas)(st)
    for f, got in zip(STATE_FIELDS, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref_p, f)), rtol=1e-10)


def test_rollout_grad_matches_finite_differences(lattice):
    """The reference's Enzyme-against-finite-differences validation
    (test/enzyme/test_Enzyme_end2end.jl:78-92): the directional derivative
    of the objective along a random direction in (state, dt), by central
    differences, against the gradient's inner product with it. The
    objective is a polynomial in the inputs, of degree 2n in dt, so a
    central difference at eps = 1e-3 of each field's scale is off by ~4e-4;
    Richardson's extrapolation over eps and eps / 2 cancels that O(eps^2)
    term and leaves ~1e-11, under the 1e-9 asked."""
    *_, state, mesh = lattice
    n = 10
    rng = np.random.default_rng(21)
    v = [torch.from_numpy(rng.normal(size=tuple(x.shape))) * x.abs().max()
         for x in _fields(state)]
    v_dt = 0.5

    def objective(eps):
        s = StructState(*(x + eps * vx for x, vx in zip(_fields(state), v)))
        return float(_objective(fused_rollout_diff(s, mesh, DT + eps * v_dt, n)))

    x = _leaves(state)
    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    grads = torch.autograd.grad(
        _objective(fused_rollout_diff(StructState(*x), mesh, dt, n)), x + [dt])
    directional = sum(float((gx * vx).sum()) for gx, vx in zip(grads, v))
    directional += float(grads[3]) * v_dt
    def central(eps):
        return (objective(eps) - objective(-eps)) / (2 * eps)

    eps = 1e-3
    fd = (4 * central(eps / 2) - central(eps)) / 3
    assert abs(fd - directional) <= 1e-9 * abs(directional)


def test_plain_sweep_passes_the_dot_product_identity(lattice):
    """<J v, g> = <v, J^T g> for J the Jacobian of the 7-step rollout: J v
    by forward-mode AD (torch.func.jvp), J^T g by the checkpointed sweep."""
    *_, state, mesh = lattice
    n = 7
    v = _random_cotangent(state, 8)
    g = _random_cotangent(state, 9)

    def rollout(*fields):
        return tuple(_fields(structured_run_loop(StructState(*fields), mesh, DT, n)))

    _, jv = torch.func.jvp(rollout, tuple(_fields(state)), tuple(_fields(v)))
    lhs = sum(float((x * y).sum()) for x, y in zip(jv, _fields(g)))
    d, _ = fused_adjoint_rollout(state, mesh, DT, n, g, plan=3)
    rhs = sum(float((x * y).sum()) for x, y in zip(_fields(v), _fields(d)))
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


def test_adjoint_plan_covers_every_step_count():
    """Mirrors tests/test_pallas.py:254-260: a plan for every n, whose
    groups cover the n steps; the last group takes the remainder."""
    state_bytes = 2 * 32 * 64 * 4 * (1 + 8 * 100)  # 64x64x100 f32
    for n in (1, 7, 12, 97, 8000, 9998):
        group = adjoint_plan(n, state_bytes, budget=8 * 1024**3)
        n_groups = -(-n // group)
        assert 1 <= group <= n
        assert (n_groups - 1) * group < n <= n_groups * group
        assert n_groups + group <= 2 * np.sqrt(n) + 2
    assert adjoint_plan(4000, state_bytes, 8 * 1024**3) == 64
    with pytest.raises(ValueError, match="budget"):
        adjoint_plan(4000, state_bytes, budget=100 * state_bytes)
    with pytest.raises(ValueError):
        adjoint_plan(0, state_bytes, budget=1e12)


def test_forward_ckpts_keep_group_starts_and_final_bitwise(lattice):
    *_, state, mesh = lattice
    n, group = 7, 3
    final, ckpts = forward_ckpts(state, mesh, DT, n, group)
    assert ckpts.layer_thickness.shape[0] == 3
    for f in STATE_FIELDS:
        assert torch.equal(getattr(final, f), getattr(structured_run_loop(state, mesh, DT, n), f))
        for gi in range(3):
            want = getattr(structured_run_loop(state, mesh, DT, gi * group), f)
            assert torch.equal(getattr(ckpts, f)[gi], want)


def test_adjoint_segment_and_run_loop_match_the_sweep(lattice):
    *_, state, mesh = lattice
    n = 5
    g = _random_cotangent(state, 2)
    d, d_dt = fused_adjoint_rollout(state, mesh, DT, n, g, plan=2)
    for other, other_dt in (adjoint_segment(state, g, mesh, DT, n),
                            structured_adjoint_run_loop(state, mesh, DT, n, g)):
        for f in STATE_FIELDS:
            assert max_rel_err(getattr(other, f).numpy(), getattr(d, f).numpy()) <= 1e-13
        assert abs(float(other_dt) - float(d_dt)) <= 1e-13 * abs(float(d_dt))
    same, zero = fused_adjoint_rollout(state, mesh, DT, 0, g)
    assert same is g and float(zero) == 0.0


def test_rollout_diff_of_zero_steps_is_the_identity(lattice):
    *_, state, mesh = lattice
    x = _leaves(state)
    out = fused_rollout_diff(StructState(*x), mesh, DT, 0)
    for a, b in zip(_fields(out), x):
        assert torch.equal(a, b) and a is not b
    grads = torch.autograd.grad(_objective(out), x)
    assert torch.equal(grads[2], 2 * x[2].detach())
    assert torch.equal(grads[0], 2 * x[0].detach())


def _walk_adjoint_table_step(ssh, h, u, f_edge, table, w, gs, gh, gu, dt, inv_dc, s_div):
    """One reverse step as csrc/adjoint_step.cu computes it from the packed
    transposed table, on numpy planes: ssh and gs (2, ny2, nx), h and gh
    (2, ny2, nx, K), u and gu (6, ny2, nx, K), f_edge (6, ny2, nx). Returns
    (ds, dh, du, d(dt))."""
    _, ny2, nx, _ = h.shape
    n = table[0]
    nbr = table[1:19].reshape(6, 3)
    inc = table[19:37].reshape(2, 3, 3)
    off = table[37:44]
    taps = table[44:].reshape(n, 3)
    m, i = np.meshgrid(np.arange(ny2), np.arange(nx), indexing="ij")

    def at(plane, dm, di):
        return plane[(m + dm) % ny2, (i + di) % nx]

    ds, dh, du = np.empty_like(gs), np.empty_like(gh), np.empty_like(gu)
    ddt = 0.0
    for p in (0, 1):
        g_c = gh[p] + gs[p][..., None]
        flux = 0.0
        sums = []
        for f in range(3):
            c = f * 2 + p
            pin, dm, di = nbr[c]
            d_g = at(gh[pin], dm, di) + at(gs[pin], dm, di)[..., None] - g_c
            g_flux = dt * s_div * d_g
            he = 0.5 * (at(h[pin], dm, di) + h[p])
            ct = 0.0
            for t in range(off[c], off[c + 1]):
                ch, tm, ti = taps[t]
                ct = ct + w[t] * at(gu[ch], tm, ti)
            fct = f_edge[c][..., None] * ct
            du[c] = gu[c] + he * g_flux + dt * fct
            flux = flux + u[c] * g_flux
            sums.append(gu[c].sum(-1))
            grad = (at(ssh[pin], dm, di) - ssh[p]) * inv_dc
            ddt += float((u[c] * (s_div * d_g * he + fct)
                          - GRAVITY * grad[..., None] * gu[c]).sum())
        for ch, dm, di in inc[p]:
            own = ch & 1
            g_o = at(gh[own], dm, di) + at(gs[own], dm, di)[..., None]
            flux = flux + at(u[ch], dm, di) * (dt * s_div * (g_c - g_o))
            sums.append(at(gu[ch], dm, di).sum(-1))
        dh[p] = g_c + 0.5 * flux
        ds[p] = (GRAVITY * dt * inv_dc) * ((sums[0] + sums[1] + sums[2])
                                           - (sums[3] + sums[4] + sums[5]))
    return ds, dh, du, ddt


def test_adjoint_kernel_table_walk_matches_plain_version():
    sm, st = jax_lattice(10, 12, 3, seed=9)
    state, mesh = _port(sm, st)
    n = 4
    dt_, inv_dc, s_div = _scal(mesh, DT, torch.float64)
    ny2, nx, k = mesh.ny2, mesh.nx, state.layer_thickness.shape[-1]
    states = [state]
    for _ in range(n - 1):
        states.append(structured_step(states[-1], mesh, DT))
    g = _random_cotangent(state, 5)
    gs, gh = g.ssh.numpy(), g.layer_thickness.numpy()
    gu = g.normal_velocity.numpy().reshape(6, ny2, nx, k)
    ddt = 0.0
    for s in reversed(states):
        gs, gh, gu, dd = _walk_adjoint_table_step(
            s.ssh.numpy(), s.layer_thickness.numpy(),
            s.normal_velocity.numpy().reshape(6, ny2, nx, k),
            mesh.f_edge.numpy().reshape(6, ny2, nx), mesh.adjoint_table.numpy(),
            mesh.adjoint_weight.numpy(), gs, gh, gu, dt_, inv_dc, s_div)
        ddt += dd
    ref, ref_dt = structured_adjoint_run_loop(state, mesh, DT, n, g)
    for got, f in ((gs, "ssh"), (gh, "layer_thickness"), (gu, "normal_velocity")):
        want = getattr(ref, f).numpy()
        assert max_rel_err(got.reshape(want.shape), want) <= 1e-12, f
    assert abs(ddt - float(ref_dt)) <= 1e-12 * abs(float(ref_dt))


def test_adjoint_table_is_the_packed_transpose(lattice):
    *_, mesh = lattice
    table, w = pack_stencil(transpose_coriolis_terms(mesh.coriolis_terms))
    np.testing.assert_array_equal(mesh.adjoint_table.numpy(), table)
    np.testing.assert_array_equal(mesh.adjoint_weight.numpy(), w)
    # the neighbour and incoming taps are the forward table's
    np.testing.assert_array_equal(table[:44], mesh.stencil_table.numpy()[:44])


def test_adjoint_wrapper_refuses_cpu_tensors(lattice):
    """The wrapper launches on a CUDA device or raises; the CPU route to
    the plain version is diff_model's, by the state's device."""
    *_, state, mesh = lattice
    stack = tuple(x[None] for x in _fields(state))
    with pytest.raises(ValueError, match="CUDA"):
        adjoint_step.adjoint_rollout(
            stack, tuple(_fields(state)), mesh.f_edge, *mesh.host_adjoint_stencil,
            DT, 1e-3, 1e-3, 1, torch.zeros(1, dtype=torch.float64))
    with pytest.raises(ValueError, match="no rollout"):
        fused_adjoint_rollout(StructState(*(x.to("meta") for x in _fields(state))),
                              mesh, DT, 2, state, plan=1)


def test_structured_model_builds_on_the_card_by_default(monkeypatch):
    """StructuredModel(mesh, nx, ny) puts its buffers on CUDA; without a
    card it raises instead of building on the host. device="cpu" builds on
    the host."""
    _, mesh = both_meshes(8, 8, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StructuredModel(mesh, 8, 8)
    model = StructuredModel(mesh, 8, 8, device="cpu")
    assert {b.device.type for b in model.buffers()} == {"cpu"}
