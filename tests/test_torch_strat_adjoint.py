"""The port's stratified reverse against the JAX package's, on the CPU at f64
(numpy-seeded inputs, 16 x 16 lattices of 4 levels):

* the plain reverse step with ``strat=`` (``structured_adjoint_step``,
  ``structured_nl_adjoint_step``, their ``pressure_transpose``) against
  ``jax.vjp`` of the JAX roll step and ``torch.func.vjp`` of the port's, for
  the state, dt and W: linear and nonlinear, periodic and channel, forced,
  with tracers, make_stratification's W and a dense random one;
* the slice as a whole: ``torch.autograd.grad`` of sum ssh^2 through
  ``auto_rollout_diff(strat=)`` against ``jax.grad`` through
  ``pallas_rollout_diff`` (the checkpointed roll reverse on the CPU), w.r.t.
  the state, dt and W, in every combination the plain steps run; d(W)
  through ``fused_rollout_diff`` and ``adjoint_from_ckpts`` against
  ``jax.grad`` of the JAX checkpointed roll rollout; central finite
  differences;
* the fused route against the JAX Pallas adjoint segments and the tiled
  route's plain supersteps against the JAX tiled Pallas adjoint, both in
  interpret mode (one call each: a JAX Pallas call in interpret mode costs
  seconds of tracing);
* the port's own checks: the f32 plain step sums d(W) in double, equal
  densities give the unstratified gradient, the planners count the stratified arms' shared memory, a CPU rehearsal
  of the card's stratified reverse (the kernel library stubbed), and the
  refusals on the card.

The CUDA stratified reverse arms are held against these plain versions on
the card (tests/test_torch_strat_adjoint_kernel.py, chip_smoke.py phase 18).
"""

import contextlib
import ctypes
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.models import stratification as jax_strat
from mpas_ocean_tpu.models.forcing import make_forcing as jax_make_forcing
from mpas_ocean_tpu.models.tracers import make_tracers as jax_make_tracers
from mpas_ocean_tpu.structured.model import structured_step as jax_step
from mpas_ocean_tpu.structured.pallas_model import (
    _checkpointed_roll_rollout,
    _cot_from_planes,
    _pallas_tiled_adjoint,
    _strat_w,
    _tiled_scal,
    pallas_adjoint_rollout,
    pallas_rollout_diff,
)
from mpas_ocean_tpu_torch.kernels import adjoint_step, build, fe_step, tiled_adjoint
from mpas_ocean_tpu_torch.models import Stratification, make_stratification
from mpas_ocean_tpu_torch.structured import (
    StructState,
    adjoint_from_ckpts,
    auto_rollout_diff,
    diff_model,
    forward_ckpts,
    fused_adjoint_rollout,
    fused_rollout_diff,
    pressure_transpose,
    struct_state_from_numpy,
    structured_adjoint_step,
    structured_nl_adjoint_step,
    structured_step,
    tiled_adjoint_plan,
    tiled_adjoint_rollout,
    tiled_diff,
    tiled_rollout_diff,
)
from mpas_ocean_tpu_torch.structured.adjoint import ForcingCot
from mpas_ocean_tpu_torch.structured.tiled_diff import adjoint_window_bytes

from torch_gpu_cases import integer_strat_case
from torch_port_cases import (
    FULL_FORCING,
    STATE_FIELDS,
    max_rel_err,
    nl_channel,
    nl_periodic,
    stub_card,
)

DT = 5.0
K = 4
RHO = [1024.0, 1025.0, 1025.5, 1027.0]


def _strats(kind, k=K):
    """(JAX Stratification, port Stratification) of make_stratification's W
    for ``kind`` "rho", or of a dense random W for "dense" (the stratified
    arms take any W)."""
    if kind == "rho":
        return jax_strat.make_stratification(RHO), make_stratification(RHO)
    w, rho = 0.05 * np.random.default_rng(13).normal(size=(k, k)), np.full(k, 1025.0)
    return (jax_strat.Stratification(phi_weights=jnp.asarray(w), densities=jnp.asarray(rho)),
            mt.models.stratification_from_numpy({"phi_weights": w, "densities": rho}))


def _lattice(channel=False, tracers=False, seed=5):
    """(JAX model, port model, JAX state, port state, JAX Mesh, port Mesh) on
    a 16 x 16 lattice of K 50 m levels, periodic or the channel, with two
    tracers made by each package from the same numpy fields."""
    smj, smp, stj, stp, mj, mp = (nl_channel if channel else nl_periodic)(16, K, seed)
    if not tracers:
        return smj, smp, stj, stp, mj, mp
    x = np.asarray(mp.horz.cells.x)
    rng = np.random.default_rng(9)
    fields = [10.0 + 2.0 * np.sin(2 * np.pi * x / (x.max() + 1))[:, None]
              + 0.3 * rng.normal(size=(mp.n_cells, K)), np.full(mp.n_cells, 35.0)]
    progj = smj.from_struct(stj).replace(tracers=jax_make_tracers(mj, fields))
    progp = mt.PrognosticVars(*(getattr(smp.from_struct(stp), f) for f in STATE_FIELDS),
                              tracers=mt.make_tracers(mp, fields))
    return smj, smp, smj.to_struct(progj), smp.to_struct(progp), mj, mp


def _forcings(smj, smp, mj, mp):
    return (smj.to_struct_forcing(jax_make_forcing(mj, **FULL_FORCING)),
            smp.to_struct_forcing(mt.make_forcing(mp, **FULL_FORCING)))


def _fields(tracers):
    return STATE_FIELDS + (("tracers",) if tracers else ())


def _w_scale(h, gu, mesh, dt) -> float:
    """The Cauchy-Schwarz scale of one step's d(W) = sum_c h[c, l] dPhi[c, k]:
    max over (l, k) of sum_c |h[c, l]| |dPhi[c, k]| (a sum whose terms
    cancel: h is ~50 m with a random dPhi), dPhi from pressure_transpose with
    W = I."""
    eye = Stratification(torch.eye(K, dtype=h.dtype), torch.full((K,), 1025.0))
    if mesh.edge_mask is not None:
        gu = gu * mesh.edge_mask[..., None]
    d_phi, _ = pressure_transpose(h, gu, dt, mesh, eye)
    return float((h.abs().reshape(-1, K).T @ d_phi.abs().reshape(-1, K)).max())


# (kind, nonlinear, channel, forced, tracers)
STEP_CASES = [
    ("rho", False, False, False, False),
    ("dense", False, False, False, False),
    ("dense", False, True, False, False),
    ("rho", True, False, False, False),
    ("dense", True, True, False, False),
    ("rho", False, False, True, False),
    ("rho", False, True, False, True),
    ("dense", True, False, True, True),
]


@pytest.mark.parametrize("kind, nonlinear, channel, forced, tracers", STEP_CASES)
def test_plain_strat_reverse_step_matches_jax_vjp(kind, nonlinear, channel, forced, tracers):
    """One reverse step with strat= against jax.vjp of the JAX structured
    step with respect to the state, dt and W, and against torch.func.vjp of
    the port's: every cotangent within 1e-12 of its scale (d(W)'s its
    Cauchy-Schwarz scale, ``_w_scale``); the unstratified reverse at least
    100x off in d_h (the control of the kernels' checks on the card)."""
    smj, smp, stj, stp, mj, mp = _lattice(channel, tracers)
    sj, sp = _strats(kind)
    fj = fp = None
    if forced:
        fj, fp = _forcings(smj, smp, mj, mp)
    kw = dict(tracer_kappa=5.0, tracer_upwind=0.5)
    fields = _fields(tracers)
    rng = np.random.default_rng(11)
    g = {f: rng.normal(size=tuple(getattr(stp, f).shape)) for f in fields}

    def step_j(s, t, w):
        return jax_step(s, smj.struct_mesh, t, nonlinear, fj,
                        strat=jax_strat.Stratification(w, sj.densities), **kw)

    _, vjp = jax.vjp(step_j, stj, jnp.float64(DT), sj.phi_weights)
    ref, ref_dt, ref_w = vjp(stj.replace(**{f: jnp.asarray(v) for f, v in g.items()}))
    step = structured_nl_adjoint_step if nonlinear else structured_adjoint_step
    res = step(stp, struct_state_from_numpy(g), smp.struct_mesh, DT, fp, strat=sp, **kw)
    assert len(res) == (4 if forced else 3)
    for f in fields:
        err = max_rel_err(getattr(res[0], f).numpy(), np.asarray(getattr(ref, f)))
        assert err <= 1e-12, (f, err)
    assert abs(float(res[1]) - float(ref_dt)) <= 1e-12 * abs(float(ref_dt))
    w_scale = _w_scale(stp.layer_thickness, torch.from_numpy(g["normal_velocity"]),
                       smp.struct_mesh, DT)
    assert np.abs(res[-1].numpy() - np.asarray(ref_w)).max() <= 1e-12 * w_scale

    def f(*x):
        out = structured_step(StructState(*x[:len(fields)]), smp.struct_mesh, x[-2], nonlinear,
                              fp, kw["tracer_kappa"], kw["tracer_upwind"],
                              Stratification(x[-1], sp.densities))
        return tuple(getattr(out, name) for name in fields)

    _, tvjp = torch.func.vjp(f, *(getattr(stp, name) for name in fields),
                             torch.tensor(DT, dtype=torch.float64), sp.phi_weights)
    *t_ref, t_dt, t_w = tvjp(tuple(torch.from_numpy(g[name]) for name in fields))
    for name, want in zip(fields, t_ref):
        assert max_rel_err(getattr(res[0], name).numpy(), want.numpy()) <= 1e-12, name
    assert abs(float(res[1]) - float(t_dt)) <= 1e-12 * abs(float(t_dt))
    assert float((res[-1] - t_w).abs().max()) <= 1e-12 * w_scale
    bare = step(stp, struct_state_from_numpy(g), smp.struct_mesh, DT, fp, **kw)
    assert max_rel_err(bare[0].layer_thickness.numpy(),
                       np.asarray(ref.layer_thickness)) >= 100 * 1e-12


# (nonlinear, channel, forced, tracers): both cores, both lattices, forced
# and with tracers, each in some case (the plain step's test above takes
# the combinations of them)
GRAD_CASES = [
    (False, False, True, False),
    (True, True, False, False),
    (False, True, False, True),
]


@pytest.mark.parametrize("nonlinear, channel, forced, tracers", GRAD_CASES)
def test_slice_gradient_matches_jax_grad(nonlinear, channel, forced, tracers):
    """grad of sum ssh^2 (+ sum T^2 with tracers) over 3 steps w.r.t. the
    state, dt and W, through auto_rollout_diff(strat=) on the CPU (the plain
    steps and the plain reverse in checkpoint groups), against jax.grad
    through pallas_rollout_diff (the checkpointed roll reverse on the CPU),
    dense W, kappa 5 and upwind 0.5: rtol 1e-10; d(W) nonzero."""
    smj, smp, stj, stp, mj, mp = _lattice(channel, tracers)
    sj, sp = _strats("dense")
    fj = fp = None
    if forced:
        fj, fp = _forcings(smj, smp, mj, mp)
    n, fields = 3, _fields(tracers)

    def objective(out, total):
        return total(out.ssh ** 2) + (total(out.tracers ** 2) if tracers else 0.0)

    def obj_jax(s, dt, w):
        out = pallas_rollout_diff(s, smj.struct_mesh, dt, n, nonlinear, 5.0, 0.5,
                                  jax_strat.Stratification(w, sj.densities), fj)
        return objective(out, jnp.sum)

    r_s, r_dt, r_w = jax.grad(obj_jax, argnums=(0, 1, 2))(stj, jnp.float64(DT), sj.phi_weights)
    x = [getattr(stp, f).clone().requires_grad_(True) for f in fields]
    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    w = sp.phi_weights.clone().requires_grad_(True)
    out = auto_rollout_diff(StructState(*x), smp.struct_mesh, dt, n, plan=2,
                            nonlinear=nonlinear, forcing=fp, tracer_kappa=5.0, tracer_upwind=0.5,
                            strat=Stratification(w, sp.densities))
    grads = torch.autograd.grad(objective(out, torch.sum), x + [dt, w])
    for f, got in zip(fields, grads):
        want = np.asarray(getattr(r_s, f))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(float(grads[-2]), float(r_dt), rtol=1e-10)
    want = np.asarray(r_w)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(grads[-1].numpy(), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_weight_gradient_matches_the_checkpointed_roll_rollout():
    """d(W) of sum ssh^2 after 6 steps, make_stratification's W: through
    fused_rollout_diff (torch.autograd) and from adjoint_from_ckpts (the
    sweep's own d(W), as the JAX fused segments return dsw), against
    jax.grad of the JAX package's _checkpointed_roll_rollout(strat=w)
    (tests/test_stratification.py:192-222): rtol 1e-10, nonzero."""
    smj, smp, stj, stp, _, _ = _lattice()
    sj, sp = _strats("rho")
    n = 6

    def f_roll(w):
        out = _checkpointed_roll_rollout(stj, smj.struct_mesh, DT, n,
                                         strat=jax_strat.Stratification(w, sj.densities))
        return jnp.sum(out.ssh ** 2)

    want = np.asarray(jax.grad(f_roll)(sj.phi_weights))
    assert np.abs(want).max() > 0
    w = sp.phi_weights.clone().requires_grad_(True)
    out = fused_rollout_diff(stp, smp.struct_mesh, DT, n, plan=4,
                             strat=Stratification(w, sp.densities))
    (got,) = torch.autograd.grad((out.ssh ** 2).sum(), [w])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    final, ckpts = forward_ckpts(stp, smp.struct_mesh, DT, n, 3, strat=sp)
    g = StructState(2 * final.ssh, torch.zeros_like(final.layer_thickness),
                    torch.zeros_like(final.normal_velocity))
    res = adjoint_from_ckpts(ckpts, smp.struct_mesh, DT, n, 3, g, strat=sp)
    assert len(res) == 3 and res[2].dtype == torch.float64
    np.testing.assert_allclose(res[2].numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_plain_strat_reverse_sums_dw_in_double():
    """At f32 the plain reverse step sums d(W) over the cells in double, as
    the kernels do: on integer data whose sums are exact in double
    (torch_gpu_cases.integer_strat_case, 16 x 16 x 6, dt = 1 s) its d(W) is
    bitwise the f64 step's, and the same sums in float are not."""
    mesh, stack, g = integer_strat_case(16, 6, "cpu")
    strat = make_stratification(1025.0 + np.linspace(0.0, 1.0, 6), dtype=np.float32)
    s = StructState(*(x[0] for x in stack))
    got = structured_adjoint_step(s, g, mesh, 1.0, strat=strat)[-1]
    s64, g64 = (StructState(*(getattr(x, f).double() for f in STATE_FIELDS)) for x in (s, g))
    strat64 = Stratification(strat.phi_weights.double(), strat.densities.double())
    want = structured_adjoint_step(s64, g64, mesh, 1.0, strat=strat64)[-1]
    assert got.dtype == torch.float64 and torch.equal(got, want)
    eye = Stratification(torch.eye(6), strat.densities)
    d_phi, _ = pressure_transpose(s.layer_thickness, g.normal_velocity, 1.0, mesh, eye)
    in_float = s.layer_thickness.reshape(-1, 6).T @ d_phi.reshape(-1, 6)
    assert not torch.equal(in_float.double(), want)


def test_fused_adjoint_rollout_strat_matches_pallas_adjoint_segments():
    """fused_adjoint_rollout(strat=) against pallas_adjoint_rollout(plan=(2, 3),
    interpret=True, strat=) (tests/test_stratification.py:160-189) for the
    output cotangent of sum ssh^2 after 6 steps on the channel, dense W:
    within 1e-12 of scale, d(dt) to 1e-10; d(W) is dropped by both, as
    pallas_adjoint_rollout drops it."""
    smj, smp, stj, stp, _, _ = _lattice(channel=True)
    sj, sp = _strats("dense")
    n = 6
    out = stp
    for _ in range(n):
        out = structured_step(out, smp.struct_mesh, DT, strat=sp)
    g = {"ssh": 2 * out.ssh.numpy(), "layer_thickness": np.zeros(tuple(out.layer_thickness.shape)),
         "normal_velocity": np.zeros(tuple(out.normal_velocity.shape))}
    ref, ref_dt = pallas_adjoint_rollout(stj, smj.struct_mesh, DT, n, stj.replace(
        **{f: jnp.asarray(v) for f, v in g.items()}), plan=(2, 3), interpret=True, strat=sj)
    res = fused_adjoint_rollout(stp, smp.struct_mesh, DT, n, struct_state_from_numpy(g), plan=3,
                                strat=sp)
    assert len(res) == 2
    for f in STATE_FIELDS:
        err = max_rel_err(getattr(res[0], f).numpy(), np.asarray(getattr(ref, f)))
        assert err <= 1e-12, (f, err)
    np.testing.assert_allclose(float(res[1]), float(ref_dt), rtol=1e-10)


def test_plain_tiled_supersteps_strat_match_jax_tiled_adjoint():
    """tiled_adjoint_rollout(strat=)'s plain route (the vjp of the slab
    windows with W an input of every window, q = 2, tiles of 4 x 8, groups
    of 2) against _pallas_tiled_adjoint with strat_w in interpret mode (row
    tile 4, q = 2, groups of 2), 4 steps on the periodic lattice, dense W:
    the state's cotangent within 1e-12 of scale, d(dt) and d(W) to 1e-10 of
    theirs; and plain_tiled_adjoint_superstep with strat= at q = 1 against
    structured_adjoint_step(strat=) on one step, to 1e-12."""
    smj, smp, stj, stp, _, _ = _lattice()
    sj, sp = _strats("dense")
    sm_j = smj.struct_mesh
    n, ny2, nx = 4, sm_j.ny2, sm_j.nx
    dtype = stj.layer_thickness.dtype
    rng = np.random.default_rng(13)
    g = {f: rng.normal(size=tuple(getattr(stp, f).shape)) for f in STATE_FIELDS}
    gj = stj.replace(**{f: jnp.asarray(v) for f, v in g.items()})
    cot, dscal, _, dsw = _pallas_tiled_adjoint(
        _tiled_scal(sm_j, DT, dtype), stj.ssh[..., None], stj.layer_thickness,
        stj.normal_velocity.reshape(6, ny2, nx, K), sm_j.f_edge.reshape(6, ny2, nx, 1),
        sm_j.resting_thickness_sum[..., None],
        (gj.ssh[..., None], gj.layer_thickness, gj.normal_velocity.reshape(6, ny2, nx, K)),
        terms=sm_j.coriolis_terms, row_tile=4, n_steps=n, b=2, interpret=True, q=2,
        strat_w=_strat_w(sj, dtype))
    ref = _cot_from_planes(cot, ny2, nx, K)
    d, d_dt, d_w = tiled_adjoint_rollout(stp, smp.struct_mesh, DT, n, struct_state_from_numpy(g),
                                         plan=(4, 8, 2, 2), strat=sp)
    for f in STATE_FIELDS:
        err = max_rel_err(getattr(d, f).numpy(), np.asarray(getattr(ref, f)))
        assert err <= 1e-12, (f, err)
    np.testing.assert_allclose(float(d_dt), float(dscal[0]), rtol=1e-10)
    want = np.asarray(dsw)
    np.testing.assert_allclose(d_w.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    one = tiled_diff.plain_tiled_adjoint_superstep(stp, struct_state_from_numpy(g),
                                                   smp.struct_mesh, DT, 4, 8, 1, strat=sp)
    step = structured_adjoint_step(stp, struct_state_from_numpy(g), smp.struct_mesh, DT,
                                   strat=sp)
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(one[0], f).numpy(), getattr(step[0], f).numpy()) <= 1e-12, f
    assert abs(float(one[1]) - float(step[1])) <= 1e-12 * abs(float(step[1]))
    w_scale = _w_scale(stp.layer_thickness, torch.from_numpy(g["normal_velocity"]),
                       smp.struct_mesh, DT)
    assert float((one[2] - step[2]).abs().max()) <= 1e-12 * w_scale


def test_strat_gradient_matches_finite_differences():
    """The directional derivative of sum ssh^2 after 5 steps along a random
    direction in (state, dt, W), by central differences with Richardson's
    extrapolation (as tests/test_torch_adjoint.py), against the gradient of
    auto_rollout_diff(strat=) on the channel: within 1e-8 of it."""
    _, smp, _, stp, _, _ = _lattice(channel=True)
    _, sp = _strats("dense")
    n, mesh = 5, smp.struct_mesh
    rng = np.random.default_rng(22)
    base = [getattr(stp, f) for f in STATE_FIELDS]
    v = [torch.from_numpy(rng.normal(size=tuple(x.shape))) * x.abs().max() for x in base]
    v_w = torch.from_numpy(rng.normal(size=(K, K))) * 0.05
    v_dt = 0.5

    def objective(eps):
        s = StructState(*(x + eps * vx for x, vx in zip(base, v)))
        strat = Stratification(sp.phi_weights + eps * v_w, sp.densities)
        return float((auto_rollout_diff(s, mesh, DT + eps * v_dt, n, strat=strat).ssh ** 2).sum())

    x = [b.clone().requires_grad_(True) for b in base]
    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    w = sp.phi_weights.clone().requires_grad_(True)
    out = auto_rollout_diff(StructState(*x), mesh, dt, n, strat=Stratification(w, sp.densities))
    grads = torch.autograd.grad((out.ssh ** 2).sum(), x + [dt, w])
    directional = sum(float((gx * vx).sum()) for gx, vx in zip(grads, v))
    directional += float(grads[3]) * v_dt + float((grads[4] * v_w).sum())

    def central(eps):
        return (objective(eps) - objective(-eps)) / (2 * eps)

    eps = 1e-4
    fd = (4 * central(eps / 2) - central(eps)) / 3
    assert abs(fd - directional) <= 1e-8 * abs(directional)


@pytest.mark.parametrize("route", ["auto_rollout_diff", "tiled_rollout_diff"])
def test_equal_densities_give_the_unstratified_gradient(route):
    """Equal densities (W = 0): the gradient of sum ssh^2 over 5 steps w.r.t.
    the state and dt is the unstratified one within 1e-12 of scale, through
    either route; d(W) there is finite and nonzero (the gradient at W = 0)."""
    _, smp, _, stp, _, _ = _lattice(channel=True)
    sm = smp.struct_mesh
    eq = make_stratification([1026.0] * K)
    fn = {"auto_rollout_diff": lambda s, **kw: auto_rollout_diff(s, sm, DT, 5, plan=2, **kw),
          "tiled_rollout_diff": lambda s, **kw: tiled_rollout_diff(s, sm, DT, 5,
                                                                   plan=(4, 8, 1, 2), **kw)}[route]
    x = [getattr(stp, f).clone().requires_grad_(True) for f in STATE_FIELDS]
    w = eq.phi_weights.clone().requires_grad_(True)
    a = torch.autograd.grad((fn(StructState(*x), strat=Stratification(w, eq.densities)).ssh ** 2)
                            .sum(), x + [w])
    b = torch.autograd.grad((fn(StructState(*x)).ssh ** 2).sum(), x)
    for f, ga, gb in zip(STATE_FIELDS, a, b):
        assert max_rel_err(ga.numpy(), gb.numpy()) <= 1e-12, f
    assert bool(torch.isfinite(a[-1]).all()) and float(a[-1].abs().max()) > 0


def test_reverse_planners_count_the_stratified_shared_memory():
    """adjoint_step.smem_bytes and the tiled adjoint's window add the
    stratified arm's S chunk [2][core][kc] and W rows [K][kc] (and 16 bytes
    of alignment) to the unstratified layout; at 64 x 64 x 100 f32 the
    stratified tile still leaves room for two blocks per SM; at f64 it fits
    one block; tiled_adjoint_plan takes q = 1 for the stratified arm."""
    k, itemsize = 100, 4
    _, kc = fe_step.level_split(k)
    for tile in ((4, 8), (2, 8), (3, 12)):
        core = tile[0] * tile[1]
        extra = 16 + itemsize * (2 * core * kc + k * kc)
        assert adjoint_step.strat_smem_bytes(core, kc, k, itemsize) == extra
        assert (adjoint_step.smem_bytes(tile, k, itemsize, strat=True)
                - adjoint_step.smem_bytes(tile, k, itemsize)) == extra
        assert (adjoint_window_bytes(*tile, 1, (1, 2), k, itemsize, strat=True)
                - adjoint_window_bytes(*tile, 1, (1, 2), k, itemsize)) == extra
        sites = tiled_adjoint.window_sites(*tile, 1, (1, 2))
        assert tiled_adjoint.smem_bytes(sites, core, k, 1, itemsize, strat=True) == \
            adjoint_window_bytes(*tile, 1, (1, 2), k, itemsize, strat=True)
    tile = adjoint_step.adjoint_tile(32, 64, k, itemsize, strat=True)
    assert adjoint_step.smem_bytes(tile, k, itemsize, strat=True) <= fe_step.TWO_BLOCK_BYTES
    tile = adjoint_step.adjoint_tile(128, 256, k, itemsize, strat=True)
    assert adjoint_step.smem_bytes(tile, k, itemsize, strat=True) <= fe_step.TWO_BLOCK_BYTES
    assert adjoint_step.smem_bytes(adjoint_step.adjoint_tile(32, 64, k, 8, strat=True), k, 8,
                                   strat=True) <= fe_step.SMEM_BYTES
    rt, ct, q, group = tiled_adjoint_plan(128, 256, k, itemsize, 100, halo=(1, 2), strat=True)
    assert q == 1 and 128 % rt == 0 and 256 % ct == 0 and group == 10
    assert adjoint_window_bytes(rt, ct, 1, (1, 2), k, itemsize, strat=True) <= \
        tiled_adjoint.TWO_BLOCK_BYTES


class _Entry:
    """A stubbed kernel entry: checks each call's argument count and types
    against its argtypes and keeps the calls."""

    def __init__(self):
        self.argtypes = None
        self.calls = []

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        for a, t in zip(args, self.argtypes):
            want = {ctypes.c_void_p: (int, type(None)), ctypes.c_double: (float,),
                    ctypes.c_int: (int,)}[t]
            assert isinstance(a, want) and not isinstance(a, bool)
        self.calls.append(args)
        return 0


class _Lib:
    def __getattr__(self, name):
        setattr(self, name, _Entry())
        return getattr(self, name)


def test_card_routes_pass_the_stratified_operands(monkeypatch):
    """A CPU rehearsal of the card's stratified reverse: with the kernel
    library stubbed by functions that check each call's argument count and
    types against its argtypes, the card's steps (fe_step's rollout and
    stack entries, adjoint_step's and tiled_adjoint's stratified arms) run a
    7-step sweep in groups of 3 on a channel: every launch counts as a
    stratified one (7 forward, 4 rebuild and 7 reverse launches per route),
    each entry gets W where its stratified pointer goes, the reverse entries
    a d(W) accumulator of (tiles, K, K) doubles and d(W) (K, K); W of the
    wrong shape and a W without its d(W) raise, and a W with forcing runs
    the composed arm (the wind where its pointer goes)."""
    lib = _Lib()
    monkeypatch.setattr(build, "load", lambda: lib)
    for m in (fe_step, adjoint_step, tiled_adjoint):
        monkeypatch.setattr(m, "lattice_dims", lambda h, name="fe_step": tuple(h.shape[1:]))
        for c in ("launches", "strat_launches"):
            monkeypatch.setattr(m, c, 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    # the steps' accumulators and W stay on the CPU here
    zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **kw: zeros(*a, **kw))
    monkeypatch.setattr(diff_model, "kernel_strat",
                        lambda s, dtype, device: s.phi_weights.to(dtype).contiguous())
    _, smp, _, stp, _, _ = _lattice(channel=True)
    sm = smp.struct_mesh
    _, sp = _strats("dense")
    like = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float64)
    for steps in (diff_model._Steps(sm, DT, like, strat=sp),
                  tiled_diff._TiledSteps(sm, DT, like, (4, 8, 1, 3), strat=sp)):
        final, ckpts = diff_model._forward(stp, sm, DT, 7, 3, False, None, (0.0, 1.0),
                                           steps=steps)
        d, _, d_w = diff_model._reverse(steps, ckpts, 7, 3, stp, final)
        assert d_w is steps.dstrat and tuple(d_w.shape) == (K, K)
    counts = [(m.launches, m.strat_launches) for m in (fe_step, adjoint_step, tiled_adjoint)]
    assert counts == [(22, 22), (7, 7), (7, 7)]
    w = sp.phi_weights
    assert all(c[20] == w.data_ptr() for c in lib.mot_fe_steps_f64.calls)
    assert all(c[12] == w.data_ptr() for c in lib.mot_fe_stack_f64.calls)
    for entry, at in ((lib.mot_adjoint_rollout_f64, 29), (lib.mot_tiled_adjoint_f64, 32)):
        assert all(c[at] == w.data_ptr() and c[at + 1] is not None and c[at + 2] is not None
                   for c in entry.calls)
    stack = tuple(torch.zeros((2, *getattr(stp, f).shape), dtype=torch.float64)
                  for f in STATE_FIELDS)
    g = tuple(getattr(stp, f).contiguous() for f in STATE_FIELDS)
    args = (stack, g, sm.f_edge.contiguous(), *sm.host_adjoint_stencil, DT, 1e-3, 1e-3, 2,
            torch.zeros(1, dtype=torch.float64))
    dw = torch.zeros((K, K), dtype=torch.float64)
    calls = len(lib.mot_adjoint_rollout_f64.calls)
    adjoint_step.adjoint_rollout(*args, strat_w=w, dstrat=dw)
    assert len(lib.mot_adjoint_rollout_f64.calls) == calls + 1
    forced = dict(forcing=SimpleNamespace(
        wind=torch.zeros(6, sm.ny2, sm.nx, dtype=torch.float64),
        levels=torch.zeros(6, sm.ny2, sm.nx, dtype=torch.int32), coefs=(0.0, 0.0, 0.0),
        top_levels=(0,), bottom_levels=(K - 1,)),
        dforc=ForcingCot(torch.zeros(6, sm.ny2, sm.nx, dtype=torch.float64),
                         torch.zeros(3, dtype=torch.float64)))
    for bad in (dict(strat_w=w[:2], dstrat=dw), dict(strat_w=w), dict(strat_w=w, dstrat=dw[:2])):
        with pytest.raises(ValueError):
            adjoint_step.adjoint_rollout(*args, **bad)
    adjoint_step.adjoint_rollout(*args, strat_w=w, dstrat=dw, **forced)
    call = lib.mot_adjoint_rollout_f64.calls[-1]
    assert call[2] == forced["forcing"].wind.data_ptr() and call[29] == w.data_ptr()


def test_card_refuses_the_stratified_reverse_where_no_arm_runs_it(monkeypatch):
    """On the card (no card needed: the checks read the device's type
    only; the steps' operands kept on the CPU, torch_port_cases.stub_card)
    the stratified reverse builds with the nonlinear core, forcing and
    tracers, on either route at q = 1 (the composed arms), and the
    stratified tiled reverse builds and runs at q > 1 too (tiled_adjoint's
    stratified arm at q > 1): a 6-step rollout's gradient at q = 2 reverses
    through 3 launches of the stubbed tiled_adjoint entry, each given q = 2,
    W, its d(W) accumulators and d(W), and the wrapper takes a stratified
    superstep of q = 2 itself; a nonlinear q > 1 builds too (the q-step
    nonlinear reverse's steps, no guard left). The kernels' q > 1 arms
    against the plain reverse: tests/test_torch_window_adjoint_kernel.py,
    tests/test_torch_nl_window_adjoint_kernel.py."""
    lib = stub_card(monkeypatch)
    _, smp, _, stp, mj, mp = _lattice()
    sm = smp.struct_mesh
    _, sp = _strats("rho")
    cuda = torch.device("cuda")
    like = SimpleNamespace(device=cuda, dtype=torch.float32)
    forcing = smp.to_struct_forcing(mt.make_forcing(mp, **FULL_FORCING))
    for kw in (dict(nonlinear=True), dict(forcing=forcing), dict(tracers=True)):
        for steps in (diff_model._Steps(sm, DT, like, strat=sp, **kw),
                      tiled_diff._TiledSteps(sm, DT, like, (4, 8, 1, 1), strat=sp, **kw)):
            assert steps.sw is not None and steps.dstrat is not None
    for kw in (dict(forcing=forcing), dict(tracers=True), {}):
        steps = tiled_diff._TiledSteps(sm, DT, like, (4, 8, 2, 1), strat=sp, **kw)
        assert steps.sw is not None and steps.dstrat is not None
    assert not hasattr(tiled_diff, "_check_nl_q")
    steps = tiled_diff._TiledSteps(sm, DT, like, (4, 8, 2, 1), nonlinear=True, strat=sp)
    assert steps.q == 2 and steps.sw is not None and steps.dstrat is not None
    like64 = SimpleNamespace(device=cuda, dtype=torch.float64)
    steps = tiled_diff._TiledSteps(sm, DT, like64, (4, 8, 2, 1), strat=sp)
    final, ckpts = diff_model._forward(stp, sm, DT, 6, 2, False, None, (0.0, 1.0),
                                       steps=steps)
    _, _, d_w = diff_model._reverse(steps, ckpts, 3, 1, stp, final)
    assert d_w is steps.dstrat and tuple(d_w.shape) == (K, K)
    assert (tiled_adjoint.launches, tiled_adjoint.strat_launches) == (3, 3)
    w = steps.sw
    assert all(c[32] == w.data_ptr() and c[33] is not None and c[34] == d_w.data_ptr()
               and c[52] == 2 for c in lib.mot_tiled_adjoint_f64.calls)
    stack = tuple(torch.zeros((1, *getattr(stp, f).shape), dtype=torch.float64)
                  for f in STATE_FIELDS)
    g = tuple(getattr(stp, f).contiguous() for f in STATE_FIELDS)
    tiled_adjoint.tiled_adjoint_rollout(
        stack, g, sm.f_edge.contiguous(), sm.resting_thickness_sum.contiguous(),
        *sm.host_stencil, *sm.host_adjoint_stencil, DT, 1e-3, 1e-3, 1,
        torch.zeros(1, dtype=torch.float64), row_tile=4, col_tile=8, q=2, halo=(1, 2),
        strat_w=w, dstrat=torch.zeros(K, K, dtype=torch.float64))
    assert lib.mot_tiled_adjoint_f64.calls[-1][52] == 2 and tiled_adjoint.strat_launches == 4
