"""The port's tracer reverse against the JAX package's, on the CPU at f64
(numpy-seeded inputs, 16 x 16 lattices of 3 levels carrying two tracers):

* the plain reverse step with tracers (``structured_adjoint_step``,
  ``structured_nl_adjoint_step``, their ``tracer_transpose``) against
  ``jax.vjp`` of the JAX roll step and ``torch.func.vjp`` of the port's:
  linear and nonlinear, forced and not, periodic and on the channel,
  kappa in {0, 5}, upwind in {1, 0.5, 0};
* the tiled route's plain superstep with tracers against the JAX tiled
  Pallas adjoint in interpret mode, and the fused route against the JAX
  Pallas adjoint segments in interpret mode (one call each: a JAX Pallas
  call in interpret mode costs seconds of tracing);
* the slice as a whole: ``torch.autograd.grad`` of sum ssh^2 + sum T^2
  through ``auto_rollout_diff`` against ``jax.grad`` through
  ``pallas_rollout_diff`` (the checkpointed roll reverse on the CPU) and
  against central finite differences;
* the tracer-free reverse misses the h' feedback (a control for the
  kernels' checks on the card, tests/test_torch_tracer_adjoint_kernel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_ocean_tpu.models.forcing import make_forcing as jax_make_forcing
from mpas_ocean_tpu.structured.model import structured_step as jax_step
from mpas_ocean_tpu.structured.pallas_model import (
    _cot_from_planes,
    _pallas_tiled_adjoint,
    _tiled_scal,
    _tr_planes,
    pallas_adjoint_rollout,
    pallas_rollout_diff,
)
import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu_torch.structured import (
    StructState,
    auto_rollout_diff,
    fused_adjoint_rollout,
    struct_state_from_numpy,
    structured_step,
    tiled_adjoint_rollout,
)
from mpas_ocean_tpu_torch.structured.adjoint import (
    structured_adjoint_step,
    structured_nl_adjoint_step,
)

from test_torch_tracers import tracer_lattice
from torch_port_cases import FULL_FORCING, max_rel_err

DT = 30.0
FIELDS = ("ssh", "layer_thickness", "normal_velocity", "tracers")


def _random_cotangent(state, seed):
    rng = np.random.default_rng(seed)
    return {f: rng.normal(size=tuple(getattr(state, f).shape)) for f in FIELDS}


def _port(d: dict) -> StructState:
    return struct_state_from_numpy(d)


def _jax(st, d: dict):
    return st.replace(**{f: jnp.asarray(v) for f, v in d.items()})


def _assert_state(d, ref, tol, fields=FIELDS):
    for f in fields:
        err = max_rel_err(getattr(d, f).detach().numpy(), np.asarray(getattr(ref, f)))
        assert err <= tol, (f, err)


# (nonlinear, channel, forced, kappa, upwind): each value of each option,
# the JAX step's every tracer arm
STEP_CASES = [
    (False, False, False, 0.0, 1.0),
    (False, False, False, 5.0, 0.5),
    (False, True, False, 5.0, 1.0),
    (False, True, True, 0.0, 0.0),
    (False, False, True, 5.0, 0.0),
    (True, False, False, 5.0, 0.5),
    (True, True, False, 0.0, 1.0),
    (True, True, True, 5.0, 0.5),
]


@pytest.mark.parametrize("nonlinear, channel, forced, kappa, upwind", STEP_CASES)
def test_plain_tracer_reverse_step_matches_jax_vjp(nonlinear, channel, forced, kappa, upwind):
    """One reverse step with tracers against jax.vjp of the JAX structured
    step and torch.func.vjp of the port's, every cotangent (the tracers'
    and d(dt) among them) within 1e-12 of its scale."""
    smj, smp, stj, stp, mj, mp = tracer_lattice(16, 3, channel)
    fj = fp = None
    if forced:
        fj = smj.to_struct_forcing(jax_make_forcing(mj, **FULL_FORCING))
        fp = smp.to_struct_forcing(mt.make_forcing(mp, **FULL_FORCING))
    g = _random_cotangent(stp, 11)
    _, vjp = jax.vjp(lambda s, t: jax_step(s, smj.struct_mesh, t, nonlinear, fj,
                                           tracer_kappa=kappa, tracer_upwind=upwind),
                     stj, jnp.float64(DT))
    ref, ref_dt = vjp(_jax(stj, g))
    step = structured_nl_adjoint_step if nonlinear else structured_adjoint_step
    res = step(stp, _port(g), smp.struct_mesh, DT, fp, tracer_kappa=kappa,
               tracer_upwind=upwind)
    _assert_state(res[0], ref, 1e-12)
    assert abs(float(res[1]) - float(ref_dt)) <= 1e-12 * abs(float(ref_dt))

    def f(*x):
        out = structured_step(StructState(*x[:4]), smp.struct_mesh, x[4], nonlinear, fp, kappa,
                              upwind)
        return tuple(getattr(out, name) for name in FIELDS)

    _, tvjp = torch.func.vjp(f, *(getattr(stp, name) for name in FIELDS),
                             torch.tensor(DT, dtype=torch.float64))
    *t_ref, t_dt = tvjp(tuple(torch.from_numpy(g[name]) for name in FIELDS))
    for name, want in zip(FIELDS, t_ref):
        assert max_rel_err(getattr(res[0], name).numpy(), want.numpy()) <= 1e-12, name
    assert abs(float(res[1]) - float(t_dt)) <= 1e-12 * abs(float(t_dt))


@pytest.mark.parametrize("channel", [False, True])
def test_reverse_reads_the_next_state_as_the_kernels_do(channel):
    """structured_adjoint_step with next_state (h' and T' read from the
    step's result, as the reverse kernels read them from the stack) is
    bitwise the reverse that forms them again, given the step's own result;
    given a result whose T' differs, its d_h moves by a (the h' feedback)."""
    _, smp, _, stp, _, _ = tracer_lattice(16, 3, channel)
    sm, g = smp.struct_mesh, _port(_random_cotangent(stp, 14))
    kw = dict(tracer_kappa=5.0, tracer_upwind=0.5)
    nxt = structured_step(stp, sm, DT, **kw)
    want = structured_adjoint_step(stp, g, sm, DT, **kw)
    got = structured_adjoint_step(stp, g, sm, DT, **kw, next_state=nxt)
    assert all(torch.equal(getattr(got[0], f), getattr(want[0], f)) for f in FIELDS)
    assert torch.equal(got[1], want[1])
    moved = StructState(nxt.ssh, nxt.layer_thickness, nxt.normal_velocity, nxt.tracers + 1.0)
    other = structured_adjoint_step(stp, g, sm, DT, **kw, next_state=moved)
    assert max_rel_err(other[0].layer_thickness.numpy(), want[0].layer_thickness.numpy()) > 1e-6


def test_tracer_free_reverse_misses_the_h_feedback():
    """The control of the kernels' checks: on the same primal state and
    output cotangents of ssh, h and u (the tracers' zero), the tracer
    reverse's d_h differs from the tracer-free reverse's by far more than
    the 1e-12 bound, since h' feeds the tracers' division back into G; with
    a nonzero tracer cotangent too."""
    _, smp, _, stp, _, _ = tracer_lattice(16, 3)
    g = _random_cotangent(stp, 12)
    bare = StructState(stp.ssh, stp.layer_thickness, stp.normal_velocity)
    g_bare = _port({f: g[f] for f in FIELDS[:3]})
    d_bare, _ = structured_adjoint_step(bare, g_bare, smp.struct_mesh, DT)
    d_tr, _ = structured_adjoint_step(stp, _port(g), smp.struct_mesh, DT, tracer_kappa=5.0)
    assert max_rel_err(d_tr.layer_thickness.numpy(), d_bare.layer_thickness.numpy()) >= 1e-10


def test_plain_tiled_superstep_with_tracers_matches_jax_tiled_adjoint():
    """tiled_adjoint_rollout's plain route with tracers (the vjp of the slab
    windows, q = 1, tiles of 2 x 4) against _pallas_tiled_adjoint with
    tracers0 in interpret mode (row tile 2, groups of 3), on the channel with
    kappa 5 and upwind 0.5, 6 steps: within 1e-12 of scale, d(dt) to 1e-10."""
    smj, smp, stj, stp, _, _ = tracer_lattice(16, 3, channel=True)
    sj = smj.struct_mesh
    n, rt, b, kappa, upwind = 6, 2, 3, 5.0, 0.5
    ny2, nx, k = sj.ny2, sj.nx, stj.layer_thickness.shape[-1]
    dtype = stj.layer_thickness.dtype
    g = _random_cotangent(stp, 13)
    gj = _jax(stj, g)
    cot, dscal, _, _ = _pallas_tiled_adjoint(
        _tiled_scal(sj, DT, dtype), stj.ssh[..., None], stj.layer_thickness,
        stj.normal_velocity.reshape(6, ny2, nx, k), sj.f_edge.reshape(6, ny2, nx, 1),
        sj.resting_thickness_sum[..., None],
        (gj.ssh[..., None], gj.layer_thickness, gj.normal_velocity.reshape(6, ny2, nx, k),
         _tr_planes(gj.tracers, ny2, nx, k)),
        sj.edge_mask.reshape(6, ny2, nx, 1).astype(dtype), terms=sj.coriolis_terms,
        row_tile=rt, n_steps=n, b=b, interpret=True, q=1,
        tracers0=_tr_planes(stj.tracers, ny2, nx, k),
        cmask=sj.cell_mask.reshape(2, ny2, nx, 1).astype(dtype), tropts=(kappa, upwind))
    ref = _cot_from_planes(cot, ny2, nx, k)
    d, d_dt = tiled_adjoint_rollout(stp, smp.struct_mesh, DT, n, _port(g), plan=(rt, 4, 1, b),
                                    tracer_kappa=kappa, tracer_upwind=upwind)
    _assert_state(d, ref, 1e-12)
    np.testing.assert_allclose(float(d_dt), float(dscal[0]), rtol=1e-10)


def test_fused_adjoint_rollout_with_tracers_matches_pallas_adjoint_segments():
    """fused_adjoint_rollout with tracers against pallas_adjoint_rollout
    (plan (2, 3), interpret mode, kappa 5: tests/test_tracers.py:356-393) for
    the output cotangent of sum ssh^2 + sum T^2 after 6 steps, within 1e-12
    of scale, d(dt) to 1e-10."""
    smj, smp, stj, stp, _, _ = tracer_lattice(16, 3)
    n = 6
    out = structured_step(stp, smp.struct_mesh, DT, tracer_kappa=5.0)
    for _ in range(n - 1):
        out = structured_step(out, smp.struct_mesh, DT, tracer_kappa=5.0)
    g = {f: np.zeros(tuple(getattr(out, f).shape)) for f in FIELDS}
    g["ssh"], g["tracers"] = 2 * out.ssh.numpy(), 2 * out.tracers.numpy()
    ref, ref_dt = pallas_adjoint_rollout(stj, smj.struct_mesh, DT, n, _jax(stj, g), plan=(2, 3),
                                         interpret=True, tracer_kappa=5.0, tracer_upwind=1.0)
    d, d_dt = fused_adjoint_rollout(stp, smp.struct_mesh, DT, n, _port(g), plan=3,
                                    tracer_kappa=5.0)
    _assert_state(d, ref, 1e-12)
    np.testing.assert_allclose(float(d_dt), float(ref_dt), rtol=1e-10)


def _objective(out):
    return (out.ssh ** 2).sum() + (out.tracers ** 2).sum()


@pytest.mark.parametrize("channel", [False, True])
def test_slice_gradient_matches_jax_grad(channel):
    """grad of sum ssh^2 + sum T^2 over 7 steps w.r.t. the state (tracers
    among it) and dt, through auto_rollout_diff (the CPU route: plain steps
    and plain reverse steps in checkpoint groups), against jax.grad through
    pallas_rollout_diff (the checkpointed roll reverse on the CPU), kappa 5
    and upwind 0.5: rtol 1e-10."""
    smj, smp, stj, stp, _, _ = tracer_lattice(16, 3, channel)
    n, kw = 7, dict(tracer_kappa=5.0, tracer_upwind=0.5)

    def obj_jax(s, dt):
        out = pallas_rollout_diff(s, smj.struct_mesh, dt, n, **kw)
        return jnp.sum(out.ssh ** 2) + jnp.sum(out.tracers ** 2)

    r_s, r_dt = jax.grad(obj_jax, argnums=(0, 1))(stj, jnp.float64(DT))
    x = [getattr(stp, f).clone().requires_grad_(True) for f in FIELDS]
    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    loss = _objective(auto_rollout_diff(StructState(*x), smp.struct_mesh, dt, n, plan=3, **kw))
    grads = torch.autograd.grad(loss, x + [dt])
    for f, got in zip(FIELDS, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(r_s, f)), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(getattr(r_s, f))).max())
    np.testing.assert_allclose(float(grads[4]), float(r_dt), rtol=1e-10)


def test_slice_gradient_matches_finite_differences():
    """The directional derivative of sum ssh^2 + sum T^2 after 5 steps along
    a random direction in (state, tracers, dt), by central differences with
    Richardson's extrapolation (as tests/test_torch_adjoint.py), against the
    gradient of auto_rollout_diff: within 1e-8 of it. Centered tracer
    fluxes (upwind 0) with kappa 5: the upwind term's sign(F) jumps where a
    step's u crosses 0, which a perturbed run's u does at some edge, and a
    difference across a jump is no derivative (the upwind arms are held
    against jax.grad above)."""
    _, smp, _, stp, _, _ = tracer_lattice(16, 3)
    n, mesh, kw = 5, smp.struct_mesh, dict(tracer_kappa=5.0, tracer_upwind=0.0)
    rng = np.random.default_rng(22)
    base = [getattr(stp, f) for f in FIELDS]
    v = [torch.from_numpy(rng.normal(size=tuple(x.shape))) * x.abs().max() for x in base]
    v_dt = 0.5

    def objective(eps):
        s = StructState(*(x + eps * vx for x, vx in zip(base, v)))
        return float(_objective(auto_rollout_diff(s, mesh, DT + eps * v_dt, n, **kw)))

    x = [b.clone().requires_grad_(True) for b in base]
    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    grads = torch.autograd.grad(_objective(auto_rollout_diff(StructState(*x), mesh, dt, n,
                                                             **kw)), x + [dt])
    directional = sum(float((gx * vx).sum()) for gx, vx in zip(grads, v))
    directional += float(grads[4]) * v_dt

    def central(eps):
        return (objective(eps) - objective(-eps)) / (2 * eps)

    eps = 1e-4
    fd = (4 * central(eps / 2) - central(eps)) / 3
    assert abs(fd - directional) <= 1e-8 * abs(directional)


def test_reverse_planners_reckon_the_tracer_planes():
    """adjoint_step.smem_bytes and the tiled adjoint's window add 2 nT
    planes of the level chunk to the primal and to the cotangent chunk; the
    tracer arms' tiles fit one block (their launch bounds give one block
    per SM); tiled_adjoint_plan runs them at q = 1 and counts the tracer
    planes in the states its groups keep."""
    from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import tiled_adjoint_plan
    from mpas_ocean_tpu_torch.structured.tiled_diff import adjoint_window_bytes

    k, itemsize = 100, 4
    _, kc = fe_step.level_split(k)
    for tile in ((4, 8), (2, 8)):
        sites = (tile[0] + 2) * (tile[1] + 4)
        assert (adjoint_step.smem_bytes(tile, k, itemsize, n_tracers=2)
                - adjoint_step.smem_bytes(tile, k, itemsize)) == itemsize * sites * 2 * 4 * kc
        assert (adjoint_window_bytes(*tile, 1, (1, 2), k, itemsize, n_tracers=2)
                - adjoint_window_bytes(*tile, 1, (1, 2), k, itemsize)) \
            == itemsize * sites * 2 * 4 * kc
        assert (tiled_adjoint.smem_bytes(sites, tile[0] * tile[1], k, 1, itemsize, n_tracers=2)
                == adjoint_window_bytes(*tile, 1, (1, 2), k, itemsize, n_tracers=2))
    for n_tr in (1, 2, 4):
        tile = adjoint_step.adjoint_tile(128, 256, k, itemsize, n_tr)
        assert adjoint_step.smem_bytes(tile, k, itemsize, n_tracers=n_tr) <= fe_step.SMEM_BYTES
    assert adjoint_step.adjoint_tile(128, 256, k, itemsize, 0) == adjoint_step.adjoint_tile(
        128, 256, k, itemsize)
    rt, ct, q, group = tiled_adjoint_plan(128, 256, k, itemsize, 100, halo=(1, 2), n_tracers=2)
    assert q == 1 and 128 % rt == 0 and 256 % ct == 0 and group == 10
    assert adjoint_window_bytes(rt, ct, 1, (1, 2), k, itemsize, n_tracers=2) <= fe_step.SMEM_BYTES
    state = itemsize * 2 * 128 * 256 * (1 + 4 * k + 2 * k)
    with pytest.raises(ValueError):  # 10 checkpoints and 10 slots of 6-plane states
        tiled_adjoint_plan(128, 256, k, itemsize, 100, halo=(1, 2), n_tracers=2,
                           budget=20 * state - 1)
    tiled_adjoint_plan(128, 256, k, itemsize, 100, halo=(1, 2), n_tracers=2, budget=20 * state)
    with pytest.raises(ValueError):
        adjoint_step.adjoint_tile(128, 256, k, 8, 100)


def test_card_routes_pass_the_tracer_operands(monkeypatch):
    """A CPU rehearsal of the card's tracer reverse: with the kernel library
    stubbed by functions that check each call's argument count and types
    against its argtypes, the card's steps (fe_step's rollout and stack
    entries, adjoint_step's and tiled_adjoint's tracer arms) run a 7-step
    sweep in groups of 3 on a channel, and every launch counts as a tracer
    launch: 7 forward, 4 rebuild and 7 reverse launches per route."""
    import contextlib
    import ctypes
    from types import SimpleNamespace

    from mpas_ocean_tpu_torch.kernels import adjoint_step, build, fe_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import diff_model, tiled_diff

    class Entry:
        def __init__(self):
            self.argtypes = None

        def __call__(self, *args):
            assert len(args) == len(self.argtypes)
            for a, t in zip(args, self.argtypes):
                want = {ctypes.c_void_p: (int, type(None)), ctypes.c_double: (float,),
                        ctypes.c_int: (int,)}[t]
                assert isinstance(a, want) and not isinstance(a, bool)
            return 0

    class Lib:
        def __getattr__(self, name):
            setattr(self, name, Entry())
            return getattr(self, name)

    lib = Lib()
    monkeypatch.setattr(build, "load", lambda: lib)

    def dims(h, name="fe_step"):
        return tuple(h.shape[1:])

    for m in (fe_step, adjoint_step, tiled_adjoint):
        monkeypatch.setattr(m, "lattice_dims", dims)
        monkeypatch.setattr(m, "launches", 0)
        monkeypatch.setattr(m, "tracer_launches", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    _, smp, _, stp, _, _ = tracer_lattice(16, 4, channel=True)
    sm = smp.struct_mesh
    st = diff_model._planes_state(stp)
    like = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float64)
    kw = dict(tracers=True, tracer_kappa=5.0, tracer_upwind=0.5)
    for steps in (diff_model._Steps(sm, DT, like, **kw),
                  tiled_diff._TiledSteps(sm, DT, like, (4, 8, 1, 3), **kw)):
        steps.cuda = True
        final, ckpts = diff_model._forward(st, sm, DT, 7, 3, False, None, (5.0, 0.5),
                                           steps=steps)
        d, _ = diff_model._reverse(steps, ckpts, 7, 3, stp, final)
        assert d.tracers.shape == stp.tracers.shape
    counts = [(m.launches, m.tracer_launches) for m in (fe_step, adjoint_step, tiled_adjoint)]
    assert counts == [(22, 22), (7, 7), (7, 7)]
