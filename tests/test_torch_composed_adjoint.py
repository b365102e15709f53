"""The port's composed reverse against the JAX package's, on the CPU at f64
(numpy-seeded inputs, 16 x 16 lattices of 4 levels, two tracers):

* the slice as a whole with all four options (the nonlinear core, forcing,
  tracers and stratification: NFTS): ``torch.autograd.grad`` of
  sum ssh^2 + sum T^2 through ``auto_rollout_diff`` against ``jax.grad``
  through ``pallas_rollout_diff`` (the checkpointed roll reverse on the
  CPU), w.r.t. the state, dt, W, the wind and the three coefficients,
  periodic and on the channel;
* the port's plain fused adjoint rollout with all four options against the
  JAX Pallas adjoint segments (``pallas_adjoint_rollout``, which runs
  ``_pallas_adjoint_from_ckpts``) in interpret mode;
* a CPU rehearsal of the card's routes for each of the 11 combinations of
  two or more options (the kernel library stubbed by functions that check
  each call's argument count and types): every wrapper gets its arms'
  operands, and every launch is counted in its arms' counters;
* the reverse planners count every arm's shared memory.

The CUDA composed reverse arms are held against the plain reverse on the
card (tests/test_torch_composed_adjoint_kernel.py, chip_smoke.py phase 20).
"""

import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.models import stratification as jax_strat
from mpas_ocean_tpu.models.tracers import make_tracers as jax_make_tracers
from mpas_ocean_tpu.structured.pallas_model import pallas_adjoint_rollout, pallas_rollout_diff
from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
from mpas_ocean_tpu_torch.models import Stratification
from mpas_ocean_tpu_torch.models.forcing import Forcing
from mpas_ocean_tpu_torch.structured import (
    StructState,
    auto_rollout_diff,
    diff_model,
    fused_adjoint_rollout,
    struct_state_from_numpy,
    tiled_adjoint_plan,
    tiled_diff,
)
from mpas_ocean_tpu_torch.structured.tiled_diff import adjoint_window_bytes

from test_torch_strat_adjoint import K, _forcings, _lattice, _strats
from torch_port_cases import FULL_FORCING, STATE_FIELDS, max_rel_err, nl_channel, stub_card

DT = 5.0
KAPPA, UPWIND = 5.0, 0.5
FIELDS = STATE_FIELDS + ("tracers",)
COEFS = ("drag_linear", "drag_quadratic", "rayleigh")

# the 11 combinations of two or more of the nonlinear core (N), forcing (F),
# tracers (T) and stratification (S)
COMBOS = ["".join(c) for n in (2, 3, 4) for c in itertools.combinations("NFTS", n)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("channel", [False, True])
def test_full_physics_gradient_matches_jax_grad(channel):
    """grad of sum ssh^2 + sum T^2 over 3 steps of the nonlinear, forced,
    stratified run with two tracers (kappa 5, upwind 0.5, a dense W) w.r.t.
    the state, dt, W, the wind and the three coefficients, through
    auto_rollout_diff on the CPU (the plain steps and the plain reverse in
    checkpoint groups of 2), against jax.grad through pallas_rollout_diff:
    rtol 1e-10, each cotangent nonzero."""
    smj, smp, stj, stp, mj, mp = _lattice(channel, tracers=True)
    sj, sp = _strats("dense")
    fj, fp = _forcings(smj, smp, mj, mp)
    n = 3

    def obj_jax(s, dt, w, f):
        out = pallas_rollout_diff(s, smj.struct_mesh, dt, n, True, KAPPA, UPWIND,
                                  jax_strat.Stratification(w, sj.densities), f)
        return jnp.sum(out.ssh ** 2) + jnp.sum(out.tracers ** 2)

    r_s, r_dt, r_w, r_f = jax.grad(obj_jax, argnums=(0, 1, 2, 3))(
        stj, jnp.float64(DT), sj.phi_weights, fj)
    x = [getattr(stp, f).clone().requires_grad_(True) for f in FIELDS]
    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    w = sp.phi_weights.clone().requires_grad_(True)
    fd = [getattr(fp, c).clone().requires_grad_(True) for c in ("wind_edge", *COEFS)]
    forcing = Forcing(fd[0], fp.top_mask, fp.bottom_mask, *fd[1:])
    out = auto_rollout_diff(StructState(*x), smp.struct_mesh, dt, n, plan=2, nonlinear=True,
                            forcing=forcing, tracer_kappa=KAPPA, tracer_upwind=UPWIND,
                            strat=Stratification(w, sp.densities))
    grads = torch.autograd.grad((out.ssh ** 2).sum() + (out.tracers ** 2).sum(),
                                x + [dt, w] + fd)
    wants = [getattr(r_s, f) for f in FIELDS] + [r_dt, r_w, r_f.wind_edge] + [
        getattr(r_f, c) for c in COEFS]
    names = list(FIELDS) + ["dt", "W", "wind", *COEFS]
    for name, got, want in zip(names, grads, wants):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max(), err_msg=name)


def _small_channel():
    """_lattice's channel with its two tracers on an 8 x 8 lattice: the JAX
    Pallas calls in interpret mode cost time by the site."""
    smj, smp, stj, stp, mj, mp = nl_channel(8, K, 3)
    x = np.asarray(mp.horz.cells.x)
    rng = np.random.default_rng(9)
    fields = [10.0 + 2.0 * np.sin(2 * np.pi * x / (x.max() + 1))[:, None]
              + 0.3 * rng.normal(size=(mp.n_cells, K)), np.full(mp.n_cells, 35.0)]
    progj = smj.from_struct(stj).replace(tracers=jax_make_tracers(mj, fields))
    progp = mt.PrognosticVars(*(getattr(smp.from_struct(stp), f) for f in STATE_FIELDS),
                              tracers=mt.make_tracers(mp, fields))
    return smj, smp, smj.to_struct(progj), smp.to_struct(progp), mj, mp


@pytest.mark.parametrize("route", ["fused_rollout_diff", "tiled_rollout_diff", "fused_step"])
def test_tracer_gradients_let_their_outputs_go(route):
    """Each gradient Function keeps the end state that a tracer reverse
    reads. Kept as the output tensors themselves, it would tie them to their
    own grad_fn through autograd's nodes, a cycle Python's collector cannot
    break: every tracer gradient would keep its outputs and checkpoints on
    the device for good. With all four options: once the gradient is taken
    and the caller drops the outputs, they are freed."""
    import gc
    import weakref

    _, smp, _, stp, _, mp = _lattice(False, tracers=True)
    _, sp = _strats("dense")
    forcing = smp.to_struct_forcing(mt.make_forcing(mp, **FULL_FORCING))
    x = [getattr(stp, f).clone().requires_grad_(True) for f in FIELDS]
    kw = dict(nonlinear=True, forcing=forcing, tracer_kappa=KAPPA, tracer_upwind=UPWIND,
              strat=sp)
    if route == "fused_step":
        out = diff_model.fused_step(StructState(*x), smp.struct_mesh, DT, **kw)
    elif route == "fused_rollout_diff":
        out = diff_model.fused_rollout_diff(StructState(*x), smp.struct_mesh, DT, 2, plan=2,
                                            **kw)
    else:
        out = tiled_diff.tiled_rollout_diff(StructState(*x), smp.struct_mesh, DT, 2,
                                            plan=(4, 8, 1, 2), **kw)
    torch.autograd.grad((out.ssh ** 2).sum() + (out.tracers ** 2).sum(), x)
    refs = [weakref.ref(getattr(out, f)) for f in FIELDS]
    del out
    gc.collect()
    assert all(r() is None for r in refs)


def test_fused_adjoint_rollout_full_physics_matches_pallas_adjoint_segments():
    """fused_adjoint_rollout with the nonlinear core, forcing, two tracers
    and a dense W (groups of 2) against pallas_adjoint_rollout(plan=(1, 2),
    interpret=True) with the same options, for a random output cotangent
    after 4 steps on an 8 x 8 channel: the state's cotangent (the tracers'
    among it) within 1e-12 of scale, d(dt), d(wind) and d(coefs) to 1e-10 of
    theirs (d(W) is dropped by both)."""
    smj, smp, stj, stp, mj, mp = _small_channel()
    sj, sp = _strats("dense")
    fj, fp = _forcings(smj, smp, mj, mp)
    n = 4
    rng = np.random.default_rng(17)
    g = {f: rng.normal(size=tuple(getattr(stp, f).shape)) for f in FIELDS}
    ref, ref_dt, ref_f = pallas_adjoint_rollout(
        stj, smj.struct_mesh, DT, n, stj.replace(**{f: jnp.asarray(v) for f, v in g.items()}),
        plan=(1, 2), interpret=True, nonlinear=True, tracer_kappa=KAPPA, tracer_upwind=UPWIND,
        strat=sj, forcing=fj)
    res = fused_adjoint_rollout(stp, smp.struct_mesh, DT, n, struct_state_from_numpy(g), plan=2,
                                nonlinear=True, forcing=fp, tracer_kappa=KAPPA,
                                tracer_upwind=UPWIND, strat=sp)
    assert len(res) == 3
    for f in FIELDS:
        err = max_rel_err(getattr(res[0], f).numpy(), np.asarray(getattr(ref, f)))
        assert err <= 1e-12, (f, err)
    np.testing.assert_allclose(float(res[1]), float(ref_dt), rtol=1e-10)
    assert _rel(res[2].wind.reshape(np.asarray(ref_f.wind_edge).shape).numpy(),
                ref_f.wind_edge) <= 1e-10
    for c, got in zip(COEFS, res[2].coefs):
        np.testing.assert_allclose(float(got), float(getattr(ref_f, c)), rtol=1e-10)


@pytest.mark.parametrize("combo", COMBOS)
def test_card_routes_pass_the_composed_operands(monkeypatch, combo):
    """A CPU rehearsal of the card's composed reverse for one combination:
    with the kernel library stubbed, the card's steps of both routes
    (diff_model._Steps; tiled_diff._TiledSteps at q = 1) run a 7-step sweep
    in groups of 3 on the channel. fe_step runs 7 forward and 4 rebuild
    launches per route, the reverse 7 per route (the nonlinear reverse
    kernel for both routes with N; adjoint_step and tiled_adjoint without),
    each counted in its arms' counters; every entry gets the wind, the
    tracer planes and W where its arms' pointers go (the forward steps', the
    stack rebuild's and the reverse's), the reverse the tracer count and
    d(W)'s accumulators; the sweep returns the ForcingCot and d(W)."""
    lib = stub_card(monkeypatch)
    nonlinear, forced, tracers, strat = (c in combo for c in "NFTS")
    smj, smp, stj, stp, mj, mp = _lattice(channel=True, tracers=tracers)
    sm = smp.struct_mesh
    fp = _forcings(smj, smp, mj, mp)[1] if forced else None
    sp = _strats("dense")[1] if strat else None
    like = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float64)
    kw = dict(nonlinear=nonlinear, forcing=fp, strat=sp, tracers=tracers, tracer_kappa=KAPPA,
              tracer_upwind=UPWIND)
    state = diff_model._planes_state(stp)
    for steps in (diff_model._Steps(sm, DT, like, **kw),
                  tiled_diff._TiledSteps(sm, DT, like, (4, 8, 1, 3), **kw)):
        final, ckpts = diff_model._forward(state, sm, DT, 7, 3, nonlinear, fp, (KAPPA, UPWIND),
                                           steps=steps, strat=sp)
        res = diff_model._reverse(steps, ckpts, 7, 3, stp, final)
        assert len(res) == 2 + forced + strat
        assert (res[0].tracers is not None) == tracers
        if forced:
            assert res[2].wind.shape == (3, 2, sm.ny2, sm.nx) and res[2].coefs.shape == (3,)
        if strat:
            assert res[-1] is steps.dstrat and tuple(res[-1].shape) == (K, K)
    arms = (forced, tracers, strat)
    count = lambda m, pre="": [getattr(m, f"{pre}launches")] + [  # noqa: E731
        getattr(m, f"{pre}{a}_launches") for a in ("forced", "tracer", "strat")]
    assert count(fe_step) == [22] + [22 * a for a in arms]
    want_nl, want_lin = ([14] + [14 * a for a in arms], [0] * 4) if nonlinear else \
        ([0] * 4, [7] + [7 * a for a in arms])
    assert count(adjoint_step, "nl_") == want_nl
    assert count(adjoint_step) == want_lin and count(tiled_adjoint) == want_lin
    n_tr = 2 if tracers else 0
    wind = steps.kf.wind.data_ptr() if forced else None
    w = steps.sw.data_ptr() if strat else None

    def check(entry, at_wind, at_tr, at_w):
        assert entry.calls
        for c in entry.calls:
            assert c[at_wind] == wind and (c[at_tr] is not None) == tracers and c[at_w] == w
            assert c[-2] == n_tr

    if nonlinear:
        check(lib.mot_fe_nl_steps_f64, 4, 20, 24)
        check(lib.mot_fe_nl_stack_f64, 4, 14, 16)
        check(lib.mot_nl_adjoint_f64, 3, 28, 35)
        assert all((c[36] is not None) == strat and (c[37] is not None) == strat
                   and (c[5] is not None) == forced for c in lib.mot_nl_adjoint_f64.calls)
    else:
        check(lib.mot_fe_steps_f64, 3, 16, 20)
        check(lib.mot_fe_stack_f64, 3, 10, 12)
        check(lib.mot_adjoint_rollout_f64, 2, 22, 29)
        check(lib.mot_tiled_adjoint_f64, 3, 25, 32)


def test_reverse_planners_count_every_arm():
    """The reverse planners size their tiles with every arm's shared memory:
    the nonlinear reverse's (nl_adjoint_smem_bytes) adds 4 values per tracer
    per window site-level and 6 (1 + 3 per tracer) per ring C site-level
    (the tracers' edges), the forced and stratified arms none (the
    stratified pass, a kernel of its own, fits a block at K = 100:
    strat_pass_smem_bytes); nl_adjoint_plan's plan fits with the arms, the
    composed plan never larger than the plain one's, and it raises where no
    tile fits; adjoint_step's smem adds the arms' parts
    and adjoint_tile's composed tile fits them; tiled_adjoint_plan sizes the
    linear composed window at q = 1 and the nonlinear one by
    nl_adjoint_plan over the tiles that divide the lattice."""
    k = 100
    for itemsize in (4, 8):
        for tile, ks in (((8, 8), 4), ((4, 8), 2), ((3, 5), 1)):
            (cm, ci), *_, (wm, wi) = adjoint_step.NL_ADJ_RINGS
            w = (tile[0] + 2 * wm) * (tile[1] + 2 * wi)
            c = (tile[0] + 2 * cm) * (tile[1] + 2 * ci)
            base = adjoint_step.nl_adjoint_smem_bytes(tile, itemsize, ks)
            assert adjoint_step.nl_adjoint_smem_bytes(tile, itemsize, ks, n_tracers=2) - base \
                == itemsize * (8 * w + 42 * c) * ks
        cb, kb = adjoint_step.strat_pass_fit(k, itemsize)
        assert kb == k
        assert adjoint_step.strat_pass_smem_bytes(k, cb, kb, itemsize) <= fe_step.SMEM_BYTES
        for n in (64, 256):
            rt, ct, ks = adjoint_step.nl_adjoint_plan(n // 2, n, k, itemsize, n_tracers=2,
                                                      strat=True)
            assert adjoint_step.nl_adjoint_smem_bytes((rt, ct), itemsize, ks, n_tracers=2) \
                <= fe_step.SMEM_BYTES
            plain = adjoint_step.nl_adjoint_plan(n // 2, n, k, itemsize)
            assert rt * ct * ks <= plain[0] * plain[1] * plain[2]
            for forced, n_tr, strat in itertools.product((False, True), (0, 2), (False, True)):
                tile = adjoint_step.adjoint_tile(n // 2, n, k, itemsize, n_tr, strat, forced)
                assert adjoint_step.smem_bytes(tile, k, itemsize, forced, n_tr, strat) \
                    <= fe_step.SMEM_BYTES
    with pytest.raises(ValueError):
        adjoint_step.nl_adjoint_plan(32, 64, k, 8, n_tracers=80)
    assert adjoint_step.smem_bytes((4, 8), k, 4, True, 2, True) == (
        adjoint_step.smem_bytes((4, 8), k, 4, n_tracers=2)
        + adjoint_step.smem_bytes((4, 8), k, 4, forced=True)
        + adjoint_step.smem_bytes((4, 8), k, 4, strat=True)
        - 2 * adjoint_step.smem_bytes((4, 8), k, 4))
    rt, ct, q, _ = tiled_adjoint_plan(128, 256, k, 4, 100, halo=(1, 2), n_tracers=2, strat=True,
                                      forced=True)
    assert q == 1 and 128 % rt == 0 and 256 % ct == 0
    assert adjoint_window_bytes(rt, ct, 1, (1, 2), k, 4, True, 2, True) <= \
        tiled_adjoint.SMEM_BYTES
    rt, ct, q, _ = tiled_adjoint_plan(32, 64, k, 4, 100, halo=(3, 4), nonlinear=True,
                                      n_tracers=2, strat=True)
    assert q == 1 and 32 % rt == 0 and 64 % ct == 0
    assert (rt, ct) == adjoint_step.nl_adjoint_plan(
        32, 64, k, 4, [(r, c) for r in (1, 2, 4, 8, 16, 32) for c in (1, 2, 4, 8, 16, 32, 64)],
        n_tracers=2, strat=True)[:2]


def test_composed_stack_rebuild_takes_every_arm(monkeypatch):
    """fe_step's stack entries (the gradient's rebuild) take the composed
    arms with either core: the linear stack with forcing, tracers and W
    together (no refusal), the nonlinear stack with them on the plan
    fe_nl_rollout takes for the same arms (so the slots are its states bit
    for bit); a tracer stack of the wrong slot count raises."""
    lib = stub_card(monkeypatch)
    smj, smp, stj, stp, mj, mp = _lattice(channel=True, tracers=True)
    sm = smp.struct_mesh
    fp = _forcings(smj, smp, mj, mp)[1]
    sp = _strats("dense")[1]
    like = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float64)
    steps = diff_model._Steps(sm, DT, like, nonlinear=True, forcing=fp, strat=sp, tracers=True,
                              tracer_kappa=KAPPA, tracer_upwind=UPWIND)
    state = diff_model._planes_state(stp)
    stack = diff_model._empty(state, 3)
    tr = steps.kernel_tracers(stack.tracers)
    fe_step.fe_fill_stack(diff_model._fields(stack)[:3], *steps.fwd, *steps.scal, 2,
                          live=steps.live, forcing=steps.kf, tracers=tr, strat_w=steps.sw)
    fe_step.fe_nl_fill_stack(diff_model._fields(stack)[:3], *steps.nl_fwd, *steps.nl_scal, 2,
                             live=steps.live, forcing=steps.kf, tracers=tr, strat_w=steps.sw)
    out = diff_model._empty(state)
    fe_step.fe_nl_rollout(*diff_model._fields(state)[:3], *steps.nl_fwd, *steps.nl_scal, 2,
                          live=steps.live, out=diff_model._fields(out)[:3], forcing=steps.kf,
                          tracers=steps.kernel_tracers(state.tracers), strat_w=steps.sw,
                          tr_out=out.tracers)
    stack_call, steps_call = lib.mot_fe_nl_stack_f64.calls[-1], lib.mot_fe_nl_steps_f64.calls[-1]
    assert stack_call[-5:-2] == steps_call[-5:-2]  # the plan: tile and slice
    assert lib.mot_fe_stack_f64.calls[-1][12] == steps.sw.data_ptr()
    with pytest.raises(ValueError):
        fe_step.fe_nl_fill_stack(diff_model._fields(stack)[:3], *steps.nl_fwd, *steps.nl_scal,
                                 2, live=steps.live, tracers=tr._replace(planes=tr.planes[:2]))
