"""The q-step nonlinear reverse kernel (csrc/nl_window_adjoint.cuh, kernel
4's nonlinear arm at q > 1), periodic and on the channel, alone and with
forcing, tracers and stratification in every combination, against the
plain reverse of every step on the kernel-built states, on a CUDA card; the
q = 2 nonlinear gradient's dot-product identity through tiled_rollout_diff.
These tests skip on machines without a card. They import no JAX, so on a
GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_nl_window_adjoint_kernel.py
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu_torch.kernels import adjoint_step, tiled_adjoint
from mpas_ocean_tpu_torch.models import Stratification
from mpas_ocean_tpu_torch.models.forcing import Forcing
from mpas_ocean_tpu_torch.structured import StructState, structured_run_loop, tiled_rollout_diff

from torch_gpu_cases import (  # noqa: F401 (fixture)
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
    superstep_stack,
)

pytestmark = pytest.mark.gpu

DT = 10.0
N_SS = 2  # supersteps a reverse runs
TILE = (2, 4)
# the nonlinear core (N) alone and with forcing (F), tracers (T) and
# stratification (S) in every combination
OPTS = ("N", "NF", "NT", "NS", "NFT", "NFS", "NTS", "NFTS")
COUNTERS = ("nl_window_launches", "nl_window_forced_launches", "nl_window_tracer_launches",
            "nl_window_strat_launches")


def _cotangent(st, seed=11):
    rng = np.random.default_rng(seed)
    return StructState(*(None if getattr(st, f) is None else torch.from_numpy(
        rng.normal(size=tuple(getattr(st, f).shape))).to(getattr(st, f)) for f in TRACER_FIELDS))


def _run(model, st, opts, forcing, strat, g, q, full=None, tile=TILE):
    """(the kernels' reverse of N_SS supersteps of q steps through the
    supersteps' starts, the stack of every step's state it was cut from);
    without N (a control) the linear reverse of every step through the
    fused route's steps."""
    sm = model.struct_mesh
    st = composed_state(st, opts)
    if full is None:
        full = composed_stack(composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat),
                              st, N_SS * q)
    if "N" not in opts:
        steps = composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat)
        return composed_reverse(steps, full, composed_state(g, opts), N_SS * q), full
    steps = composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat, (*tile, q))
    return composed_reverse(steps, superstep_stack(full, q), composed_state(g, opts), N_SS), full


def _counts():
    return [getattr(adjoint_step, c) for c in COUNTERS]


@pytest.mark.parametrize("n, k", [(16, 4), (32, 36)])
@pytest.mark.parametrize("q", [2, 3])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("opts", OPTS)
def test_nl_window_reverse_matches_plain_f64(cuda, opts, masked, q, n, k):
    """N_SS reverse supersteps of q nonlinear steps on (2, 4) tiles through
    the kernel-built states of a random f64 n x n state (u of 0.5 m/s;
    forced with random winds, levels and coefficients, two tracers at kappa
    5 and upwind 0.5, a dense W, as the combination says) against the plain
    reverse of every step: every cotangent (the tracers', d(wind) among
    them) within 1e-12 of its scale, d(dt), d(r_lin, Cd, lambda) and d(W)
    within 1e-12 of their Cauchy-Schwarz scales; a rerun bitwise equal;
    N_SS launches in every arm's counter, none of the q = 1 nonlinear
    reverse; each run with one option dropped (N: the linear reverse of
    every step) at least 100x off."""
    model, st, forcing, strat = composed_case(opts, n, k, masked, cuda)
    sm = model.struct_mesh
    g = _cotangent(st)
    for c in COUNTERS + ("nl_launches",):
        setattr(adjoint_step, c, 0)
    out, full = _run(model, st, opts, forcing, strat, g, q)
    assert _counts() == [N_SS] + [N_SS * (o in opts) for o in "FTS"]
    assert adjoint_step.nl_launches == 0
    again, _ = _run(model, st, opts, forcing, strat, g, q, full)
    ref, scales = plain_composed_reverse(full, g, sm, DT, N_SS * q, opts, forcing, strat)
    scales["d_dt"] = composed_ddt_scale(st, sm, DT, N_SS * q, g, opts, forcing, strat)
    errs = composed_errors(out, ref, scales)
    assert max(r for _, r in errs.values()) <= 1e-12, errs
    for a, b in zip(out, again):
        if isinstance(a, StructState):
            assert all(getattr(a, f) is None or torch.equal(getattr(a, f), getattr(b, f))
                       for f in TRACER_FIELDS)
        else:
            assert a is None or torch.equal(a, b)
    for drop in opts:
        bare, _ = _run(model, st, opts.replace(drop, ""), forcing, strat, g, q,
                       None if drop in "NT" else full)
        miss = max(float((getattr(bare[0], f) - getattr(ref[0], f)).abs().max()
                         / getattr(ref[0], f).abs().max())
                   for f in TRACER_FIELDS if getattr(bare[0], f) is not None)
        assert miss >= 100 * 1e-12, (drop, miss)


@pytest.mark.parametrize("masked", [False, True])
def test_nl_window_reverse_at_planned_tile(cuda, masked):
    """The NFTS arm at q = 2 on the tile nl_window_plan takes for a f64
    32 x 32 x 36 lattice (tiles that divide it), against the plain reverse
    within 1e-12 of every scale: the planner's tile runs."""
    model, st, forcing, strat = composed_case("NFTS", 32, 36, masked, cuda)
    sm = model.struct_mesh
    g = _cotangent(st)
    rt, ct, _ = adjoint_step.nl_window_plan(sm.ny2, sm.nx, 36, 8, n_tracers=2, strat=True,
                                            forced=True)
    out, full = _run(model, st, "NFTS", forcing, strat, g, 2, tile=(rt, ct))
    ref, scales = plain_composed_reverse(full, g, sm, DT, N_SS * 2, "NFTS", forcing, strat)
    scales["d_dt"] = composed_ddt_scale(st, sm, DT, N_SS * 2, g, "NFTS", forcing, strat)
    errs = composed_errors(out, ref, scales)
    assert max(r for _, r in errs.values()) <= 1e-12, ((rt, ct), errs)


@pytest.mark.parametrize("masked", [False, True])
def test_nl_q2_gradient_dot_product_identity(cuda, masked):
    """The f64 q = 2 nonlinear gradient through tiled_rollout_diff (plan (2,
    4, 2, 1), 6 steps, forcing, two tracers and a dense W): <J v, g> against
    <v, J^T g> within 1e-12, with directions in the state, the tracers, W,
    the wind and the coefficients, J v by forward-mode AD of the plain
    rollout; 3 launches of the q-step nonlinear reverse, each forced, tracer
    and stratified, and none of the linear tiled reverse or the q = 1
    nonlinear one."""
    model, st, forcing, strat = composed_case("NFTS", 32, 6, masked, cuda)
    sm = model.struct_mesh
    v, gbar = _cotangent(st, 18), _cotangent(st, 19)
    rng = np.random.default_rng(20)
    v_wind = torch.from_numpy(1e-4 * rng.normal(size=tuple(forcing.wind_edge.shape))).to(
        forcing.wind_edge)
    v_coefs = [torch.tensor(x, dtype=torch.float64, device=cuda) for x in (1e-4, 3e-4, 1e-5)]
    v_w = torch.from_numpy(0.05 * rng.normal(size=(6, 6))).to(st.ssh)
    prim = (*(getattr(st, f) for f in TRACER_FIELDS), forcing.wind_edge, forcing.drag_linear,
            forcing.drag_quadratic, forcing.rayleigh, strat.phi_weights.to(st.ssh))
    tang = (*(getattr(v, f) for f in TRACER_FIELDS), v_wind, *v_coefs, v_w)
    kw = dict(tracer_kappa=5.0, tracer_upwind=0.5)

    def rollout(*xs):
        f = Forcing(xs[4], forcing.top_mask, forcing.bottom_mask, *xs[5:8])
        out = structured_run_loop(StructState(*xs[:4]), sm, DT, 6, nonlinear=True, forcing=f,
                                  strat=Stratification(xs[8], strat.densities), **kw)
        return tuple(getattr(out, f) for f in TRACER_FIELDS)

    _, jv = torch.func.jvp(rollout, prim, tang)
    lhs = sum(float((x * getattr(gbar, f)).sum()) for x, f in zip(jv, TRACER_FIELDS))
    for c in COUNTERS + ("nl_launches",):
        setattr(adjoint_step, c, 0)
    tiled_adjoint.launches = 0
    x = [p.clone().requires_grad_(True) for p in prim]
    f = Forcing(x[4], forcing.top_mask, forcing.bottom_mask, *x[5:8])
    out = tiled_rollout_diff(StructState(*x[:4]), sm, DT, 6, nonlinear=True, forcing=f,
                             strat=Stratification(x[8], strat.densities), plan=(*TILE, 2, 1),
                             **kw)
    inner = sum((getattr(out, f) * getattr(gbar, f)).sum() for f in TRACER_FIELDS)
    jtg = torch.autograd.grad(inner, x)
    rhs = sum(float((t * d).sum()) for t, d in zip(tang, jtg))
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs), (lhs, rhs)
    assert _counts() == [3] * 4
    assert adjoint_step.nl_launches == 0 and tiled_adjoint.launches == 0
