"""tiled_adjoint's tracer and stratified arms at q > 1 (csrc/tiled_adjoint.cu,
kMulti with kTracers and kStrat), alone and with each other and with
forcing, against the plain reverse on the kernel's own states, on a CUDA
card; the q = 2 gradient's dot-product identity through tiled_rollout_diff.
These tests skip on machines without a card. They import no JAX, so on a
GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_window_adjoint_kernel.py
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu_torch.kernels import tiled_adjoint
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
N_SS = 3  # supersteps a reverse runs
TILE = (2, 4)
# the linear core's tracer (T) and stratified (S) arms, alone, together and
# with forcing (F)
OPTS = ("T", "S", "TS", "FT", "FS", "FTS")


def _cotangent(st, seed=11):
    rng = np.random.default_rng(seed)
    return StructState(*(None if getattr(st, f) is None else torch.from_numpy(
        rng.normal(size=tuple(getattr(st, f).shape))).to(getattr(st, f)) for f in TRACER_FIELDS))


def _run(model, st, opts, forcing, strat, g, q, full=None):
    """(the kernel's reverse of N_SS supersteps of q steps through the
    supersteps' starts, the stack of every step's state it was cut from)."""
    sm = model.struct_mesh
    st = composed_state(st, opts)
    if full is None:
        full = composed_stack(composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat),
                              st, N_SS * q)
    steps = composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat, (*TILE, q))
    return composed_reverse(steps, superstep_stack(full, q), composed_state(g, opts), N_SS), full


@pytest.mark.parametrize("k, q", [(4, 2), (4, 3), (36, 2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("opts", OPTS)
def test_tiled_reverse_q_arms_match_plain_f64(cuda, opts, masked, k, q):
    """N_SS reverse supersteps of q steps on (2, 4) tiles through the
    kernel-built states of a random f64 32 x 32 state (forced with random
    winds, levels and coefficients, two tracers at kappa 5 and upwind 0.5, a
    dense W, as the combination says) against the plain reverse of every
    step: every cotangent (the tracers', d(wind) among them) within 1e-12
    of its scale, d(dt), d(r_lin, Cd, lambda) and d(W) within 1e-12 of their
    Cauchy-Schwarz scales; a rerun bitwise equal; N_SS launches in every
    arm's counter; each run with one option dropped at least 100x off."""
    model, st, forcing, strat = composed_case(opts, 32, k, masked, cuda)
    sm = model.struct_mesh
    g = _cotangent(st)
    names = ("launches", "forced_launches", "tracer_launches", "strat_launches")
    for c in names:
        setattr(tiled_adjoint, c, 0)
    out, full = _run(model, st, opts, forcing, strat, g, q)
    assert [getattr(tiled_adjoint, c) for c in names] == [N_SS] + [N_SS * (o in opts)
                                                                   for o in "FTS"]
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
                       None if drop == "T" else full)
        miss = max(float((getattr(bare[0], f) - getattr(ref[0], f)).abs().max()
                         / getattr(ref[0], f).abs().max())
                   for f in TRACER_FIELDS if getattr(bare[0], f) is not None)
        assert miss >= 100 * 1e-12, (drop, miss)


@pytest.mark.parametrize("masked", [False, True])
def test_q2_gradient_dot_product_identity(cuda, masked):
    """The f64 q = 2 gradient through tiled_rollout_diff (plan (2, 4, 2, 1),
    6 steps, forcing, two tracers and a dense W): <J v, g> against
    <v, J^T g> within 1e-12, with directions in the state, the tracers, W,
    the wind and the coefficients, J v by forward-mode AD of the plain
    rollout; 3 tiled_adjoint launches, each forced, tracer and stratified."""
    model, st, forcing, strat = composed_case("FTS", 32, 6, masked, cuda)
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
        out = structured_run_loop(StructState(*xs[:4]), sm, DT, 6, forcing=f,
                                  strat=Stratification(xs[8], strat.densities), **kw)
        return tuple(getattr(out, f) for f in TRACER_FIELDS)

    _, jv = torch.func.jvp(rollout, prim, tang)
    lhs = sum(float((x * getattr(gbar, f)).sum()) for x, f in zip(jv, TRACER_FIELDS))
    for c in ("launches", "forced_launches", "tracer_launches", "strat_launches"):
        setattr(tiled_adjoint, c, 0)
    x = [p.clone().requires_grad_(True) for p in prim]
    f = Forcing(x[4], forcing.top_mask, forcing.bottom_mask, *x[5:8])
    out = tiled_rollout_diff(StructState(*x[:4]), sm, DT, 6, forcing=f,
                             strat=Stratification(x[8], strat.densities), plan=(*TILE, 2, 1),
                             **kw)
    inner = sum((getattr(out, f) * getattr(gbar, f)).sum() for f in TRACER_FIELDS)
    jtg = torch.autograd.grad(inner, x)
    rhs = sum(float((t * d).sum()) for t, d in zip(tang, jtg))
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs), (lhs, rhs)
    assert [tiled_adjoint.launches, tiled_adjoint.forced_launches, tiled_adjoint.tracer_launches,
            tiled_adjoint.strat_launches] == [3] * 4
