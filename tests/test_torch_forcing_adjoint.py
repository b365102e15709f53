"""The port's forced reverse against the JAX package's, on the CPU at f64
(numpy-seeded inputs): the hand-written transpose of the forcing term in
the plain reverse step (linear and nonlinear, periodic and on the coastal
channel) against ``jax.vjp`` of the JAX forced step, with the cotangents of
the wind and of the three coefficients; the CPU routes of
``fused_rollout_diff``, ``tiled_rollout_diff`` (q = 1 and 2),
``auto_rollout_diff`` and ``fused_step`` with ``forcing=`` against
``jax.grad`` of ``pallas_rollout_diff(..., forcing=)``; the forced
forward-backward gradient through ``torch.autograd``. The CUDA forced
reverse arms are held against these plain versions on the card
(tests/test_torch_adjoint_kernel.py, tests/test_torch_tiled_adjoint_kernel.py,
chip_smoke.py phase 14).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.model import structured_step as jax_step
from mpas_ocean_tpu.structured.pallas_model import pallas_rollout_diff
from mpas_ocean_tpu_torch.models.forcing import Forcing
from mpas_ocean_tpu_torch.structured import (
    StructState,
    auto_rollout_diff,
    fused_adjoint_rollout,
    fused_rollout_diff,
    fused_step,
    structured_adjoint_run_loop,
    structured_adjoint_step,
    structured_nl_adjoint_step,
    structured_run_loop,
    tiled_rollout_diff,
)

from torch_port_cases import STATE_FIELDS, forced_lattice

DT = 5.0
COEFS = ("drag_linear", "drag_quadratic", "rayleigh")


def _rel(a, b) -> float:
    """max |a - b| / max |b|; max |a| where b is 0 throughout."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(np.abs(a).max())


def _cotangent(state, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=tuple(np.asarray(getattr(state, f)).shape)) for f in STATE_FIELDS]


@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("channel", [False, True])
def test_forced_adjoint_step_matches_jax_vjp(channel, nonlinear):
    """The plain forced reverse step against jax.vjp of the JAX forced
    structured_step with respect to the state, dt, the wind and the three
    coefficients: d_ssh, d_h, d_u, d(dt), d(wind), d(r_lin), d(Cd) and
    d(lambda) each within 1e-12 of its scale."""
    smj, smp, stj, stp, sfj, sfp = forced_lattice(16, 3, channel)

    def step(st, dt, wind, dlin, dquad, rayl):
        f = sfj.replace(wind_edge=wind, drag_linear=dlin, drag_quadratic=dquad, rayleigh=rayl)
        return jax_step(st, smj.struct_mesh, dt, nonlinear, forcing=f)

    _, vjp = jax.vjp(step, stj, DT, sfj.wind_edge, *(getattr(sfj, c) for c in COEFS))
    g = _cotangent(stj, 3)
    d_st, d_dt, d_wind, *d_coefs = vjp(stj.replace(**{f: jnp.asarray(x) for f, x in
                                                      zip(STATE_FIELDS, g)}))
    adj = structured_nl_adjoint_step if nonlinear else structured_adjoint_step
    got, got_dt, got_f = adj(stp, StructState(*(torch.from_numpy(x) for x in g)),
                             smp.struct_mesh, DT, sfp)
    for f in STATE_FIELDS:
        assert _rel(getattr(got, f).numpy(), getattr(d_st, f)) <= 1e-12, f
    assert _rel(got_dt, d_dt) <= 1e-12
    assert _rel(got_f.wind.numpy(), d_wind) <= 1e-12
    for i, want in enumerate(d_coefs):
        assert _rel(got_f.coefs[i], want) <= 1e-12, COEFS[i]


def _forcing_leaves(sfp):
    parts = [sfp.wind_edge.clone().requires_grad_(True)]
    parts += [getattr(sfp, c).clone().requires_grad_(True) for c in COEFS]
    return parts, Forcing(parts[0], sfp.top_mask, sfp.bottom_mask, *parts[1:])


@functools.lru_cache(maxsize=None)
def _jax_rollout_grads(channel: bool, n: int):
    """jax.grad of sum(ssh^2) after n forced steps of pallas_rollout_diff
    with respect to the state and the forcing, on forced_lattice(16, 3)."""
    smj, _, stj, _, sfj, _ = forced_lattice(16, 3, channel)

    def obj(st, f):
        out = pallas_rollout_diff(st, smj.struct_mesh, DT, n, False, 0.0, 1.0, None, f)
        return jnp.sum(out.ssh ** 2)

    return jax.grad(obj, argnums=(0, 1))(stj, sfj)


def _assert_grads(grads, gs, gf, tol=1e-12):
    for g, f in zip(grads[:3], STATE_FIELDS):
        assert _rel(g.numpy(), getattr(gs, f)) <= tol, f
    assert _rel(grads[3].numpy(), gf.wind_edge) <= tol
    for g, c in zip(grads[4:], COEFS):
        assert _rel(g.numpy(), getattr(gf, c)) <= tol, c


@pytest.mark.parametrize("route, kw", [
    ("fused", {"plan": 2}),
    ("tiled", {"plan": (4, 4, 1, 2)}),
    ("tiled", {"plan": (4, 8, 5, 1)}),
    ("auto", {}),
])
@pytest.mark.parametrize("channel", [False, True])
def test_forced_rollout_gradients_match_jax(channel, route, kw):
    """The gradient of sum(ssh^2) after 5 forced steps with respect to the
    state, the wind and the three coefficients through each CPU route
    (fused_rollout_diff in groups of 2, tiled_rollout_diff at q = 1 and 5,
    auto_rollout_diff) against jax.grad of pallas_rollout_diff with
    forcing (tests/test_forcing.py:412): 1e-12 of each scale."""
    _, smp, _, stp, _, sfp = forced_lattice(16, 3, channel)
    gs, gf = _jax_rollout_grads(channel, 5)
    xs = [getattr(stp, f).clone().requires_grad_(True) for f in STATE_FIELDS]
    parts, forcing = _forcing_leaves(sfp)
    fn = {"fused": fused_rollout_diff, "tiled": tiled_rollout_diff,
          "auto": auto_rollout_diff}[route]
    out = fn(StructState(*xs), smp.struct_mesh, DT, 5, forcing=forcing, **kw)
    _assert_grads(torch.autograd.grad((out.ssh ** 2).sum(), xs + parts), gs, gf)


def test_forced_reverse_routes_agree_and_give_no_mask_cotangents():
    """fused_adjoint_rollout with forcing equals the whole plain reverse
    (structured_adjoint_run_loop) to 1e-12, d(dt) and the forcing cotangent
    included; the level masks, which the kernels take as indices, get no
    cotangent (None, the JAX kernels' zeros)."""
    _, smp, _, stp, _, sfp = forced_lattice(16, 3)
    sm = smp.struct_mesh
    g = StructState(*(torch.from_numpy(x) for x in _cotangent(stp, 5)))
    a = fused_adjoint_rollout(stp, sm, DT, 7, g, plan=3, forcing=sfp)
    b = structured_adjoint_run_loop(stp, sm, DT, 7, g, forcing=sfp)
    for f in STATE_FIELDS:
        assert _rel(getattr(a[0], f).numpy(), getattr(b[0], f).numpy()) <= 1e-12, f
    assert _rel(a[1], b[1]) <= 1e-12
    assert _rel(a[2].wind.numpy(), b[2].wind.numpy()) <= 1e-12
    assert _rel(a[2].coefs.numpy(), b[2].coefs.numpy()) <= 1e-12
    mask = sfp.top_mask.clone().requires_grad_(True)
    wind = sfp.wind_edge.clone().requires_grad_(True)
    f = Forcing(wind, mask, sfp.bottom_mask, sfp.drag_linear, sfp.drag_quadratic, sfp.rayleigh)
    out = fused_rollout_diff(stp, sm, DT, 3, forcing=f)
    d_mask, d_wind = torch.autograd.grad((out.ssh ** 2).sum(), [mask, wind], allow_unused=True)
    assert d_mask is None and float(d_wind.abs().max()) > 0


def test_forced_fused_step_matches_jax():
    """fused_step with forcing (one step, its backward the plain forced
    reverse step on the CPU) against jax.grad of the JAX forced step, of
    sum(ssh^2) + sum(u^2) (one step's ssh does not read the old ssh)."""
    smj, smp, stj, stp, sfj, sfp = forced_lattice(16, 3)

    def obj(st, f):
        out = jax_step(st, smj.struct_mesh, DT, forcing=f)
        return jnp.sum(out.ssh ** 2) + jnp.sum(out.normal_velocity ** 2)

    gs, gf = jax.grad(obj, argnums=(0, 1))(stj, sfj)
    xs = [getattr(stp, f).clone().requires_grad_(True) for f in STATE_FIELDS]
    parts, forcing = _forcing_leaves(sfp)
    out = fused_step(StructState(*xs), smp.struct_mesh, DT, forcing=forcing)
    loss = (out.ssh ** 2).sum() + (out.normal_velocity ** 2).sum()
    _assert_grads(torch.autograd.grad(loss, xs + parts), gs, gf)


@pytest.mark.parametrize("nonlinear", [False, True])
def test_forced_fb_gradient_matches_jax(nonlinear):
    """The forced forward-backward rollout (6 steps) differentiated by
    torch.autograd through the plain steps against jax.grad of the JAX
    one, with respect to the state, the wind and the three coefficients:
    1e-12 of each scale."""
    smj, smp, stj, stp, sfj, sfp = forced_lattice(16, 3, channel=True)

    def obj(st, f):
        out = jax_run_loop(st, smj.struct_mesh, DT, 6, nonlinear, f, fb=True)
        return jnp.sum(out.ssh ** 2)

    gs, gf = jax.grad(obj, argnums=(0, 1))(stj, sfj)
    xs = [getattr(stp, f).clone().requires_grad_(True) for f in STATE_FIELDS]
    parts, forcing = _forcing_leaves(sfp)
    out = structured_run_loop(StructState(*xs), smp.struct_mesh, DT, 6, nonlinear=nonlinear,
                              fb=True, forcing=forcing)
    # FB never reads the old ssh (it takes the fresh one from h): its
    # cotangent is 0, which JAX returns and torch leaves unmaterialised
    _assert_grads(torch.autograd.grad((out.ssh ** 2).sum(), xs + parts,
                                      materialize_grads=True), gs, gf)
