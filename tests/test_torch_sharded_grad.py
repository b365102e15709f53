"""The port's row-sharded model's gradients and its superstep against the
JAX package, on CPU slabs at f64: ``objective`` (the per-step path under
torch.autograd) and ``objective_pallas`` (a torch.autograd.Function per
superstep whose backward replays the plain superstep) against ``jax.grad``
of the JAX roll model's global Sum ssh^2 (and, in two cases, the port's
global rollout's autograd), with respect to the state and, through
``scatter_forcing`` / ``gather_forcing_grad``, to the forcing; and
one direct call of JAX's ``ShardedStructuredModel.run_pallas`` in
interpret mode (2 devices, 8 x 8, q = 2) against the port's superstep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.sharded import ShardedStructuredModel as JaxSharded
from mpas_ocean_tpu_torch.structured import ShardedStructuredModel, structured_run_loop
from mpas_ocean_tpu_torch.structured.slab import reach

from torch_port_cases import full_lattice, max_rel_err, port_local

CPU = torch.device("cpu")
DT = 5.0
N_STEPS = 4
TR_KW = dict(tracer_kappa=5.0, tracer_upwind=0.7)
FIELDS = ("ssh", "layer_thickness", "normal_velocity", "tracers")


def _bare(st):
    return type(st)(st.ssh, st.layer_thickness, st.normal_velocity)


def _grads(model, local, name, **kw):
    """The gathered gradient of ``model.<name>`` (Sum ssh^2) with respect to
    the slab dict ``local`` (0 where a field does not reach the objective)."""
    local = {k: [x.requires_grad_() for x in v] for k, v in local.items()}
    getattr(model, name)(local, DT, N_STEPS, **kw).backward()
    return model.gather({k: [torch.zeros_like(x) if x.grad is None else x.grad for x in v]
                         for k, v in local.items()})


def _port_grad(st, sm, **kw):
    """The gradient of Sum ssh_final^2 of the port's global rollout
    (structured_run_loop, itself held to the JAX roll model at f64 by
    tests/test_torch_composed.py) by torch.autograd."""
    leaves = [None if x is None else x.clone().requires_grad_() for x in
              (st.ssh, st.layer_thickness, st.normal_velocity, st.tracers)]
    out = structured_run_loop(type(st)(*leaves), sm, DT, N_STEPS, **kw)
    (out.ssh ** 2).sum().backward()
    return type(st)(*(None if x is None else torch.zeros_like(x) if x.grad is None else x.grad
                      for x in leaves))


# (options, FB, channel, slabs, reference): jax.grad of the JAX roll model's
# global rollout (jitted), or the port's global rollout's autograd
@pytest.mark.parametrize("opts, fb, channel, parts, ref_by", [
    ("", False, False, 1, "jax"), ("NFTS", True, True, 2, "jax"),
    ("", True, True, 2, "port"), ("N", False, False, 2, "port"),
])
def test_objective_grads_match_global_grad(opts, fb, channel, parts, ref_by):
    """The gradient of Sum ssh_final^2 over N_STEPS steps with respect to
    the state (the tracers too: 0, the objective does not see them) through
    ``objective`` and through ``objective_pallas`` (q = 2, or 1 where the
    slab holds no 2-step halo) over ``parts`` slabs, each within 1e-11 of
    the global rollout's: ``jax.grad`` of the JAX roll model's, or the
    port's by torch.autograd."""
    smj, smp, stj, stp, (fj, fp), (sj, sp) = full_lattice(16, 4, channel)
    tracers = "T" in opts
    stj, stp = (stj, stp) if tracers else (_bare(stj), _bare(stp))
    kwj = dict(nonlinear="N" in opts, fb=fb, forcing=fj if "F" in opts else None,
               strat=sj if "S" in opts else None, **TR_KW)
    kwp = dict(kwj, forcing=fp if "F" in opts else None, strat=sp if "S" in opts else None)
    if ref_by == "jax":
        ref = jax.grad(lambda s: jnp.sum(jax_run_loop(s, smj.struct_mesh, DT, N_STEPS,
                                                      **kwj).ssh ** 2))(stj)
    else:
        ref = _port_grad(stp, smp.struct_mesh, **kwp)
    model = ShardedStructuredModel(smp.struct_mesh, [CPU] * parts)
    q = 2 if 2 * reach(fb, "N" in opts) <= model.rows else 1
    for name, extra in (("objective", {}), ("objective_pallas", {"q": q})):
        g = _grads(model, model.scatter(stp), name, **kwp, **extra)
        for f in FIELDS:
            r = getattr(ref, f)
            if r is not None:
                assert float(np.abs(getattr(g, f).numpy() - np.asarray(r)).max()) <= 1e-11, (
                    name, f)


def test_forcing_grad_matches_jax_grad():
    """The gradient with respect to a ``scatter_forcing`` slab dict through
    ``objective`` (2 slabs, the linear FE core forced), gathered by
    ``gather_forcing_grad``: the wind, the level masks and the three
    coefficients within 1e-11 of their scale of ``jax.grad`` of the JAX roll
    model's global rollout with respect to its lattice Forcing."""
    smj, smp, stj, stp, (fj, fp), _ = full_lattice(16, 4)
    stj, stp = _bare(stj), _bare(stp)
    ref = jax.grad(lambda f: jnp.sum(jax_run_loop(stj, smj.struct_mesh, DT, N_STEPS,
                                                  forcing=f).ssh ** 2))(fj)
    model = ShardedStructuredModel(smp.struct_mesh, [CPU] * 2)
    fl = model.scatter_forcing(fp)
    fl = {k: [x.requires_grad_() for x in v] for k, v in fl.items()}
    model.objective(model.scatter(stp), DT, N_STEPS, forcing=fl).backward()
    got = model.gather_forcing_grad({k: [x.grad for x in v] for k, v in fl.items()}, fp)
    for f in ("wind_edge", "top_mask", "bottom_mask", "drag_linear", "drag_quadratic",
              "rayleigh"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        assert float(np.abs(a - b).max()) <= 1e-11 * max(1.0, float(np.abs(b).max())), f


def test_run_pallas_matches_jax_run_pallas_interpret():
    """One direct call of JAX's superstep, ``run_pallas(interpret=True)``
    (the Pallas tile kernel in interpret mode; 2 devices, 8 x 8 x 4, q = 2,
    4 steps), against the port's on 2 CPU slabs (the kernel's plain
    version): the slab dicts, halos included, within 1e-12 of their scale."""
    smj, smp, stj, stp, _, _ = full_lattice(8, 4)
    jm = JaxSharded(smj.struct_mesh, devices=jax.devices()[:2])
    pm = ShardedStructuredModel(smp.struct_mesh, [CPU] * 2)
    ref = port_local(jm.run_pallas(jm.scatter(_bare(stj)), DT, N_STEPS, q=2, interpret=True))
    out = pm.run_pallas(pm.scatter(_bare(stp)), DT, N_STEPS, q=2)
    assert set(out) == set(ref)
    for key in ref:
        for a, b in zip(out[key], ref[key]):
            assert a.shape == b.shape
            assert max_rel_err(a.numpy(), b.numpy()) <= 1e-12, key
