"""The port's row-sharded model (mpas_ocean_tpu_torch/structured/sharded.py)
on CPU slabs against the JAX package's ShardedStructuredModel and its
global rollout, at f64 on numpy-seeded 16 x 16 x 4 lattices: the slab
layout (scatter, gather, checksum) bitwise; the per-step path ``run`` and
the superstep ``run_pallas`` (the received-halo kernel's plain version on
CPU slabs) over 1, 2 and 4 slabs, linear and nonlinear, FE and FB, with
forcing, tracers and stratification, periodic and on the channel, against
the JAX roll model's global rollout (run eagerly); one direct call of
JAX's ``run`` with ``step_stats`` and ``overlap_stats`` equal as dicts; the
refusals and the reduced-q warning against JAX's; the exchange counts and
the stale-halo control. The gradients are in tests/test_torch_sharded_grad.py,
the card's received-halo arm in tests/test_torch_sharded_kernel.py.
"""

import jax
import numpy as np
import pytest
import torch

from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.sharded import ShardedStructuredModel as JaxSharded
from mpas_ocean_tpu_torch.structured import ShardedStructuredModel, sharded
from mpas_ocean_tpu_torch.structured.slab import reach

from torch_port_cases import STATE_FIELDS, full_lattice, jax_local, max_rel_err, port_local

CPU = torch.device("cpu")
DT = 5.0
N_STEPS = 4
TR_KW = dict(tracer_kappa=5.0, tracer_upwind=0.7)


@pytest.fixture(scope="module", params=[False, True], ids=["periodic", "channel"])
def case16(request):
    return full_lattice(16, 4, request.param)


def _bare(st):
    return type(st)(st.ssh, st.layer_thickness, st.normal_velocity)


def _kw(opts, forcing, strat):
    return dict(nonlinear="N" in opts, forcing=forcing if "F" in opts else None,
                strat=strat if "S" in opts else None, **TR_KW)


def _errs(out, ref) -> dict:
    fields = STATE_FIELDS + (("tracers",) if ref.tracers is not None else ())
    return {f: max_rel_err(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
            for f in fields}


def test_scatter_gather_checksum_match_jax(case16):
    """scatter's slabs (with the tracers' planes) are the JAX package's bit
    for bit over 1, 2 and 4 slabs, gather(scatter(st)) is st, and checksum
    is JAX's sum of the slabs' own values; ny2 % P raises JAX's
    ValueError."""
    smj, smp, stj, stp, _, _ = case16
    for parts in (1, 2, 4):
        jm = JaxSharded(smj.struct_mesh, devices=jax.devices()[:parts])
        pm = ShardedStructuredModel(smp.struct_mesh, [CPU] * parts)
        local = pm.scatter(stp)
        ref = port_local(jm.scatter(stj))
        assert set(local) == set(ref) == {"ssh", "h", "u", "t"}
        for key in ref:
            assert all(torch.equal(a, b) for a, b in zip(local[key], ref[key])), key
        back = pm.gather(local)
        for f in STATE_FIELDS + ("tracers",):
            assert torch.equal(getattr(back, f), getattr(stp, f)), f
        if parts == 2:
            assert float(pm.checksum(local)) == pytest.approx(
                float(jm.checksum(jax_local(local))), rel=1e-14)
    with pytest.raises(ValueError) as ej:
        JaxSharded(smj.struct_mesh, devices=jax.devices()[:3])
    with pytest.raises(ValueError) as ep:
        ShardedStructuredModel(smp.struct_mesh, [CPU] * 3)
    assert str(ep.value) == str(ej.value)


# (options, FB, slabs): the linear core with the overlap split (P = 1, 2)
# and without it (rows < 3), the nonlinear core's exchange rounds, and all
# four options
CASES = [("", False, 1), ("", False, 2), ("", True, 4), ("N", False, 2), ("N", True, 2),
         ("FT", False, 4), ("NFTS", False, 2), ("NFTS", True, 2)]


@pytest.mark.parametrize("opts, fb, parts", CASES)
def test_run_and_run_pallas_match_jax_rollout(case16, opts, fb, parts):
    """N_STEPS steps of ``run`` and of ``run_pallas`` (q = 2 where the slab
    holds its halo, else 1: the kernel's plain superstep on CPU slabs) over
    ``parts`` slabs against the JAX roll
    model's global rollout: every field, the tracers too, within 1e-12 of its
    scale; ``run_pallas`` made one exchange per field per superstep."""
    smj, smp, stj, stp, (fj, fp), (sj, sp) = case16
    tracers = "T" in opts
    with jax.disable_jit():
        ref = jax_run_loop(stj if tracers else _bare(stj), smj.struct_mesh, DT, N_STEPS,
                           nonlinear="N" in opts, fb=fb,
                           forcing=fj if "F" in opts else None,
                           strat=sj if "S" in opts else None, **TR_KW)
    model = ShardedStructuredModel(smp.struct_mesh, [CPU] * parts)
    local = model.scatter(stp if tracers else _bare(stp))
    kw = _kw(opts, fp, sp)
    out = model.gather(model.run(local, DT, N_STEPS, fb=fb, **kw))
    assert max(_errs(out, ref).values()) <= 1e-12
    q = 2 if 2 * reach(fb, "N" in opts) <= model.rows else 1  # the halo from one neighbour
    sharded.exchanges = 0
    out = model.gather(model.run_pallas(local, DT, N_STEPS, q=q, fb=fb, **kw))
    assert max(_errs(out, ref).values()) <= 1e-12
    assert sharded.exchanges == (4 if tracers else 3) * N_STEPS // q


def test_run_matches_jax_run_and_stats():
    """One direct call of JAX's sharded ``run`` (2 devices, 3 linear FE
    steps with the overlap split): the port's slab dict within 1e-12 of
    JAX's, halos included; ``step_stats`` (the per-step paths, nonlinear, FB
    and tracers, and the superstep's at a given row tile) and
    ``overlap_stats`` equal JAX's dicts."""
    smj, smp, stj, stp, _, _ = full_lattice(16, 4)
    jm = JaxSharded(smj.struct_mesh, devices=jax.devices()[:2])
    pm = ShardedStructuredModel(smp.struct_mesh, [CPU] * 2)
    ref = port_local(jm.run(jm.scatter(_bare(stj)), DT, 3))
    out = pm.run(pm.scatter(_bare(stp)), DT, 3)
    for key in ref:
        for a, b in zip(out[key], ref[key]):
            assert max_rel_err(a.numpy(), b.numpy()) <= 1e-12, key
    for kw in (dict(), dict(nonlinear=True), dict(fb=True), dict(nonlinear=True, fb=True),
               dict(n_tracers=2), dict(path="pallas", q=2, row_tile=2),
               dict(path="pallas", q=1, row_tile=4, nonlinear=True, fb=True, n_tracers=2)):
        for m in ((100, 4), (4, 8)):
            assert pm.step_stats(*m, **kw) == jm.step_stats(*m, **kw), kw
    for m in ((100, 4), (4, 8)):
        assert pm.overlap_stats(*m) == jm.overlap_stats(*m)
        for parts in (1, 4):
            pj = JaxSharded(smj.struct_mesh, devices=jax.devices()[:parts], overlap=False)
            pp = ShardedStructuredModel(smp.struct_mesh, [CPU] * parts, overlap=False)
            assert pp.overlap_stats(*m) == pj.overlap_stats(*m)


def test_refusals_and_reduced_q_warning_match_jax():
    """The contract's refusals raise JAX's ValueError text, before any
    step, on the 8 x 8 lattice (4 rows a parity): reach > R (the nonlinear
    FB's 3 rows over 2 slabs of 2), FB over 4 slabs of one row (``run`` and
    ``objective``), a row tile that does not divide R after q was reduced
    with JAX's warning text (q = 2 does not divide 3 steps)."""
    smj, smp, stj, stp, _, _ = full_lattice(8, 4)
    stj, stp = _bare(stj), _bare(stp)

    def both(parts, call_j, call_p):
        jm = JaxSharded(smj.struct_mesh, devices=jax.devices()[:parts])
        pm = ShardedStructuredModel(smp.struct_mesh, [CPU] * parts)
        with pytest.raises(ValueError) as ej:
            call_j(jm, jm.scatter(stj))
        with pytest.raises(ValueError) as ep:
            call_p(pm, pm.scatter(stp))
        assert str(ep.value) == str(ej.value)

    both(2, lambda m, loc: m.run_pallas(loc, DT, 2, nonlinear=True, fb=True, interpret=True),
         lambda m, loc: m.run_pallas(loc, DT, 2, nonlinear=True, fb=True))
    both(4, lambda m, loc: m.run(loc, DT, 2, fb=True), lambda m, loc: m.run(loc, DT, 2, fb=True))
    both(4, lambda m, loc: m.objective(loc, DT, 2, fb=True),
         lambda m, loc: m.objective(loc, DT, 2, fb=True))
    with pytest.warns(UserWarning) as wj:
        both(1, lambda m, loc: m.run_pallas(loc, DT, 3, q=2, row_tile=3, interpret=True),
             lambda m, loc: m.run_pallas(loc, DT, 3, q=2, row_tile=3))
    assert len(wj) == 2 and str(wj[0].message) == str(wj[1].message)
    assert "reduced the requested superstep q=2 to q=1" in str(wj[0].message)


def test_devices_default_and_counts_and_stale_halos():
    """Without a CUDA device the default devices raise (CPU slabs must be
    asked for); ``run_pallas`` on CPU slabs makes n / q exchanges per
    field, and with the exchange skipped after the first superstep
    (``exchange=False``) its halo rows go stale and ssh misses by far."""
    _, smp, _, stp, _, _ = full_lattice(16, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedStructuredModel(smp.struct_mesh)
    model = ShardedStructuredModel(smp.struct_mesh, [CPU] * 2)
    local = model.scatter(_bare(stp))
    sharded.exchanges = 0
    good = model.gather(model.run_pallas(local, DT, 6, q=2))
    assert sharded.exchanges == 3 * 3
    stale = model.gather(model.run_pallas(local, DT, 6, q=2, exchange=False))
    ref = model.gather(model.run(local, DT, 6))
    assert max_rel_err(good.ssh.numpy(), ref.ssh.numpy()) <= 1e-12
    assert max_rel_err(stale.ssh.numpy(), ref.ssh.numpy()) >= 1e-6
