"""The nonlinear reverse's stratified part split out of its stencil, on the
CPU at f64 (numpy-seeded inputs, 8 x 8 x 4 and 16 x 16 x 36 lattices):

* the split reverse step (``structured_nl_adjoint_step`` without W, then the
  stratified pass's plain version ``strat_pass`` on the step's S, summed as
  ``nl_strat_split`` here sums them, as the card runs them) against the unsplit
  ``structured_nl_adjoint_step(strat=)`` and (16 x 16 x 36, the channel: a
  JAX call costs seconds) against ``jax.vjp`` of the JAX stratified
  nonlinear step, d(dt) and d(W) included;
* the pass's wrapper on CPU tensors (its plain version, in place), its f32
  d(W) summed in double on integer data;
* the planners' mirrors of the kernels' shared memory, worked out by hand,
  and their refusals.

The CUDA pass (csrc/adjoint_window.cuh, strat_pass_kernel) is held against
``strat_pass`` on the card (tests/test_torch_nl_strat_pass_kernel.py,
chip_smoke.py phase 20).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_ocean_tpu.models import stratification as jax_strat
from mpas_ocean_tpu.structured.model import structured_step as jax_step
from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step
from mpas_ocean_tpu_torch.models import Stratification, stratification_from_numpy
from mpas_ocean_tpu_torch.structured import struct_state_from_numpy, structured_nl_adjoint_step
from mpas_ocean_tpu_torch.structured import StructState
from mpas_ocean_tpu_torch.structured.adjoint import (
    _own_minus_incoming,
    pressure_transpose,
    strat_pass,
)

from torch_gpu_cases import integer_strat_case
from torch_port_cases import STATE_FIELDS, max_rel_err, nl_channel, nl_periodic

DT = 5.0


def _case(n, k, channel, seed=5):
    """(JAX model, port model, JAX state, port state), a random dense W as
    (JAX, port) Stratifications and a random cotangent (numpy dict)."""
    smj, smp, stj, stp, _, _ = (nl_channel if channel else nl_periodic)(n, k, seed)
    rng = np.random.default_rng(13 + k)
    w, rho = 0.05 * rng.normal(size=(k, k)), np.full(k, 1025.0)
    sj = jax_strat.Stratification(phi_weights=jnp.asarray(w), densities=jnp.asarray(rho))
    sp = stratification_from_numpy({"phi_weights": w, "densities": rho})
    g = {f: rng.normal(size=tuple(getattr(stp, f).shape)) for f in STATE_FIELDS}
    return smj, smp, stj, stp, sj, sp, g


def nl_strat_split(state, g, mesh, dt, strat):
    """The stratified nonlinear reverse step split as the card runs it: the
    stencil part (structured_nl_adjoint_step without W, whose d(dt) takes
    the g ssh pressure only) and the pass (strat_pass on the step's S, gu
    masked on a channel), summed; the tuple of
    structured_nl_adjoint_step(..., strat=strat)."""
    res = structured_nl_adjoint_step(state, g, mesh, dt)
    gu = g.normal_velocity
    if mesh.edge_mask is not None:
        gu = gu * mesh.edge_mask[..., None]
    dh_w, d_w, d_dt = strat_pass(state.layer_thickness, _own_minus_incoming(gu),
                                 strat.phi_weights, dt, 1.0 / mesh.dc)
    d = res[0]
    return (StructState(d.ssh, d.layer_thickness + dh_w, d.normal_velocity, d.tracers),
            res[1] + d_dt, d_w)


def _w_scale(h, gu, mesh, k) -> float:
    """d(W)'s Cauchy-Schwarz scale: max over (l, k) of sum_c |h[c, l]|
    |dPhi[c, k]| (tests/test_torch_strat_adjoint.py's)."""
    eye = Stratification(torch.eye(k, dtype=h.dtype), torch.full((k,), 1025.0))
    if mesh.edge_mask is not None:
        gu = gu * mesh.edge_mask[..., None]
    d_phi, _ = pressure_transpose(h, gu, DT, mesh, eye)
    return float((h.abs().reshape(-1, k).T @ d_phi.abs().reshape(-1, k)).max())


# (n, k, channel)
CASES = [(8, 4, False), (8, 4, True), (16, 36, False), (16, 36, True)]


@pytest.mark.parametrize("n, k, channel", CASES)
def test_split_reverse_matches_the_unsplit_step(n, k, channel):
    """The split reverse (the stencil part, then the pass) against the
    unsplit structured_nl_adjoint_step(strat=): every field within 1e-13 of
    its scale, d(dt) within 1e-13 of its magnitude, d(W) within 1e-13 of
    its Cauchy-Schwarz scale; the pass alone carries the whole difference
    between the stratified and the unstratified step's dh."""
    _, smp, _, stp, _, sp, g = _case(n, k, channel)
    mesh, gs = smp.struct_mesh, struct_state_from_numpy(g)
    ref = structured_nl_adjoint_step(stp, gs, mesh, DT, strat=sp)
    got = nl_strat_split(stp, gs, mesh, DT, sp)
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(got[0], f).numpy(), getattr(ref[0], f).numpy()) <= 1e-13, f
    assert abs(float(got[1]) - float(ref[1])) <= 1e-13 * abs(float(ref[1]))
    w_scale = _w_scale(stp.layer_thickness, gs.normal_velocity, mesh, k)
    assert float((got[-1] - ref[-1]).abs().max()) <= 1e-13 * w_scale
    bare = structured_nl_adjoint_step(stp, gs, mesh, DT)
    assert max_rel_err(bare[0].layer_thickness.numpy(),
                       ref[0].layer_thickness.numpy()) >= 100 * 1e-13


@pytest.mark.parametrize("n, k, channel", [CASES[3]])
def test_split_reverse_matches_jax_vjp(n, k, channel):
    """The split reverse against jax.vjp of the JAX nonlinear stratified
    step with respect to the state, dt and W: every cotangent within 1e-12
    of its scale (d(W)'s its Cauchy-Schwarz scale)."""
    smj, smp, stj, stp, sj, sp, g = _case(n, k, channel)

    def step_j(s, t, w):
        return jax_step(s, smj.struct_mesh, t, True, strat=jax_strat.Stratification(
            w, sj.densities))

    _, vjp = jax.vjp(step_j, stj, jnp.float64(DT), sj.phi_weights)
    ref, ref_dt, ref_w = vjp(stj.replace(**{f: jnp.asarray(v) for f, v in g.items()}))
    gs = struct_state_from_numpy(g)
    got = nl_strat_split(stp, gs, smp.struct_mesh, DT, sp)
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(got[0], f).numpy(), np.asarray(getattr(ref, f))) <= 1e-12, f
    assert abs(float(got[1]) - float(ref_dt)) <= 1e-12 * abs(float(ref_dt))
    w_scale = _w_scale(stp.layer_thickness, gs.normal_velocity, smp.struct_mesh, k)
    assert np.abs(got[-1].numpy() - np.asarray(ref_w)).max() <= 1e-12 * w_scale


def test_pass_wrapper_on_cpu_tensors_runs_the_plain_pass():
    """nl_strat_pass on CPU tensors adds the plain pass's terms in place:
    dh += (dt / dc) S W^T, d(W) and d(dt)'s W part (one sum over the cells,
    in double) to their accumulators, each against numpy; the kernel's
    counter does not move."""
    rng = np.random.default_rng(3)
    cells, k, inv_dc = 96, 7, 1.0 / 900.0
    h, s = rng.normal(50.0, 1.0, size=(cells, k)), rng.normal(size=(cells, k))
    w, dh0 = rng.normal(size=(k, k)), rng.normal(size=(cells, k))
    dh = torch.from_numpy(dh0.copy())
    dstrat = torch.ones((k, k), dtype=torch.float64)
    ddt = torch.full((1,), 2.0, dtype=torch.float64)
    before = adjoint_step.nl_strat_pass_launches
    adjoint_step.nl_strat_pass(torch.from_numpy(h), torch.from_numpy(s), torch.from_numpy(w), dh,
                               DT, inv_dc, dstrat, ddt)
    assert adjoint_step.nl_strat_pass_launches == before
    sums = h.T @ s
    assert np.abs(dh.numpy() - (dh0 + DT * inv_dc * s @ w.T)).max() <= 1e-12
    assert np.abs(dstrat.numpy() - (1.0 + DT * inv_dc * sums)).max() <= 1e-12 * np.abs(sums).max()
    assert abs(float(ddt[0]) - (2.0 + inv_dc * (w * sums).sum())) <= 1e-12 * np.abs(
        w * sums).sum() * inv_dc


def test_pass_sums_d_w_in_double_on_integer_data():
    """f32 data whose d(W) sums are exact in double (integer_strat_case: h
    2^20 + 0..1023, gu -7..7, dt 1 s, dc 1024 m): the plain pass's d(W) is
    bitwise the exact sums, as the kernel's is on the card; the same sums in
    float are not."""
    mesh, stack, g = integer_strat_case(8, 36, "cpu")
    h = stack[1][0]
    s = _own_minus_incoming(g.normal_velocity)
    _, d_w, _ = strat_pass(h, s, torch.eye(36, dtype=torch.float32), 1.0, 1.0 / mesh.dc)
    exact = h.reshape(-1, 36).double().T @ (s.reshape(-1, 36).double() / 1024.0)
    assert torch.equal(d_w, exact)
    in_float = (h.reshape(-1, 36).T @ (s.reshape(-1, 36) / 1024.0)).double()
    assert not torch.equal(in_float, exact)


def test_smem_mirrors_worked_out_by_hand():
    """nl_adjoint_smem_bytes at a (4, 8) tile, 2-level slices: the window
    (12 x 20 sites) of 16 values (24 with two tracers), the rings (10 x 16,
    8 x 12, 6 x 10 sites of 12, 14 and 8 values), the tracers' 6 x 7 values
    per ring C site, the window's 4 + n_fv planes, the partial sums, 128
    bytes of d(dt) sums, 8 bytes of ints per window site and 24 per ring C
    site (the edges' packed levels); strat_pass_smem_bytes at K = 100 in
    sub-chunks of 128 cells with all 100 of W's columns (a half's 56
    levels: W's transpose 100 x 56, S 104 x 132 and h 56 x 132, 16
    doubles); strat_pass_fit: at K = 100 128 cells (14 x 32 = 448 W S
    tiles, one a thread) and all of W in f64; at K = 136 64 cells (18 x 32
    tiles at 128 exceed 512 threads); at K = 400 f64 32 cells (50 x 8
    tiles) and 32 of W's columns (8 x (400 + 200) x 36 + 128 bytes staged,
    the room left over 8 x 200 bytes a column: 37, cut to a multiple of 8),
    f32 176; strat_pass_groups."""
    w, a, b, c = 12 * 20, 10 * 16, 8 * 12, 6 * 10
    rings = 12 * a + 14 * b + 8 * c
    for itemsize in (4, 8):
        assert adjoint_step.nl_adjoint_smem_bytes((4, 8), itemsize, 2) == \
            128 + itemsize * ((16 * w + rings) * 2 + 8 * w + 64) + 8 * w + 24 * c
        assert adjoint_step.nl_adjoint_smem_bytes((4, 8), itemsize, 2, 2, masked=True) == \
            128 + itemsize * ((24 * w + rings + 42 * c) * 2 + 24 * w + 64) + 8 * w + 24 * c
        assert adjoint_step.strat_pass_smem_bytes(100, 128, 100, itemsize) == \
            itemsize * (100 * 56 + (104 + 56) * 132) + 128
        assert adjoint_step.strat_pass_fit(100, itemsize) == (128, 100)
        assert adjoint_step.strat_pass_fit(136, itemsize) == (64, 136)
    room = (fe_step.SMEM_BYTES - (8 * (400 + 200) * 36 + 128)) // (8 * 200)
    assert room == 37
    assert adjoint_step.strat_pass_fit(400, 8) == (32, 32)
    assert adjoint_step.strat_pass_fit(400, 4) == (32, 176)
    assert [adjoint_step.strat_pass_groups(c) for c in (2, 128, 8192, 131072)] == [1, 2, 64, 64]


def test_planners_take_buffers_and_refuse_what_fits_no_block():
    """nl_adjoint_plan's plans fit one block with their window buffer, at
    64^2 and 256^2 x 100 f32, the core and NFTS, periodic and masked; the
    stratified plan takes a deep W (400 levels, W's columns in chunks, and
    the most levels the pass stages: 1312 in f64, 2048 in f32); a tracer
    count no tile fits and a W whose pass fits no block (1313 f64 levels,
    2049 f32) raise ValueError."""
    for n in (64, 256):
        for n_tr, masked in ((0, False), (2, False), (0, True), (2, True)):
            rt, ct, ks = adjoint_step.nl_adjoint_plan(n // 2, n, 100, 4, n_tracers=n_tr,
                                                      strat=True, masked=masked)
            assert adjoint_step.nl_adjoint_smem_bytes((rt, ct), 4, ks, n_tr, masked) \
                <= fe_step.SMEM_BYTES
    for k, itemsize in ((400, 8), (400, 4), (1312, 8), (2048, 4)):
        adjoint_step.nl_adjoint_plan(32, 64, k, itemsize, strat=True)
        cb, kb = adjoint_step.strat_pass_fit(k, itemsize)
        assert adjoint_step.strat_pass_smem_bytes(k, cb, kb, itemsize) <= fe_step.SMEM_BYTES
        assert kb % 8 == 0 and 8 <= kb < k
    with pytest.raises(ValueError, match="fits"):
        adjoint_step.nl_adjoint_plan(32, 64, 100, 8, n_tracers=80)
    for k, itemsize in ((1313, 8), (2049, 4)):
        with pytest.raises(ValueError, match="stratified pass"):
            adjoint_step.nl_adjoint_plan(32, 64, k, itemsize, strat=True)
