"""The nonlinear reverse's stratified pass (csrc/adjoint_window.cuh,
strat_pass_kernel: W S into dh, d(W) on the FP64 tensor cores, d(dt)'s W
part) against its plain version ``structured.adjoint.strat_pass``, its
launches beside the stratified reverse's, and the reverse's level splits,
on a CUDA card. These tests skip on machines without a
card. They import no JAX, so on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_nl_strat_pass_kernel.py
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu_torch.kernels import adjoint_step
from mpas_ocean_tpu_torch.structured import StructState
from mpas_ocean_tpu_torch.structured.adjoint import _own_minus_incoming, strat_pass

from torch_gpu_cases import (  # noqa: F401 (fixture)
    TRACER_FIELDS,
    composed_case,
    composed_reverse,
    composed_stack,
    composed_state,
    composed_steps,
    cuda,
    integer_strat_case,
)

pytestmark = pytest.mark.gpu

DT, INV_DC = 10.0, 1.0 / 1000.0


def _operands(ny2, nx, k, dtype, device, seed=5):
    """Random (h ~ 50 m, S, W, dh) on a (2, ny2, nx, k) lattice."""
    rng = np.random.default_rng(seed)
    shape = (2, ny2, nx, k)
    return tuple(torch.from_numpy(x).to(device=device, dtype=dtype) for x in (
        50.0 + rng.normal(size=shape), rng.normal(size=shape), 0.05 * rng.normal(size=(k, k)),
        rng.normal(size=shape)))


def _pass(h, s, w, dh):
    """The kernel's pass on copies: (dh, d(W), d(dt))."""
    k = h.shape[-1]
    dh = dh.clone()
    dstrat = torch.zeros((k, k), dtype=torch.float64, device=h.device)
    ddt = torch.zeros(1, dtype=torch.float64, device=h.device)
    adjoint_step.nl_strat_pass(h, s, w, dh, DT, INV_DC, dstrat, ddt)
    return dh, dstrat, ddt[0]


# (ny2, nx, k): the main paths' 64^2 x 100, a ragged cell count, K = 136
# (sub-chunks of 64 cells, two batches of d(W) tiles), a few levels (one
# half of the levels empty), K = 400 (W's columns staged 32 at a time, the
# last chunk 16: strat_pass_fit)
@pytest.mark.parametrize("ny2, nx, k", [(32, 64, 100), (9, 14, 36), (16, 16, 136), (8, 8, 4),
                                        (8, 8, 400)])
def test_pass_matches_plain_f64(cuda, ny2, nx, k):
    """f64: dh within 1e-12 of its scale, d(W) within 1e-12 of its
    Cauchy-Schwarz scale (max over (l, k) of (dt / dc) sum_c |h_l| |S_k|),
    d(dt) within 1e-12 of the sum of its terms' magnitudes; reruns bitwise;
    one launch each."""
    h, s, w, dh0 = _operands(ny2, nx, k, torch.float64, cuda)
    before = adjoint_step.nl_strat_pass_launches
    got = _pass(h, s, w, dh0)
    again = _pass(h, s, w, dh0)
    assert adjoint_step.nl_strat_pass_launches == before + 2
    dh_w, d_w, d_dt = strat_pass(h, s, w, DT, INV_DC)
    want = dh0 + dh_w
    assert float((got[0] - want).abs().max()) <= 1e-12 * float(want.abs().max())
    sums = h.reshape(-1, k).abs().T @ s.reshape(-1, k).abs()
    assert float((got[1] - d_w).abs().max()) <= 1e-12 * DT * INV_DC * float(sums.max())
    assert abs(float(got[2] - d_dt)) <= 1e-12 * INV_DC * float((w.abs() * sums).sum())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_pass_f32_at_the_main_path(cuda):
    """f32 at 64^2 x 100: dh's distance from an f64 pass of the same f32
    values within 3x the plain f32 pass's, d(W) (summed in double) and
    d(dt) within 1e-12 of their f64 scales (only their f32 products round)."""
    h, s, w, dh0 = _operands(32, 64, 100, torch.float32, cuda)
    got = _pass(h, s, w, dh0)
    ref = _pass(*(x.double() for x in (h, s, w, dh0)))
    plain = dh0 + strat_pass(h, s, w, DT, INV_DC)[0]
    gap = float((got[0].double() - ref[0]).abs().max())
    assert gap <= 3 * float((plain.double() - ref[0]).abs().max())
    sums = h.double().reshape(-1, 100).abs().T @ s.double().reshape(-1, 100).abs()
    assert float((got[1] - ref[1]).abs().max()) <= 1e-6 * DT * INV_DC * float(sums.max())
    assert abs(float(got[2] - ref[2])) <= 1e-6 * INV_DC * float((w.double().abs() * sums).sum())


@pytest.mark.parametrize("n", [64, 256])
def test_pass_sums_d_w_in_double_exactly(cuda, n):
    """f32 data whose d(W) sums are exact in double (integer_strat_case: h
    2^20 + 0..1023, gu -7..7, dt 1 s, dc 1024 m): the pass's d(W) bitwise
    the exact sums (the check the stratified reverse's d(W) takes,
    tests/test_torch_strat_adjoint_kernel.py)."""
    mesh, stack, g = integer_strat_case(n, 100, cuda)
    h = stack[1][0].contiguous()
    s = _own_minus_incoming(g.normal_velocity).contiguous()
    dstrat = torch.zeros((100, 100), dtype=torch.float64, device=cuda)
    ddt = torch.zeros(1, dtype=torch.float64, device=cuda)
    w = torch.eye(100, dtype=torch.float32, device=cuda)
    adjoint_step.nl_strat_pass(h, s, w, torch.zeros_like(h), 1.0, 1.0 / mesh.dc, dstrat, ddt)
    exact = h.reshape(-1, 100).double().T @ (s.reshape(-1, 100).double() / 1024.0)
    assert torch.equal(dstrat, exact)


@pytest.mark.parametrize("opts", ["NS", "NFTS"])
def test_pass_launches_once_a_stratified_step(cuda, opts):
    """The stratified reverse's launches and the pass's move together: n
    reverse steps of a stratified nonlinear arm make n launches of each; an
    unstratified arm makes none of the pass."""
    model, st, forcing, strat = composed_case(opts, 16, 4, False, cuda)
    g = StructState(*(None if getattr(st, f) is None else torch.randn_like(getattr(st, f))
                      for f in TRACER_FIELDS))
    for arm, want in ((opts, 5), ("N", 0)):
        steps = composed_steps(model.struct_mesh, DT, st.layer_thickness, arm, forcing, strat)
        stack = composed_stack(steps, composed_state(st, arm), 5)
        adjoint_step.nl_strat_launches = adjoint_step.nl_strat_pass_launches = 0
        composed_reverse(steps, stack, composed_state(g, arm), 5)
        assert adjoint_step.nl_strat_pass_launches == adjoint_step.nl_strat_launches == want


@pytest.mark.parametrize("opts", ["N", "NFTS"])
def test_level_splits_agree(cuda, opts):
    """f64, 16^2 x 36: the nonlinear reverse at every level split of a slice
    of 2 levels (6, 10, 18 and 36 levels a block: 6 to 1 blocks a tile)
    within 1e-12 of one block a tile, every cotangent over its max, d(dt)
    and d(W) over their magnitudes (the splits sum the ranks' level sums in
    another order); the default split among them bitwise on a rerun."""
    model, st, forcing, strat = composed_case(opts, 16, 36, False, cuda)
    g = StructState(*(None if getattr(st, f) is None else torch.randn_like(getattr(st, f))
                      for f in TRACER_FIELDS))
    stack = composed_stack(composed_steps(model.struct_mesh, DT, st.layer_thickness, opts,
                                          forcing, strat), composed_state(st, opts), 3)
    orig = adjoint_step.nl_adjoint_rollout

    def run(kc):
        steps = composed_steps(model.struct_mesh, DT, st.layer_thickness, opts, forcing, strat)

        def rollout(*a, **kw):
            return orig(*a, **{**kw, "tile": (4, 4), "ks": 2, "_kc": kc})

        adjoint_step.nl_adjoint_rollout = rollout
        try:
            return composed_reverse(steps, stack, composed_state(g, opts), 3)
        finally:
            adjoint_step.nl_adjoint_rollout = orig

    ref = run(36)
    for kc in (6, 10, 18, None):
        got = run(kc)
        for f in TRACER_FIELDS:
            a, b = getattr(got[0], f), getattr(ref[0], f)
            if b is not None:
                assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()), (kc, f)
        for a, b in zip(got[1:], ref[1:]):
            if b is not None:
                assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()), kc
    again = run(None)
    assert all(torch.equal(a, b) for a, b in zip(again[1:], run(None)[1:]) if a is not None)
