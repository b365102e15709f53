"""The hand-written tiled q-step kernel against its plain PyTorch version, on
a CUDA card. These tests skip on machines without one. They import no JAX,
so on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_tiled_kernel.py
"""

import pytest
import torch

from mpas_ocean_tpu_torch.kernels import tiled_step
from mpas_ocean_tpu_torch.structured import (
    fused_model,
    structured_auto_run_loop,
    tiled_model,
    tiled_run_loop,
)

from torch_gpu_cases import FIELDS, random_lattice

pytestmark = pytest.mark.gpu

# f64 64x64x4 (ny2 = 32, so FB at q = 4 with its 8-row halo is not clamped);
# tile shapes (rows, columns), a 1-row tile among them
TILES = [(1, 8), (4, 4), (8, 16), (16, 2)]


@pytest.fixture(scope="module")
def lattice64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return random_lattice(64, 64, 4, torch.device("cuda"), seed=9)


def _rel_errors(out, ref, rts):
    """max |a - b| over the field's scale; for ssh = sum_k h - rts, the
    column thickness."""
    errs = {}
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        scale = (b + rts).abs().max() if f == "ssh" else b.abs().max()
        errs[f] = float((a - b).abs().max() / scale)
    return errs


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("q", [1, 2, 4])
@pytest.mark.parametrize("tile", TILES)
def test_kernel_matches_plain_f64(lattice64, fb, q, tile):
    """8 steps, f64: the kernel and its plain version (same plan) differ
    only in the order of the column sums, so 1e-12 of each field's scale."""
    model, st = lattice64
    sm = model.struct_mesh
    rt, ct = tile
    out = tiled_run_loop(st, sm, 10.0, 8, row_tile=rt, col_tile=ct, q=q, fb=fb)
    ref = tiled_model.plain_tiled_rollout(st, sm, 10.0, 8, rt, ct, q, fb)
    torch.cuda.synchronize()
    for f, err in _rel_errors(out, ref, sm.resting_thickness_sum).items():
        assert err <= 1e-12, (f, err)


@pytest.mark.parametrize("fb", [False, True])
def test_kernel_reruns_are_bitwise_equal(lattice64, fb):
    model, st = lattice64
    a = tiled_run_loop(st, model.struct_mesh, 10.0, 8, row_tile=4, col_tile=8, q=2, fb=fb)
    b = tiled_run_loop(st, model.struct_mesh, 10.0, 8, row_tile=4, col_tile=8, q=2, fb=fb)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("q", [1, 2, 4])
def test_launches_are_n_steps_over_q(lattice64, fb, q):
    model, st = lattice64
    before = [getattr(st, f).clone() for f in FIELDS]
    tiled_step.launches = 0
    tiled_run_loop(st, model.struct_mesh, 10.0, 12, row_tile=4, col_tile=8, q=q, fb=fb)
    assert tiled_step.launches == 12 // q
    for f, b in zip(FIELDS, before):
        assert torch.equal(getattr(st, f), b)


def test_cuda_state_never_runs_the_plain_version(lattice64, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA state reached the plain version")

    monkeypatch.setattr(tiled_model, "plain_tiled_rollout", refuse)
    monkeypatch.setattr(fused_model, "structured_run_loop", refuse)
    model, st = lattice64
    tiled_step.launches = 0
    for fb in (False, True):
        tiled_run_loop(st, model.struct_mesh, 10.0, 4, fb=fb)
        structured_auto_run_loop(st, model.struct_mesh, 10.0, 4, fb=fb)
    torch.cuda.synchronize()
    assert tiled_step.launches > 0


def test_kernel_rejects_a_plan_that_does_not_fit(lattice64):
    model, st = lattice64
    sm = model.struct_mesh
    with pytest.raises(ValueError, match="shared memory"):
        tiled_step.tiled_rollout(
            st.ssh, st.layer_thickness, st.normal_velocity, sm.f_edge,
            sm.resting_thickness_sum, sm.stencil_table, sm.coriolis_weight,
            10.0, 1e-3, 1e-3, 4, row_tile=32, col_tile=64, q=4, halo=(2, 2),
        )
