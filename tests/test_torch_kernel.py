"""The hand-written CUDA step kernel against its plain PyTorch version, on a
CUDA card. These tests skip on machines without one. They import no JAX,
so on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py
"""

import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu_torch.kernels import fe_step
from mpas_ocean_tpu_torch.structured import fused_run_loop, structured_run_loop

from torch_gpu_cases import FIELDS, cuda, random_lattice  # noqa: F401 (fixture)

pytestmark = pytest.mark.gpu

@pytest.mark.parametrize("n_steps", [0, 1, 2, 7])
@pytest.mark.parametrize(
    "shape, dc", [((16, 16, 4), 1e3), ((10, 12, 33), 1e3), ((8, 8, 300), 1e5)]
)
def test_kernel_matches_plain_f64(cuda, shape, dc, n_steps):
    """f64: the two differ only in summation order, so 1e-12 of each
    field's magnitude. ssh = sum_k h - rts is a small difference of large
    sums, so its rounding is measured against the column thickness sum_k h.
    K = 33 and 300 cover ragged warps and k-striding. At K = 300 the 3000 m
    column rounds to ~5e-13 m; at 1 km spacing the pressure gradient would
    carry that into 1e-12 of u within two steps, at 100 km it stays below."""
    model, st = random_lattice(*shape, cuda, dc=dc)
    sm = model.struct_mesh
    out = fused_run_loop(st, sm, 10.0, n_steps)
    ref = structured_run_loop(st, sm, 10.0, n_steps)
    torch.cuda.synchronize()
    column = (ref.ssh + sm.resting_thickness_sum).abs().max()
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64
        scale = column if f == "ssh" else b.abs().max()
        err = float((a - b).abs().max() / scale)
        assert err <= 1e-12, (f, err)


def test_kernel_counts_launches_and_keeps_inputs(cuda):
    model, st = random_lattice(16, 16, 4, cuda)
    before = [getattr(st, f).clone() for f in FIELDS]
    fe_step.launches = 0
    fused_run_loop(st, model.struct_mesh, 10.0, 5)
    assert fe_step.launches == 5
    for f, b in zip(FIELDS, before):
        assert torch.equal(getattr(st, f), b)


def test_kernel_rejects_what_it_does_not_take(cuda):
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    with pytest.raises(TypeError):
        fused_run_loop(
            mt.structured.StructState(*(getattr(st, f).half() for f in FIELDS)),
            sm, 10.0, 1,
        )
    with pytest.raises(ValueError):
        fe_step.fe_rollout(
            st.ssh, st.layer_thickness, st.normal_velocity[:, :, :-1],
            sm.f_edge, sm.resting_thickness_sum, sm.stencil_table,
            sm.coriolis_weight, 10.0, 1e-3, 1e-3, 1,
        )
