"""Kernel 5, the probes of the card's peaks (csrc/peaks.cu,
mpas_ocean_tpu_torch/tools/peaks.py): on the CPU their plain versions and
the FLOP and byte counts; on a CUDA card (marker ``gpu``, skipped without
one) the probe kernels against their plain versions. They import no JAX, so
on a GPU machine without it the card's tests run with

    python -m pytest --noconftest -m gpu tests/test_torch_peaks.py
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu_torch.tools import peaks

from torch_gpu_cases import cuda  # noqa: F401 (fixture)


def test_counts_are_bench_pys():
    """2 |S| T FLOP for bench.py's S = (8, 1024, 128) and T = 300000, and
    2 n 4 T bytes for its 256 MB array and T = 128 (bench.py:250-310)."""
    n = int(np.prod(peaks.FMA_SHAPE))
    assert n == 8 * 1024 * 128
    assert peaks.fma_flops(n, 300000) == 2 * n * 300000
    assert peaks.HBM_FLOATS * 4 == 256 * 2**20
    assert peaks.stream_bytes(peaks.HBM_FLOATS, peaks.STREAM_PASSES) == (
        2 * peaks.HBM_FLOATS * 4 * 128)
    # the L2 probe's array: the 64x64x100 lattice state (ssh, h, u)
    assert peaks.state_floats(64, 100) == 2 * 32 * 64 * (1 + 4 * 100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_fma_is_the_recurrence(dtype):
    """o = o * a + x, T = 1000 times, bit for bit the same recurrence in
    numpy in the same dtype (a multiply and an add, each rounded)."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    rng = np.random.default_rng(0)
    o0, x = rng.uniform(0.5, 1.5, size=(2, 64)).astype(np_dtype)
    got = peaks.plain_fma(torch.from_numpy(o0), torch.from_numpy(x), 1000)
    want, a = o0.copy(), np_dtype(peaks.A)
    for _ in range(1000):
        want = want * a + x
    assert np.array_equal(got.numpy(), want)


def test_plain_stream_adds_one_per_pass():
    b = torch.arange(16, dtype=torch.float32)
    assert torch.equal(peaks.plain_stream(b, 7), b + 7)


def test_probes_refuse_the_cpu():
    """The probes measure the card: a CPU tensor raises and never runs the
    plain version."""
    x = torch.ones(peaks.FMA_SHAPE)
    peaks.fma_launches = peaks.stream_launches = 0
    with pytest.raises(ValueError, match="CUDA device"):
        peaks.fma_probe(x.clone(), x, 10)
    with pytest.raises(ValueError, match="CUDA device"):
        peaks.fma_probe(x.clone(), x, 10, in_registers=True)
    with pytest.raises(ValueError, match="CUDA device"):
        peaks.stream_probe(torch.zeros(64), 2)
    assert peaks.fma_launches == peaks.stream_launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("in_registers", [False, True])
def test_fma_probe_matches_plain(cuda, dtype, in_registers):
    """S = (8, 1024, 128): the kernel's fma rounds once where the plain
    multiply and add round twice, so 1e-5 relative, at T = 1000 on
    bench.py's inputs (o = x = 1) and at T = 10 on random ones (each value
    its own, so that a value in the wrong place shows; over 1000 steps the
    biased rounding of o * a would part the two by ~2.5e-5 there); one
    launch each."""
    rng = np.random.default_rng(1)
    ones = torch.ones(peaks.FMA_SHAPE, dtype=dtype, device=cuda)
    x, o = (torch.from_numpy(v).to(cuda, dtype)
            for v in rng.uniform(0.5, 1.5, size=(2, *peaks.FMA_SHAPE)))
    for o0, x0, steps in ((ones, ones, 1000), (o, x, 10)):
        ref = peaks.plain_fma(o0.clone(), x0, steps)
        peaks.fma_launches = 0
        out = peaks.fma_probe(o0.clone(), x0, steps, in_registers=in_registers)
        torch.cuda.synchronize()
        assert peaks.fma_launches == 1
        assert float(((out - ref).abs().max() / ref.abs().max())) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n, per_launch", [(4096, 1), (4096, 6), (1 << 20, 2), (12, 3)])
@pytest.mark.parametrize("layout", [dict(contiguous=True), dict(contiguous=False),
                                    dict(contiguous=True, blocks_per_sm=1, evict_first=True),
                                    dict(contiguous=False, blocks_per_sm=2, evict_first=True)])
def test_stream_probe_matches_plain_bitwise(cuda, n, per_launch, layout):
    b = torch.from_numpy(np.random.default_rng(2).normal(size=n).astype(np.float32)).to(cuda)
    peaks.stream_launches = 0
    out = peaks.stream_probe(b.clone(), 6, per_launch=per_launch, **layout)
    assert peaks.stream_launches == 6 // per_launch
    assert torch.equal(out, peaks.plain_stream(b, 6))
