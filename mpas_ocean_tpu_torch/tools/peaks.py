"""The card's measured peaks: the ceilings every bound of chip_smoke.py
divides by (its phase 9 measures them).

Wrappers of the probe kernels in csrc/peaks.cu, which replace the TPU kernel
of ``measure_vpu_peak`` (bench.py:267, ``pallas_call`` :276) and stand in
for the XLA loop of ``measure_hbm_bw`` (bench.py:293-310), with their plain
PyTorch versions:

* ``fma_probe``: o = fma(o, a, x), ``steps`` times, over bench.py's array
  S = (8, 1024, 128), in shared memory (``in_registers=False``, the
  counterpart of the VMEM-resident streaming FMA: shared memory's rate) or
  in registers, 8 independent chains per thread (the FMA pipes' rate, the
  compute side of the roofline); 2 |S| steps FLOP. Plain: ``plain_fma``.
* ``stream_probe``: b = b + 1, ``passes`` times, by 16-byte copies: over a
  256 MB array one pass per launch (device memory's rate), or over an array
  the size of the 64x64x100 f32 state all passes in one launch (L2's rate);
  2 n 4 passes bytes. Plain: ``plain_stream``. ``sweep_stream`` times its
  layouts, hints and grids beside the plain version
  (``python -m mpas_ocean_tpu_torch.tools.peaks`` prints them and the FMA
  rates).

The wrappers take tensors on a CUDA device and raise on anything else: the
probes measure the card, and a CPU tensor never runs the plain version
through them. ``fma_launches`` and ``stream_launches`` count their kernel
launches.
"""

from __future__ import annotations

import ctypes
import math
import statistics

import torch

from ..kernels import build
from ..kernels.fe_step import check_error

__all__ = [
    "A",
    "FMA_SHAPE",
    "HBM_FLOATS",
    "STREAM_PASSES",
    "fma_flops",
    "fma_launches",
    "fma_probe",
    "measure_fma",
    "measure_plain_stream",
    "measure_stream",
    "plain_fma",
    "plain_stream",
    "state_floats",
    "stream_bytes",
    "stream_launches",
    "stream_probe",
    "sweep_stream",
]

FMA_SHAPE = (8, 1024, 128)  # bench.py's S: 4 MB of f32
A = 1.0000001  # bench.py's multiplier, passed at run time
SLICE = 8192  # values of o (and of x) per block in shared memory
CHAINS = 8  # kChains in csrc/peaks.cu
HBM_FLOATS = 64 * 1024 * 1024  # bench.py's 256 MB f32 array
STREAM_PASSES = 128  # bench.py's T of measure_hbm_bw
THREADS, UNROLL = 512, 4  # kThreads and kUnroll in csrc/peaks.cu
# The stream probe's configurations, the fastest of sweep_stream's on an
# H100 (PERF.md section 6): over device memory contiguous chunks on a grid
# that covers the array once, evict-first, a pass per launch; inside L2 the
# grid-strided layout on 2 blocks per SM, all passes in one launch.
HBM_LAYOUT = {"contiguous": True, "evict_first": True}
L2_LAYOUT = {"contiguous": False, "blocks_per_sm": 2}

# kernel launches made by fma_probe and by stream_probe
fma_launches = 0
stream_launches = 0


def fma_flops(n: int, steps: int) -> int:
    """FLOP of ``steps`` FMA steps over n values: 2 n steps, as bench.py's
    measure_vpu_peak counts them (2 |S| T)."""
    return 2 * n * steps


def stream_bytes(n: int, passes: int, itemsize: int = 4) -> int:
    """Bytes ``passes`` passes of b = b + 1 over n values move: each read
    once and written once per pass, 2 n itemsize passes, as bench.py's
    measure_hbm_bw counts them (2 n 4 T)."""
    return 2 * n * itemsize * passes


def state_floats(n: int, levels: int) -> int:
    """Values of an n x n lattice state with ``levels`` levels: ssh, h and u,
    cells * (1 + 4 levels); the L2 probe's array is the 64x64x100 one's."""
    return 2 * (n // 2) * n * (1 + 4 * levels)


def _cuda(name: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} measures the card and runs on a CUDA device only, "
                             f"got a tensor on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def _stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def fma_probe(o: torch.Tensor, x: torch.Tensor, steps: int, a: float = A, *,
              in_registers: bool = False) -> torch.Tensor:
    """o = fma(o, a, x), ``steps`` times, in place on ``o`` (float32 or
    float64, on the card, the shape of ``x``), in one launch; returns o."""
    global fma_launches
    _cuda("fma_probe", o, x)
    if o.dtype not in (torch.float32, torch.float64) or x.dtype != o.dtype:
        raise TypeError(f"fma_probe takes two float32 or float64 tensors, got {o.dtype}, "
                        f"{x.dtype}")
    if o.shape != x.shape or (in_registers and o.numel() % CHAINS):
        raise ValueError(f"o and x must share a shape whose size is a multiple of {CHAINS}")
    if steps < 0:
        raise ValueError("steps must be >= 0")
    lib = build.load()
    fn = lib.mot_fma_probe_f32 if o.dtype == torch.float32 else lib.mot_fma_probe_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(o.device):
        err = fn(o.data_ptr(), x.data_ptr(), o.numel(), steps, a, SLICE, int(in_registers),
                 _stream_ptr())
    check_error("fma_probe", err)
    fma_launches += 1
    return o


def plain_fma(o: torch.Tensor, x: torch.Tensor, steps: int, a: float = A) -> torch.Tensor:
    """The plain version of ``fma_probe``: o * a + x, ``steps`` times (a
    multiply and an add, two roundings where the kernel's fma has one)."""
    for _ in range(steps):
        o = o * a + x
    return o


def _sm_count() -> int:
    fn = build.load().mot_sm_count
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int()
    check_error("the SM count query", fn(ctypes.addressof(out)))
    return out.value


def stream_probe(b: torch.Tensor, passes: int, *, per_launch: int = 1,
                 contiguous: bool = True, blocks_per_sm: int | None = None,
                 evict_first: bool = False) -> torch.Tensor:
    """b = b + 1, ``passes`` times, in place on ``b`` (float32, on the card,
    16-byte aligned, its size a multiple of 4), ``per_launch`` passes per
    launch (which must divide ``passes``), in the layout (``contiguous``)
    and with the cache hints (``evict_first``) of csrc/peaks.cu's
    stream_kernel, on ``blocks_per_sm`` blocks per SM (None: as many
    blocks as cover the array once); returns b."""
    global stream_launches
    _cuda("stream_probe", b)
    if b.dtype != torch.float32 or b.numel() % 4 or b.data_ptr() % 16:
        raise ValueError("stream_probe takes a 16-byte aligned float32 tensor whose size is "
                         "a multiple of 4")
    if passes < 0 or per_launch < 1 or passes % per_launch:
        raise ValueError(f"per_launch={per_launch} must be >= 1 and divide passes={passes}")
    fn = build.load().mot_stream_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(b.device):
        blocks = (-(-b.numel() // (4 * THREADS * UNROLL)) if blocks_per_sm is None
                  else blocks_per_sm * _sm_count())
        stream = _stream_ptr()
        for _ in range(passes // per_launch):
            check_error("stream_probe", fn(b.data_ptr(), b.numel(), per_launch, blocks,
                                           int(contiguous), int(evict_first), stream))
            stream_launches += 1
    return b


def plain_stream(b: torch.Tensor, passes: int) -> torch.Tensor:
    """The plain version of ``stream_probe``: b + 1, ``passes`` times."""
    for _ in range(passes):
        b = b + 1
    return b


def _event_seconds(fn, reps: int) -> list[float]:
    """Device seconds of each of reps calls of fn(), by CUDA events."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 1e3)
    return out


def _calibrated(run, count: int, min_seconds: float) -> int:
    """A count (steps or passes) for which one call of run(count) lasts at
    least ``min_seconds``, from one timed call at ``count``."""
    t = statistics.median(_event_seconds(lambda: run(count), 1))
    return max(count, math.ceil(count * 1.25 * min_seconds / t))


def measure_fma(dtype=torch.float32, *, in_registers: bool, min_seconds: float = 0.1,
                reps: int = 3) -> dict:
    """FLOP/s of ``fma_probe`` over S = FMA_SHAPE, median of ``reps`` calls
    of at least ``min_seconds`` each: {"steps", "seconds" (each rep),
    "flops_per_s" (each rep), "rate" (median)}."""
    x = torch.ones(FMA_SHAPE, dtype=dtype, device="cuda")
    o = torch.ones_like(x)
    run = lambda steps: fma_probe(o, x, steps, in_registers=in_registers)
    run(100)
    steps = _calibrated(run, 20000 if in_registers else 2000, min_seconds)
    seconds = _event_seconds(lambda: run(steps), reps)
    rates = [fma_flops(x.numel(), steps) / t for t in seconds]
    return {"steps": steps, "seconds": seconds, "flops_per_s": rates,
            "rate": statistics.median(rates)}


def measure_stream(n: int, *, resident: bool, passes: int = STREAM_PASSES,
                   min_seconds: float = 0.02, reps: int = 3, **layout) -> dict:
    """Bytes/s of ``stream_probe`` over n float32 values, median of ``reps``
    calls: ``passes`` passes, one per launch unless ``layout`` says
    otherwise (resident=False, for an array beyond L2), or all passes in one
    launch, as many as make a call of ``min_seconds`` (resident=True, for an
    array inside it); ``layout`` holds stream_probe's other keywords,
    HBM_LAYOUT or L2_LAYOUT by default: {"passes", "seconds",
    "bytes_per_s", "rate"}."""
    layout = layout or (L2_LAYOUT if resident else HBM_LAYOUT)
    b = torch.zeros(n, dtype=torch.float32, device="cuda")
    if resident:
        run = lambda p: stream_probe(b, p, per_launch=p, **layout)
        run(10)
        passes = _calibrated(run, 1000, min_seconds)
    else:
        run = lambda p: stream_probe(b, p, **layout)
        run(2 * layout.get("per_launch", 1))
    seconds = _event_seconds(lambda: run(passes), reps)
    rates = [stream_bytes(n, passes) / t for t in seconds]
    return {"passes": passes, "seconds": seconds, "bytes_per_s": rates,
            "rate": statistics.median(rates)}


def measure_plain_stream(n: int, passes: int, *, in_place: bool = False, reps: int = 3) -> dict:
    """Bytes/s of the plain version over n float32 values, ``passes``
    passes (b = b + 1, or b.add_(1) with ``in_place``), median of ``reps``
    calls; the same keys as ``measure_stream``."""
    b = torch.zeros(n, dtype=torch.float32, device="cuda")

    def run():
        if in_place:
            for _ in range(passes):
                b.add_(1)
        else:
            plain_stream(b, passes)

    run()
    seconds = _event_seconds(run, reps)
    rates = [stream_bytes(n, passes) / t for t in seconds]
    return {"passes": passes, "seconds": seconds, "bytes_per_s": rates,
            "rate": statistics.median(rates)}


def sweep_stream(reps: int = 3) -> list[dict]:
    """The stream probe's layouts, hints, grids and passes per launch, and
    the plain versions, over bench.py's 256 MB array (128 passes) and over
    the 64x64x100 f32 state's size (all passes in a launch; the plain
    versions 1000 passes, a launch each): one dict per configuration with
    measure_stream's keys and "array", "config"."""
    big, small = HBM_FLOATS, state_floats(64, 100)
    out = []

    def add(array, config, r):
        out.append({"array": array, "config": config, **r})

    for contiguous, per_sm, per, evict in ((False, 4, 1, False), (False, 4, 1, True),
                                           (False, 4, STREAM_PASSES, False),
                                           (True, None, 1, False), (True, None, 1, True),
                                           (True, 4, 1, False), (True, 4, STREAM_PASSES, False),
                                           (True, 4, STREAM_PASSES, True)):
        cfg = dict(contiguous=contiguous, blocks_per_sm=per_sm, per_launch=per,
                   evict_first=evict)
        add("256 MB", cfg, measure_stream(big, resident=False, reps=reps, **cfg))
    for in_place in (False, True):
        add("256 MB", {"plain": True, "in_place": in_place},
            measure_plain_stream(big, STREAM_PASSES, in_place=in_place, reps=reps))
    for contiguous, per_sm in ((False, 4), (False, 2), (False, 1), (True, None)):
        cfg = dict(contiguous=contiguous, blocks_per_sm=per_sm)
        add("64^2 state", cfg, measure_stream(small, resident=True, reps=reps, **cfg))
    for in_place in (False, True):
        add("64^2 state", {"plain": True, "in_place": in_place},
            measure_plain_stream(small, 1000, in_place=in_place, reps=reps))
    return out


if __name__ == "__main__":
    # python -m mpas_ocean_tpu_torch.tools.peaks: every stream configuration
    # and the FMA rates, with the card's name and power limit
    import json
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    for r in sweep_stream():
        print(json.dumps({"card": card, "tbps": r["rate"] / 1e12, **r}), flush=True)
    for dtype in (torch.float32, torch.float64):
        for reg in (False, True):
            r = measure_fma(dtype, in_registers=reg)
            print(json.dumps({"card": card, "dtype": str(dtype), "in_registers": reg,
                              "tflops": r["rate"] / 1e12, **r}), flush=True)
