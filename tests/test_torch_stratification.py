"""The port's layered stratification against the JAX package's, on the CPU at
f64 (numpy-seeded inputs): ``make_stratification``, ``baroclinic_wave_speeds``
and ``InternalWave`` bit for bit, ``montgomery_potential``, the roll steps
with ``strat=`` (forward Euler and forward-backward, periodic and channel,
linear and nonlinear, forced and with tracers, the make_stratification W
and a dense random one) against the JAX roll model, the slab step's
stratified arm against ``sharded._step_slab``, the tiled kernel's plain
windows and the fused route's plain version against the JAX Pallas kernels
in interpret mode; and the port's own checks: the numpy carry of the
weights, equal densities against the unstratified step, the planners'
stratified shared memory, a CPU rehearsal of the card's stratified
wrappers, the refusals on the card (stratification with the nonlinear
core, forcing or tracers) and the two-layer internal wave over half a
period. The CUDA stratified arms are held against these plain versions on
the card (tests/test_torch_strat_kernel.py, chip_smoke.py phase 17).
"""

import contextlib
import ctypes
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.models import stratification as jax_strat
from mpas_ocean_tpu.models.forcing import make_forcing as jax_make_forcing
from mpas_ocean_tpu.models.tracers import make_tracers as jax_make_tracers
from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.pallas_model import pallas_run_loop as jax_pallas_run_loop
from mpas_ocean_tpu.structured.pallas_model import (
    pallas_tiled_run_loop as jax_pallas_tiled_run_loop,
)
from mpas_ocean_tpu.structured.sharded import _step_slab as jax_step_slab
from mpas_ocean_tpu.verification.internal_wave import InternalWave as JaxInternalWave
from mpas_ocean_tpu_torch.kernels import build, fe_step, tiled_step
from mpas_ocean_tpu_torch.models import (
    baroclinic_wave_speeds,
    make_stratification,
    montgomery_potential,
    stratification_from_numpy,
    stratification_to_numpy,
)
from mpas_ocean_tpu_torch.structured import (
    fused_run_loop,
    structured_auto_run_loop,
    structured_run_loop,
    tiled_run_loop,
)
from mpas_ocean_tpu_torch.structured.fused_model import (
    KernelTracers,
    kernel_live,
    kernel_strat,
)
from mpas_ocean_tpu_torch.structured.slab import step_slab, stencil_reach
from mpas_ocean_tpu_torch.structured.tiled_model import (
    plain_tiled_rollout,
    resolve_plan,
    window_bytes,
)

from torch_port_cases import (
    FULL_FORCING,
    STATE_FIELDS,
    max_rel_err,
    nl_channel,
    nl_periodic,
    stub_card,
)

DT = 5.0
K = 4
# a stable column of four layers (kg/m^3), top first
RHO = [1024.0, 1025.0, 1025.5, 1027.0]


def _dense_w(k, seed=13):
    """A dense random W (K, K): the stratified arms take any W, not only
    make_stratification's strictly lower triangular form."""
    return 0.05 * np.random.default_rng(seed).normal(size=(k, k))


def _strats(kind, k=K):
    """(JAX Stratification, port Stratification) of make_stratification's W
    for ``kind`` "rho", or of a dense random W for "dense"."""
    if kind == "rho":
        rho = RHO if k == K else 1025.0 + np.linspace(0.0, 2.0, k)
        return jax_strat.make_stratification(rho), make_stratification(rho)
    w, rho = _dense_w(k), np.full(k, 1025.0)
    return (jax_strat.Stratification(phi_weights=jnp.asarray(w), densities=jnp.asarray(rho)),
            stratification_from_numpy({"phi_weights": w, "densities": rho}))


def _lattice(channel, tracers=False, seed=5):
    """(JAX model, port model, JAX state, port state, JAX Mesh, port Mesh) on
    a 16 x 16 lattice of K 50 m levels (``nl_periodic`` or ``nl_channel``),
    with two tracers made by each package from the same numpy fields."""
    smj, smp, stj, stp, mj, mp = (nl_channel if channel else nl_periodic)(16, K, seed)
    if not tracers:
        return smj, smp, stj, stp, mj, mp
    x = np.asarray(mp.horz.cells.x)
    rng = np.random.default_rng(9)
    fields = [10.0 + 2.0 * np.sin(2 * np.pi * x / (x.max() + 1))[:, None]
              + 0.3 * rng.normal(size=(mp.n_cells, K)), np.full(mp.n_cells, 35.0)]
    progj = smj.from_struct(stj).replace(tracers=jax_make_tracers(mj, fields))
    progp = mt.PrognosticVars(*(getattr(smp.from_struct(stp), f) for f in STATE_FIELDS),
                              tracers=mt.make_tracers(mp, fields))
    return smj, smp, smj.to_struct(progj), smp.to_struct(progp), mj, mp


def _errs(out, ref, fields=STATE_FIELDS) -> dict:
    return {f: max_rel_err(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
            for f in fields}


@pytest.mark.parametrize("densities, dtype", [
    (RHO, None), (1025.0 + np.linspace(0.0, 1.0, 100), np.float32), ([1026.0] * 3, None)])
def test_make_stratification_is_the_jax_packages_bitwise(densities, dtype):
    """make_stratification's W and densities bit for bit the JAX one's (K = 4
    f64, bench.py's 100 levels in f32, equal densities: W = 0), carried
    across numpy both ways; torch.float32 as dtype gives the np.float32
    result; a 2-D and an unstable column raise ValueError in both."""
    want = jax_strat.make_stratification(densities, dtype=dtype)
    got = make_stratification(densities, dtype=dtype)
    for f in ("phi_weights", "densities"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    d = stratification_to_numpy(got)
    back = stratification_from_numpy({f: np.asarray(getattr(want, f)) for f in d})
    assert all(torch.equal(getattr(back, f), getattr(got, f)) for f in d)
    if dtype is not None:
        t = make_stratification(densities, dtype=torch.float32)
        assert torch.equal(t.phi_weights, got.phi_weights)
    for bad in ([[1025.0, 1026.0]], [1026.0, 1025.0]):
        with pytest.raises(ValueError):
            jax_strat.make_stratification(bad)
        with pytest.raises(ValueError):
            make_stratification(bad)


def test_wave_speeds_and_internal_wave_are_the_jax_packages_bitwise():
    """baroclinic_wave_speeds (two and four layers) and InternalWave's c1,
    period, densities, exact thickness and initial state bit for bit."""
    for rho, depths in (([1025.0, 1026.0], [100.0, 300.0]), (RHO, [50.0, 80.0, 120.0, 300.0])):
        want = jax_strat.baroclinic_wave_speeds(rho, depths)
        assert np.array_equal(baroclinic_wave_speeds(rho, depths), want)
    mesh = mt.planar_hex_mesh(8, 8, 10000.0, f0=0.0)
    for kw in ({}, dict(lx=80.0, amplitude=0.5)):
        ij, ip = JaxInternalWave(**kw), mt.InternalWave(**kw)
        assert (ip.c1, ip.period, ip.omega, ip.g_prime) == (ij.c1, ij.period, ij.omega,
                                                             ij.g_prime)
        assert ip.densities() == ij.densities()
        x = np.asarray(mesh.cells.x)
        assert np.array_equal(ip.exact_thickness(x, 1234.5), ij.exact_thickness(x, 1234.5))
        for a, b in zip(ip.initial_state(mesh), ij.initial_state(mesh)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        mt.InternalWave().initial_state(mesh, 3)


@pytest.mark.parametrize("kind", ["rho", "dense"])
def test_montgomery_potential_matches_jax(kind):
    """Phi = g ssh + h @ W against the JAX montgomery_potential on the
    unstructured layout (nCells, K) and the lattice's (2, ny2, nx, K), and
    with a float32 W on an f64 state (cast to h's dtype): within 1e-14 of
    scale."""
    sj, sp = _strats(kind)
    rng = np.random.default_rng(3)
    for shape in ((50,), (2, 4, 8)):
        h = 50.0 + rng.normal(size=shape + (K,))
        ssh = rng.normal(size=shape)
        want = np.asarray(jax_strat.montgomery_potential(jnp.asarray(ssh), jnp.asarray(h), sj))
        got = montgomery_potential(torch.from_numpy(ssh), torch.from_numpy(h), sp).numpy()
        assert got.shape == want.shape and max_rel_err(got, want) <= 1e-14
    s32 = make_stratification(RHO, dtype=np.float32)
    got = montgomery_potential(torch.from_numpy(ssh), torch.from_numpy(h), s32)
    assert got.dtype == torch.float64


# (kind, nonlinear, fb, channel, forced, tracers)
STEP_CASES = [
    ("rho", False, False, False, False, False),
    ("dense", False, False, False, False, False),
    ("rho", False, True, False, False, False),
    ("dense", False, True, True, False, False),
    ("rho", False, False, True, False, False),
    ("rho", True, False, False, False, False),
    ("rho", True, True, True, False, False),
    ("rho", False, True, False, True, False),
    ("rho", False, False, True, False, True),
    ("dense", True, True, False, True, True),
]


@pytest.mark.parametrize("kind, nonlinear, fb, channel, forced, tracers", STEP_CASES)
def test_strat_steps_match_jax(kind, nonlinear, fb, channel, forced, tracers):
    """12 steps of structured_run_loop with strat= against the JAX roll
    model's, each field within 1e-12 of its scale; the unstratified run is
    at least 100x that far from it in u (the control)."""
    smj, smp, stj, stp, mj, mp = _lattice(channel, tracers)
    sj, sp = _strats(kind)
    fj = fp = None
    if forced:
        fj = smj.to_struct_forcing(jax_make_forcing(mj, **FULL_FORCING))
        fp = smp.to_struct_forcing(mt.make_forcing(mp, **FULL_FORCING))
    kw = dict(tracer_kappa=5.0, tracer_upwind=0.7)
    ref = jax_run_loop(stj, smj.struct_mesh, DT, 12, nonlinear, fj, strat=sj, fb=fb, **kw)
    out = structured_run_loop(stp, smp.struct_mesh, DT, 12, nonlinear=nonlinear, fb=fb,
                              forcing=fp, strat=sp, **kw)
    fields = STATE_FIELDS + (("tracers",) if tracers else ())
    for f, e in _errs(out, ref, fields).items():
        assert e <= 1e-12, (f, e)
    bare = structured_run_loop(stp, smp.struct_mesh, DT, 12, nonlinear=nonlinear, fb=fb,
                               forcing=fp, **kw)
    assert _errs(bare, ref)["normal_velocity"] >= 100 * 1e-12


@pytest.mark.parametrize("fb", [False, True])
def test_equal_densities_reduce_to_the_unstratified_step(fb):
    """Equal densities (W = 0) reproduce the unstratified steps within
    1e-12 relative (tests/test_stratification.py:48-58): -grad(g ssh) in
    place of -g grad(ssh) is the only difference, a rounding."""
    _, smp, _, stp, _, _ = _lattice(True)
    sm = smp.struct_mesh
    eq = make_stratification([1026.0] * K)
    a = structured_run_loop(stp, sm, DT, 12, fb=fb, strat=eq)
    b = structured_run_loop(stp, sm, DT, 12, fb=fb)
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(a, f).numpy(), getattr(b, f).numpy()) <= 1e-12, f


def _pad_i(x, p):
    return np.concatenate([x[:, :, -p:], x, x[:, :, :p]], axis=2)


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_step_slab_strat_matches_sharded(fb, masked):
    """One full-width slab of 3 interior rows, 8 columns and K levels on a
    random state with a dense random W: step_slab's stratified arm against
    sharded._step_slab's, each field within 1e-13 of its scale, wall masks
    and all."""
    smj, _, _, _, _, _ = _lattice(False)
    terms = smj.struct_mesh.coriolis_terms
    rows, nx = 3, 8
    hm, hi = stencil_reach(terms, fb)
    full = rows + 2 * hm
    rng = np.random.default_rng(31 + 2 * fb + masked)
    h = 50.0 + 0.5 * rng.normal(size=(2, full, nx, K))
    u = 0.05 * rng.normal(size=(6, full, nx, K))
    mask = (rng.random(size=(6, full, nx, 1)) > 0.3).astype(np.float64) if masked else None
    rts = np.full((2, full, nx, 1), 50.0 * K)
    ssh = h.sum(-1, keepdims=True) - rts
    f = 1e-4 + 1e-6 * rng.normal(size=(6, full, nx, 1))
    w = _dense_w(K)
    dt, inv_dc, s_div = DT, 1e-3, 2.0 / (np.sqrt(3.0) * 1e3)
    planes = lambda x: None if x is None else tuple(jnp.asarray(p) for p in x)  # noqa: E731
    ref = jax_step_slab(planes(ssh), planes(h), planes(u), planes(f), planes(rts),
                        jnp.float64(dt), jnp.float64(inv_dc), jnp.float64(s_div), terms, rows,
                        masks=planes(mask), strat_w=jnp.asarray(w), fb=fb)
    t = lambda x: None if x is None else torch.from_numpy(_pad_i(x, hi))  # noqa: E731
    out = step_slab(t(ssh), t(h), t(u), t(f), t(rts), dt, inv_dc, s_div, terms, rows, nx,
                    (hm, hi), fb, t(mask), strat_w=torch.from_numpy(w))
    bare = step_slab(t(ssh), t(h), t(u), t(f), t(rts), dt, inv_dc, s_div, terms, rows, nx,
                     (hm, hi), fb, t(mask))
    for got, want in zip(out, ref[:3]):
        want = np.stack([np.asarray(p) for p in want])
        assert got.shape == want.shape
        assert max_rel_err(got.numpy(), want) <= 1e-13
    assert max_rel_err(bare[2].numpy(), np.stack([np.asarray(p) for p in ref[2]])) >= 1e-10


@pytest.mark.parametrize("channel, fb", [(True, True)])
def test_plain_tiled_rollout_strat_matches_pallas(channel, fb):
    """The tiled kernel's plain windows with strat= against the JAX tiled
    Pallas kernel in interpret mode (row_tile 4, q = 2), 4 FB steps on the
    channel: the port's windows at (4, 8) tiles with q = 2 and at (2, 16)
    with q = 1 each within 1e-12 of scale of it."""
    smj, smp, stj, stp, _, _ = _lattice(channel)
    sj, sp = _strats("rho")
    ref = jax_pallas_tiled_run_loop(stj, smj.struct_mesh, DT, 4, row_tile=4, interpret=True,
                                    q=2, strat=sj, fb=fb)
    out = tiled_run_loop(stp, smp.struct_mesh, DT, 4, row_tile=4, col_tile=8, q=2, fb=fb,
                         strat=sp)
    for f, e in _errs(out, ref).items():
        assert e <= 1e-12, (f, e)
    other = plain_tiled_rollout(stp, smp.struct_mesh, DT, 4, 2, 16, 1, fb, strat=sp)
    for f, e in _errs(other, ref).items():
        assert e <= 1e-12, (f, e)


@pytest.mark.parametrize("kind", ["dense"])
def test_fused_run_loop_strat_matches_pallas(kind):
    """fused_run_loop on the CPU (the fe_step route's plain version) with a
    dense random W against JAX pallas_run_loop in interpret mode, 6 FE steps
    on the periodic lattice: each field within 1e-12 of its scale; and
    structured_auto_run_loop(strat=) on the CPU is structured_run_loop's
    run bit for bit, FE and FB."""
    smj, smp, stj, stp, _, _ = _lattice(False)
    sj, sp = _strats(kind)
    ref = jax_pallas_run_loop(stj, smj.struct_mesh, DT, 6, interpret=True, strat=sj)
    out = fused_run_loop(stp, smp.struct_mesh, DT, 6, strat=sp)
    for f, e in _errs(out, ref).items():
        assert e <= 1e-12, (f, e)
    for fb in (False, True):
        auto = structured_auto_run_loop(stp, smp.struct_mesh, DT, 6, fb=fb, strat=sp)
        plain = structured_run_loop(stp, smp.struct_mesh, DT, 6, fb=fb, strat=sp)
        assert all(torch.equal(getattr(auto, f), getattr(plain, f)) for f in STATE_FIELDS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_strat_casts_as_the_jax_setup(dtype):
    """kernel_strat's W is the JAX _strat_w's cast to the state dtype, bit
    for bit, contiguous; None unstratified."""
    from mpas_ocean_tpu.structured.pallas_model import _strat_w

    sj, sp = _strats("rho")
    npdt = np.float32 if dtype == torch.float32 else np.float64
    w = kernel_strat(sp, dtype, torch.device("cpu"))
    assert w.dtype == dtype and w.is_contiguous()
    assert np.array_equal(w.numpy(), np.asarray(_strat_w(sj, npdt)))
    assert kernel_strat(None, dtype, torch.device("cpu")) is None


def test_card_refuses_strat_with_nonlinear_forcing_or_tracers(monkeypatch):
    """The reverse kernels' stratified arms run with either core, forcing
    and tracers now, so no guard is left: the gradient's steps build
    stratification with the nonlinear core, with forcing and with tracers
    for a CUDA state (its operands kept on the CPU here,
    torch_port_cases.stub_card), W in the state dtype and a (K, K) d(W)
    accumulator in double on hand, and the stratified tiled reverse builds
    at q > 1 too, with each of them and with the nonlinear core, whose q > 1
    runs the q-step nonlinear reverse (no guard left). (The kernels:
    tests/test_torch_composed_adjoint_kernel.py,
    tests/test_torch_window_adjoint_kernel.py,
    tests/test_torch_nl_window_adjoint_kernel.py.)"""
    from mpas_ocean_tpu_torch.structured import diff_model, tiled_diff

    stub_card(monkeypatch)
    strat, cuda = make_stratification(RHO), torch.device("cuda")
    _, smp, _, _, _, mp = _lattice(False)
    forcing = smp.to_struct_forcing(mt.make_forcing(mp, wind_stress_zonal=0.1))
    like = SimpleNamespace(device=cuda, dtype=torch.float32)
    for kw in (dict(nonlinear=True), dict(forcing=forcing), dict(tracers=True)):
        steps = diff_model._Steps(smp.struct_mesh, DT, like, strat=strat, **kw)
        assert steps.sw.dtype == torch.float32 and tuple(steps.sw.shape) == (K, K)
        assert steps.dstrat.dtype == torch.float64 and tuple(steps.dstrat.shape) == (K, K)
    for kw in (dict(forcing=forcing), dict(tracers=True), dict(nonlinear=True)):
        for plan in ((4, 8, 1, 1), (4, 8, 2, 1)):
            steps = tiled_diff._TiledSteps(smp.struct_mesh, DT, like, plan, strat=strat, **kw)
            assert steps.sw.dtype == torch.float32 and tuple(steps.dstrat.shape) == (K, K)
            assert steps.q == plan[2]
    assert not hasattr(tiled_diff, "_check_nl_q")


def test_planners_count_the_stratified_shared_memory():
    """The stratified arms' shared memory (Phi, the staged h, the W slice
    and FB's fresh h') in fe_step's and the tiled kernel's planners: at
    64 x 64 x 100 f32 fe_step's stratified tile still lets two blocks share
    an SM; the tiled FB window grows by 6 sites x kc values plus W's K x kc,
    and its plan fits two blocks per SM; f64 at 100 levels fits a smaller
    tile."""
    k, kc = 100, fe_step.level_split(100)[1]
    tile = fe_step.fe_tile(32, 64, k, 4, strat=True)
    sites = (tile[0] + 2) * (tile[1] + 4)
    extra = fe_step.smem_bytes(tile, k, 4, strat=True) - fe_step.smem_bytes(tile, k, 4)
    assert extra == fe_step.strat_smem_bytes(sites, kc, k, 4) == 16 + 4 * (4 * sites * kc + k * kc)
    assert fe_step.smem_bytes(tile, k, 4, strat=True) <= fe_step.TWO_BLOCK_BYTES
    assert fe_step.fe_tile(32, 64, k, 8, strat=True) != tile
    halo = (2, 2)
    fb = window_bytes(8, 8, 1, halo, k, 4, strat=True, fb=True) - window_bytes(8, 8, 1, halo, k, 4)
    assert fb == 16 + 4 * (6 * 144 * kc + k * kc)
    fe = window_bytes(8, 8, 1, halo, k, 4, strat=True) - window_bytes(8, 8, 1, halo, k, 4)
    assert fb - fe == 4 * 2 * 144 * kc
    window = lambda *a: window_bytes(*a, strat=True, fb=True)  # noqa: E731
    rt, ct, q = resolve_plan(32, 64, k, 4, halo, 100, window=window)
    assert q == 1 and window(rt, ct, 1, halo, k, 4) <= tiled_step.SMEM_BYTES
    assert window(rt, ct, 1, halo, k, 4) <= tiled_step.TWO_BLOCK_BYTES


def test_card_wrappers_pass_the_stratified_operands(monkeypatch):
    """A CPU rehearsal of the card's stratified route: with the kernel
    library stubbed by functions that check each call's argument count and
    types against its argtypes, fe_step.fe_rollout and tiled_step.
    tiled_rollout run with strat_w on a channel, each launch counted as a
    stratified one; W of the wrong shape raises; W with tracers runs, in the
    forward and in the reverse's stack rebuild (the composed arms)."""
    class Entry:
        def __init__(self):
            self.argtypes = None
            self.calls = []

        def __call__(self, *args):
            assert len(args) == len(self.argtypes)
            for a, t in zip(args, self.argtypes):
                want = {ctypes.c_void_p: (int, type(None)), ctypes.c_double: (float,),
                        ctypes.c_int: (int,)}[t]
                assert isinstance(a, want) and not isinstance(a, bool)
            self.calls.append(args)
            return 0

    class Lib:
        def __getattr__(self, name):
            setattr(self, name, Entry())
            return getattr(self, name)

    lib = Lib()
    monkeypatch.setattr(build, "load", lambda: lib)
    dims = lambda h, name="fe_step": tuple(h.shape[1:])  # noqa: E731
    for m in (fe_step, tiled_step):
        monkeypatch.setattr(m, "lattice_dims", dims)
        for c in ("launches", "strat_launches"):
            monkeypatch.setattr(m, c, 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    _, smp, _, stp, _, _ = _lattice(True)
    sm = smp.struct_mesh
    w = kernel_strat(make_stratification(RHO), torch.float64, torch.device("cpu"))
    args = (stp.ssh, stp.layer_thickness, stp.normal_velocity, sm.f_edge.contiguous(),
            sm.resting_thickness_sum.contiguous(), *sm.host_stencil, DT, 1e-3, 1e-3)
    fe_step.fe_rollout(*args, 5, live=kernel_live(sm), strat_w=w)
    tiled_step.tiled_rollout(*args, 4, row_tile=4, col_tile=8, q=2, halo=(2, 2), fb=True,
                             live=kernel_live(sm), strat_w=w)
    assert (fe_step.launches, fe_step.strat_launches) == (5, 5)
    assert (tiled_step.launches, tiled_step.strat_launches) == (2, 2)
    assert lib.mot_fe_steps_f64.calls[0][20] == w.data_ptr()
    assert lib.mot_tiled_steps_f64.calls[0][20] == w.data_ptr()
    with pytest.raises(ValueError):
        fe_step.fe_rollout(*args, 2, strat_w=w[:2])
    # valid tracer operands (check_tracers passes them): the forward runs
    # them with W (the composed arm), the reverse's stack rebuild refuses them
    kt = SimpleNamespace(planes=torch.zeros(2, *stp.layer_thickness.shape[1:],
                                            dtype=torch.float64),
                         cell_mask=sm.cell_mask.double().contiguous(), kappa=0.0, upwind=1.0)
    fe_step.check_tracers(kt, kernel_live(sm), *stp.layer_thickness.shape[1:], torch.float64,
                          torch.device("cpu"))
    fe_step.fe_rollout(*args, 2, live=kernel_live(sm), tracers=kt, strat_w=w)
    assert (fe_step.launches, fe_step.strat_launches) == (7, 7)
    stack = tuple(torch.zeros((3, *x.shape), dtype=torch.float64)
                  for x in (stp.ssh, stp.layer_thickness, stp.normal_velocity))
    kt_stack = KernelTracers(kt.planes.expand(3, *kt.planes.shape).contiguous(), kt.cell_mask,
                             kt.kappa, kt.upwind)
    fe_step.check_tracer_stack(kt_stack, kernel_live(sm), 3, *stp.layer_thickness.shape[1:],
                               torch.float64, torch.device("cpu"))
    fe_step.fe_fill_stack(stack, *args[3:], 2, live=kernel_live(sm), tracers=kt_stack,
                          strat_w=w)
    assert (fe_step.launches, fe_step.strat_launches) == (9, 9)
    call = lib.mot_fe_stack_f64.calls[-1]
    assert call[10] == kt_stack.planes.data_ptr() and call[12] == w.data_ptr()


def test_internal_wave_half_period_fb():
    """The two-layer internal wave (tests/test_stratification.py:276-322) on a
    32 x 32 f0 = 0 lattice through the plain FB steps of the lattice model,
    half a period at dt = 100 s (1890 steps): the first baroclinic mode's
    amplitude inverts within 5%, and the layer thicknesses are within 0.05
    of the amplitude of the exact standing wave (RMSE)."""
    n, dc = 32, 10000.0
    iw = mt.InternalWave(lx=n * dc / 1e3, amplitude=1.0)
    horz = mt.planar_hex_mesh(n, n, dc, f0=0.0)
    vert = mt.make_vertical_mesh(horz, 2, resting_thickness=np.tile(
        np.array([iw.h1, iw.h2]), (horz.n_cells, 1)))
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), n, n, device="cpu")
    ssh, h, u = iw.initial_state(horz)
    st = model.to_struct(mt.PrognosticVars(*(torch.from_numpy(a) for a in (ssh, h, u))))
    n_half = int(round(iw.period / 2 / 100.0))
    assert n_half == 1890
    out = model.from_struct(structured_run_loop(st, model.struct_mesh, 100.0, n_half, fb=True,
                                                strat=make_stratification(iw.densities())))
    x = np.asarray(horz.cells.x)
    basis = np.sin(iw.k * x)
    proj = lambda f: float(np.vdot(basis, f - iw.h1) / np.vdot(basis, basis))  # noqa: E731
    a0, a1 = proj(h[:, 0]), proj(out.layer_thickness[:, 0].numpy())
    np.testing.assert_allclose(a1, -a0, rtol=0.05)
    exact = iw.exact_thickness(x, n_half * 100.0)
    rmse = float(np.sqrt(np.mean((out.layer_thickness.numpy() - exact) ** 2)))
    assert rmse < 0.05 * iw.amplitude

