"""The composed physics of the port (the nonlinear core, momentum forcing,
tracers and layered stratification, two or more together) against the JAX
package's, on the CPU at f64 (numpy-seeded inputs): the roll steps in every
combination of two or more options, forward Euler and forward-backward,
periodic and on the coastal channel, against the JAX roll model; all four
together through the port's plain windows (the tiled and fused kernels'
plain version) against the JAX Pallas kernels in interpret mode
(``pallas_run_loop`` FE and FB, ``pallas_tiled_run_loop`` FE at q = 1 and
2); the planners' shared memory of the composed arms; a CPU rehearsal of
the card's composed wrappers with the kernel library stubbed; and the
gradient's card steps for the combinations. The CUDA composed arms
are held against these plain versions on the card
(tests/test_torch_composed_kernel.py, chip_smoke.py phase 19).
"""

import contextlib
import ctypes
import itertools
from types import SimpleNamespace

import jax
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
from mpas_ocean_tpu_torch.kernels import build, fe_step, tiled_step
from mpas_ocean_tpu_torch.structured import diff_model, structured_run_loop
from mpas_ocean_tpu_torch.structured.fused_model import (
    kernel_forcing,
    kernel_live,
    kernel_strat,
    kernel_tracers,
    nl_setup,
    nl_scal,
)
from mpas_ocean_tpu_torch.structured.tiled_model import plain_tiled_rollout, window_bytes

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
TR_KW = dict(tracer_kappa=5.0, tracer_upwind=0.7)
OPTIONS = ("nonlinear", "forced", "tracers", "strat")
# every combination of two or more options: 6 + 4 + 1
COMBOS = [c for r in (2, 3, 4) for c in itertools.combinations(OPTIONS, r)]


def _case(n, channel=False, seed=5):
    """(JAX model, port model, JAX state, port state, the forcing of each
    package, the stratification of each) on ``nl_periodic``'s or
    ``nl_channel``'s n x n lattice of K 50 m levels, the states carrying two
    tracers (T with a wave and noise, S = 35) made by each package from the
    same numpy fields."""
    smj, smp, stj, stp, mj, mp = (nl_channel if channel else nl_periodic)(n, K, seed)
    x = np.asarray(mp.horz.cells.x)
    rng = np.random.default_rng(9)
    fields = [10.0 + 2.0 * np.sin(2 * np.pi * x / (x.max() + 1))[:, None]
              + 0.3 * rng.normal(size=(mp.n_cells, K)), np.full(mp.n_cells, 35.0)]
    progj = smj.from_struct(stj).replace(tracers=jax_make_tracers(mj, fields))
    progp = mt.PrognosticVars(*(getattr(smp.from_struct(stp), f) for f in STATE_FIELDS),
                              tracers=mt.make_tracers(mp, fields))
    forcing = (smj.to_struct_forcing(jax_make_forcing(mj, **FULL_FORCING)),
               smp.to_struct_forcing(mt.make_forcing(mp, **FULL_FORCING)))
    strat = jax_strat.make_stratification(RHO), mt.make_stratification(RHO)
    return smj, smp, smj.to_struct(progj), smp.to_struct(progp), forcing, strat


def _bare(st):
    """The state without its tracers."""
    return type(st)(st.ssh, st.layer_thickness, st.normal_velocity)


def _errs(out, ref, fields) -> dict:
    return {f: max_rel_err(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
            for f in fields}


@pytest.fixture(scope="module", params=[False, True], ids=["periodic", "channel"])
def case16(request):
    return _case(16, request.param)


@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
@pytest.mark.parametrize("combo", COMBOS, ids="+".join)
def test_composed_steps_match_jax(case16, combo, fb):
    """Two steps of structured_run_loop with two or more of the options
    against the JAX roll model's (run eagerly: one compile per combination
    would cost seconds), on the 16 x 16 x 4 periodic lattice and the 16^2
    channel: every field, the tracers too, within 1e-12 of its scale; each
    run with one of its options other than the tracers dropped misses it by
    at least 100x that in some state field (the control)."""
    smj, smp, stj, stp, (fj, fp), (sj, sp) = case16
    on = set(combo)

    def port(opts):
        return structured_run_loop(stp if "tracers" in opts else _bare(stp), smp.struct_mesh,
                                   DT, 2, nonlinear="nonlinear" in opts, fb=fb,
                                   forcing=fp if "forced" in opts else None,
                                   strat=sp if "strat" in opts else None, **TR_KW)

    with jax.disable_jit():
        ref = jax_run_loop(stj if "tracers" in on else _bare(stj), smj.struct_mesh, DT, 2,
                           "nonlinear" in on, fj if "forced" in on else None,
                           strat=sj if "strat" in on else None, fb=fb, **TR_KW)
    fields = STATE_FIELDS + (("tracers",) if "tracers" in on else ())
    for f, e in _errs(port(on), ref, fields).items():
        assert e <= 1e-12, (f, e)
    for drop in on - {"tracers"}:
        miss = max(_errs(port(on - {drop}), ref, STATE_FIELDS).values())
        assert miss >= 100 * 1e-12, (drop, miss)


@pytest.mark.parametrize("fb, channel", [(False, False), (True, True)], ids=["FE", "FB-channel"])
def test_all_options_fused_kernel_matches_plain_windows(fb, channel):
    """All four options together: JAX pallas_run_loop (kernel 1) in
    interpret mode, 3 steps on the 8 x 8 x 4 lattice (FE periodic, FB on the
    channel), against the port's plain windows (plain_tiled_rollout, whose
    windows ``slab.window_steps`` steps) at (2, 4) tiles and q = 1: every
    field within 1e-12 of its scale."""
    smj, smp, stj, stp, (fj, fp), (sj, sp) = _case(8, channel)
    ref = jax_pallas_run_loop(stj, smj.struct_mesh, DT, 3, interpret=True, nonlinear=True,
                              forcing=fj, strat=sj, fb=fb, **TR_KW)
    out = plain_tiled_rollout(stp, smp.struct_mesh, DT, 3, 2, 4, 1, fb, nonlinear=True,
                              forcing=fp, strat=sp, **TR_KW)
    for f, e in _errs(out, ref, STATE_FIELDS + ("tracers",)).items():
        assert e <= 1e-12, (f, e)


@pytest.mark.parametrize("n, q", [(8, 1), (20, 2)])
def test_all_options_tiled_kernel_matches_plain_windows(n, q):
    """All four options together: JAX pallas_tiled_run_loop (kernel 2) in
    interpret mode, 2 FE steps in row tiles of 2 at q = 1 (8 x 8 x 4) and
    q = 2 (20 x 20 x 4, the least lattice whose rows hold a nonlinear q = 2
    window), against the port's plain windows at the same plan (full-width
    tiles): every field within 1e-12 of its scale."""
    smj, smp, stj, stp, (fj, fp), (sj, sp) = _case(n)
    ref = jax_pallas_tiled_run_loop(stj, smj.struct_mesh, DT, 2, row_tile=2, q=q,
                                    interpret=True, nonlinear=True, forcing=fj, strat=sj,
                                    **TR_KW)
    out = plain_tiled_rollout(stp, smp.struct_mesh, DT, 2, 2, n, q, False, nonlinear=True,
                              forcing=fp, strat=sp, **TR_KW)
    for f, e in _errs(out, ref, STATE_FIELDS + ("tracers",)).items():
        assert e <= 1e-12, (f, e)


ARMS = [dict(forced=f, n_tracers=t, strat=s)
        for f, t, s in itertools.product((False, True), (0, 2), (False, True))]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_planners_count_the_composed_shared_memory(itemsize):
    """The composed arms' shared memory in every planner is the plain
    layout plus each arm's part (the kernels' own reckoning, csrc/
    nl_step.cuh, fe_step.cu, tiled_step.cu): the nonlinear step's tracer
    planes in both state slices, the stratified arm's deferred pressure and
    Phi's buffers on the tile plus one ring, the forced arm's tile planes;
    the plans of every composition at 64^2 and 256^2 x 100 fit one block,
    take the largest slice that fits, and shrink (never grow) as arms are
    added."""
    k = 100
    kc = fe_step.level_split(k)[1]
    for fb in (False, True):
        rt, ct = 4, 8
        (hm, hi), (dr, dc) = fe_step.NL_REACH[fb], fe_step.NL_RING[fb]
        w, d = (rt + 2 * hm) * (ct + 2 * hi), (rt + 2 * dr) * (ct + 2 * dc)
        f, core = (rt + 2) * (ct + 2), rt * ct
        for arms in ARMS:
            n_tr, strat = arms["n_tracers"], arms["strat"]
            vals = (2 * (8 + 2 * n_tr) * w * 4 + 20 * d * 4 + 24 * w + 2 * (f if fb else core)
                    + ((2 * f + 6 * core * kc) if fb or strat else 0))
            want = (itemsize * vals + 8 * w
                    + (16 + itemsize * (6 * f * kc + k * kc) if strat else 0)
                    + (16 + (itemsize + 4) * 6 * core if arms["forced"] else 0))
            assert fe_step.nl_smem_bytes((rt, ct), k, itemsize, fb, 4, **arms) == want
            for n in (64, 256):
                prt, pct, ks = fe_step.nl_plan(n // 2, n, k, itemsize, fb, **arms)
                assert fe_step.nl_smem_bytes((prt, pct), k, itemsize, fb, ks, **arms) \
                    <= fe_step.SMEM_BYTES
                assert ks == min(16, kc) or fe_step.nl_smem_bytes(
                    (prt, pct), k, itemsize, fb, 2 * ks, **arms) > fe_step.SMEM_BYTES
                plain = fe_step.nl_plan(n // 2, n, k, itemsize, fb)
                assert prt * pct <= plain[0] * plain[1]
    for arms in ARMS:
        n_tr, strat, forced = arms["n_tracers"], arms["strat"], arms["forced"]
        tile = (4, 16)
        sites = (4 + 2) * (16 + 4)
        assert fe_step.smem_bytes(tile, k, itemsize, forced, n_tr, strat) == (
            fe_step.smem_bytes(tile, k, itemsize)
            + itemsize * sites * 2 * n_tr * kc
            + (fe_step.strat_smem_bytes(sites, kc, k, itemsize) if strat else 0)
            + (fe_step.forcing_smem_bytes(sites, 0, itemsize) if forced else 0))
        if n_tr or strat:
            rt, ct = fe_step.fe_tile(32, 64, k, itemsize, n_tr, strat, forced)
            assert fe_step.smem_bytes((rt, ct), k, itemsize, forced, n_tr, strat) \
                <= fe_step.SMEM_BYTES
        for fb in (False, True):
            halo = (2 if fb else 1, 2)
            q_sites = (8 + 2 * halo[0]) * (8 + 2 * halo[1])
            assert window_bytes(8, 8, 1, halo, k, itemsize, fb=fb, **arms) == (
                window_bytes(8, 8, 1, halo, k, itemsize)
                + itemsize * q_sites * 2 * n_tr * kc
                + (fe_step.strat_smem_bytes(q_sites, kc, k, itemsize, fb) if strat else 0)
                + (fe_step.forcing_smem_bytes(q_sites, 0, itemsize) if forced else 0))
    # a composition that fits no tile raises
    with pytest.raises(ValueError):
        fe_step.nl_plan(32, 64, k, 8, True, forced=True, n_tracers=200, strat=True)


class _Entry:
    """A stub of one kernel entry: checks each call's arguments against
    its argtypes and records them."""

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


def test_card_wrappers_pass_the_composed_operands(monkeypatch):
    """A CPU rehearsal of the card's composed wrappers: with the kernel
    library stubbed by entries that check each call's arguments against
    their argtypes, the nonlinear FE (fe_step) and FB (tiled_step) wrappers
    and the linear ones run forced, with tracers and stratified on the
    channel, each launch counted in every arm's counter, the operands where
    the entries take them and the new tracer planes returned fourth; the
    reverse's stack rebuild takes W with forcing."""
    class Lib:
        def __getattr__(self, name):
            setattr(self, name, _Entry())
            return getattr(self, name)

    lib = Lib()
    monkeypatch.setattr(build, "load", lambda: lib)
    dims = lambda h, name="fe_step": tuple(h.shape[1:])  # noqa: E731
    for m in (fe_step, tiled_step):
        monkeypatch.setattr(m, "lattice_dims", dims)
        for c in ("launches", "forced_launches", "tracer_launches", "strat_launches"):
            monkeypatch.setattr(m, c, 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    _, smp, _, stp, (_, fp), (_, sp) = _case(16, True)
    sm, dtype, cpu = smp.struct_mesh, torch.float64, torch.device("cpu")
    arms = dict(live=kernel_live(sm), forcing=kernel_forcing(fp, sm, dtype, cpu),
                tracers=kernel_tracers(stp, sm, TR_KW["tracer_kappa"], TR_KW["tracer_upwind"]),
                strat_w=kernel_strat(sp, dtype, cpu))
    rts = sm.resting_thickness_sum.contiguous()
    state = (stp.ssh, stp.layer_thickness, stp.normal_velocity)
    nl_args = (*state, rts, *sm.host_stencil, nl_setup(sm, dtype), sm.vertex_cell_terms,
               sm.edge_vertex_terms, DT, 1e-3, 1e-3, *nl_scal(sm, dtype))
    out = fe_step.fe_nl_rollout(*nl_args, 3, **arms)
    assert len(out) == 4 and out[3].shape == arms["tracers"].planes.shape
    out = tiled_step.tiled_nl_rollout(*nl_args, 2, **arms)
    assert len(out) == 4
    lin = (*state, sm.f_edge.contiguous(), rts, *sm.host_stencil, DT, 1e-3, 1e-3)
    assert len(fe_step.fe_rollout(*lin, 5, **arms)) == 4
    assert len(tiled_step.tiled_rollout(*lin, 4, row_tile=4, col_tile=8, q=2, halo=(2, 2),
                                        fb=True, **arms)) == 4
    assert (fe_step.launches, fe_step.forced_launches, fe_step.tracer_launches,
            fe_step.strat_launches) == (8, 8, 8, 8)
    assert (tiled_step.launches, tiled_step.forced_launches, tiled_step.tracer_launches,
            tiled_step.strat_launches) == (4, 4, 4, 4)
    kt, kf, w = arms["tracers"], arms["forcing"], arms["strat_w"]
    for entry in (lib.mot_fe_nl_steps_f64, lib.mot_tiled_nl_steps_f64):
        args = entry.calls[0]
        # live, wind and levels after (rts, fv, n_fv); the tracer planes,
        # the cell mask and W after the nine state pointers
        assert args[3:6] == (arms["live"].data_ptr(), kf.wind.data_ptr(), kf.levels.data_ptr())
        assert args[20] == kt.planes.data_ptr() and args[23] == kt.cell_mask.data_ptr()
        assert args[24] == w.data_ptr() and args[-2] == 2
        assert args[32:37] == (*(float(c) for c in kf.coefs), *fe_step.forcing_ranks(
            kf, fe_step.level_split(K)[1]))
    assert lib.mot_fe_steps_f64.calls[0][20] == w.data_ptr()
    assert lib.mot_tiled_steps_f64.calls[0][20] == w.data_ptr()
    # a tile whose composed window does not fit raises before any launch
    with pytest.raises(ValueError):
        fe_step.fe_nl_rollout(*nl_args, 1, tile=(16, 16), ks=4, **arms)
    # the reverse's rebuild runs the stratified arm forced too
    stack = tuple(torch.zeros((3, *x.shape), dtype=dtype) for x in state)
    fe_step.fe_fill_stack(stack, sm.f_edge.contiguous(), rts, *sm.host_stencil, DT, 1e-3,
                          1e-3, 2, live=arms["live"], forcing=kf, strat_w=w)
    call = lib.mot_fe_stack_f64.calls[-1]
    assert call[3] == kf.wind.data_ptr() and call[12] == w.data_ptr()


def test_gradients_refuse_the_combinations_on_the_card(monkeypatch):
    """The reverse of the combinations is ported: the gradient's steps
    (diff_model._Steps) build on a CUDA device (its operands kept on the CPU
    here, torch_port_cases.stub_card) for forcing with the nonlinear core,
    tracers with the nonlinear core or forcing, and stratification with the
    nonlinear core, forcing or tracers, no refusal left, each with its arms'
    operands and accumulators on hand (the nonlinear reverse's among them);
    a CPU state runs them."""
    stub_card(monkeypatch)
    _, smp, _, stp, (_, fp), (_, sp) = _case(16)
    sm = smp.struct_mesh
    cuda = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float64)
    combos = [dict(nonlinear=True, forcing=fp), dict(nonlinear=True, tracers=True),
              dict(forcing=fp, tracers=True), dict(nonlinear=True, strat=sp),
              dict(forcing=fp, strat=sp), dict(tracers=True, strat=sp),
              dict(nonlinear=True, forcing=fp, tracers=True, strat=sp)]
    for kw in combos:
        steps = diff_model._Steps(sm, DT, cuda, **kw)
        assert steps.cuda and (steps.kf is not None) == ("forcing" in kw)
        assert (steps.dforc is not None) == ("forcing" in kw)
        assert (steps.sw is not None) == ("strat" in kw) == (steps.dstrat is not None)
        assert hasattr(steps, "nl_adj") == ("nonlinear" in kw)
        diff_model._Steps(sm, DT, stp.layer_thickness, **kw)
