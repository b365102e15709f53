"""The q > 1 arms of the port's tiled kernels on the CPU at f64, against the
JAX package (numpy-seeded inputs, lattices of 8 x 8 and 28 x 28 with
4 levels; each JAX call in interpret mode costs ~15-27 s of tracing):
* the nonlinear forward-backward window steps at q = 2 with forcing, two
  tracers and stratification together (``tiled_run_loop``'s plain version)
  against ``pallas_tiled_run_loop`` in interpret mode;
* the tiled reverse at q = 2 with tracers, with tracers, W and forcing
  together, and with those and the nonlinear core (``tiled_adjoint_rollout``'s
  plain supersteps) against ``_pallas_tiled_adjoint`` in interpret mode (the
  stratified reverse alone at q = 2: tests/test_torch_strat_adjoint.py);
* the Python mirrors of the q-step kernels' shared memory and scratch
  (csrc/nl_tiled.cuh, csrc/tiled_adjoint.cu, csrc/nl_window_adjoint.cuh)
  against bytes counted by hand, the wide level split of the tracer reverse
  at q > 1, the planners' tiles and the refusals of plans that do not fit;
* a CPU rehearsal of the card's nonlinear tiled reverse at q = 2 (the
  kernel library stubbed) and the CPU route's q = 2 nonlinear gradient.
The kernels themselves run on a card: tests/test_torch_window_kernel.py,
tests/test_torch_window_adjoint_kernel.py,
tests/test_torch_nl_window_adjoint_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from mpas_ocean_tpu.structured.pallas_model import (
    _cot_from_planes,
    _forcing_setup,
    _nl_setup,
    _pallas_tiled_adjoint,
    _strat_w,
    _tiled_scal,
    _tr_planes,
)
from mpas_ocean_tpu.structured.pallas_model import pallas_tiled_run_loop as jax_pallas_tiled

from mpas_ocean_tpu_torch.kernels import fe_step, tiled_adjoint
from mpas_ocean_tpu_torch.structured import struct_state_from_numpy, tiled_adjoint_rollout
from mpas_ocean_tpu_torch.structured import tiled_diff, tiled_run_loop
from test_torch_composed import DT, K, TR_KW, _case, _errs
from test_torch_tracers import tracer_lattice
from torch_port_cases import STATE_FIELDS, max_rel_err

FIELDS = STATE_FIELDS + ("tracers",)


def test_nonlinear_fb_q2_all_options_matches_jax():
    """All four options at q = 2: JAX pallas_tiled_run_loop (kernel 2) in
    interpret mode, 2 FB steps of the nonlinear core with forcing, two
    tracers and stratification in row tiles of 2 on the 28 x 28 x 4 lattice
    (14 rows a parity: the FB q = 2 window's 12 halo rows and a tile),
    against the port's tiled_run_loop on the CPU at the same q (its plain
    windows): every field within 1e-12 of its scale."""
    smj, smp, stj, stp, (fj, fp), (sj, sp) = _case(28)
    ref = jax_pallas_tiled(stj, smj.struct_mesh, DT, 2, row_tile=2, q=2, interpret=True,
                           nonlinear=True, forcing=fj, strat=sj, fb=True, **TR_KW)
    out = tiled_run_loop(stp, smp.struct_mesh, DT, 2, row_tile=2, col_tile=4, q=2,
                         nonlinear=True, fb=True, forcing=fp, strat=sp, **TR_KW)
    for f, e in _errs(out, ref, FIELDS).items():
        assert e <= 1e-12, (f, e)


def _random_cotangent(state, seed):
    rng = np.random.default_rng(seed)
    return {f: rng.normal(size=tuple(getattr(state, f).shape)) for f in FIELDS}


@pytest.mark.parametrize("arms", ["tracers", "tracers+strat+forcing",
                                  "nonlinear+tracers+strat+forcing"])
def test_tiled_reverse_q2_matches_jax_tiled_adjoint(arms):
    """tiled_adjoint_rollout's plain route at q = 2 (the vjp of the slab
    windows, tiles of 2 x 4, groups of 2) against _pallas_tiled_adjoint in
    interpret mode (row tile 2, q = 2, groups of 2), 4 steps with two
    tracers (kappa 5, upwind 0.7) on the 8 x 8 x 4 channel (the windows wrap
    onto themselves), or on the periodic lattice with the tracers, a
    stratification and forcing
    together, and with those and the nonlinear core (nl_terms=, f_vert=; the
    8 x 8 x 4 lattice is the smallest here whose rows hold the nonlinear
    q = 2 windows, which wrap onto themselves; the plain version of the
    q-step nonlinear reverse kernel): the state's cotangent, the tracers'
    among it, within 1e-12 of scale; d(dt), d(W), d(wind) and d(r_lin, Cd,
    lambda) to 1e-10 of theirs."""
    full = arms != "tracers"
    nonlinear = arms.startswith("nonlinear")
    if full:
        smj, smp, stj, stp, (fj, fp), (sj, sp) = _case(8)
    else:
        smj, smp, stj, stp, _, _ = tracer_lattice(8, K, channel=True)
        fj = fp = sj = sp = None
    sj_m = smj.struct_mesh
    n, rt, b = 4, 2, 2
    ny2, nx, k = sj_m.ny2, sj_m.nx, stj.layer_thickness.shape[-1]
    dtype = stj.layer_thickness.dtype
    g = _random_cotangent(stp, 13)
    gj = stj.replace(**{f: jnp.asarray(v) for f, v in g.items()})
    fwind, fidx = _forcing_setup(fj, ny2, nx, dtype)
    mask = cmask = None
    if sj_m.edge_mask is not None:
        mask = sj_m.edge_mask.reshape(6, ny2, nx, 1).astype(dtype)
        cmask = sj_m.cell_mask.reshape(2, ny2, nx, 1).astype(dtype)
    nl_terms, f_vert = _nl_setup(sj_m, dtype, True) if nonlinear else (None, None)
    cot, dscal, dwind, dsw = _pallas_tiled_adjoint(
        _tiled_scal(sj_m, DT, dtype, fj, nonlinear), stj.ssh[..., None], stj.layer_thickness,
        stj.normal_velocity.reshape(6, ny2, nx, k), sj_m.f_edge.reshape(6, ny2, nx, 1),
        sj_m.resting_thickness_sum[..., None],
        (gj.ssh[..., None], gj.layer_thickness, gj.normal_velocity.reshape(6, ny2, nx, k),
         _tr_planes(gj.tracers, ny2, nx, k)),
        mask, terms=sj_m.coriolis_terms, row_tile=rt, n_steps=n, b=b, interpret=True, q=2,
        fwind=fwind, fidx=fidx, tracers0=_tr_planes(stj.tracers, ny2, nx, k), cmask=cmask,
        strat_w=_strat_w(sj, dtype),
        tropts=(TR_KW["tracer_kappa"], TR_KW["tracer_upwind"]), f_vert=f_vert,
        nl_terms=nl_terms)
    ref = _cot_from_planes(cot, ny2, nx, k)
    res = tiled_adjoint_rollout(stp, smp.struct_mesh, DT, n, struct_state_from_numpy(g),
                                plan=(rt, 4, 2, b), forcing=fp, strat=sp, nonlinear=nonlinear,
                                **TR_KW)
    for f in FIELDS:
        err = max_rel_err(getattr(res[0], f).numpy(), np.asarray(getattr(ref, f)))
        assert err <= 1e-12, (f, err)
    np.testing.assert_allclose(float(res[1]), float(dscal[0]), rtol=1e-10)
    if full:
        d_forc, d_w = res[2], res[3]
        want = np.asarray(dsw)
        np.testing.assert_allclose(d_w.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
        want = np.asarray(dwind).reshape(d_forc.wind.shape)
        np.testing.assert_allclose(d_forc.wind.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
        np.testing.assert_allclose(d_forc.coefs.numpy(), np.asarray(dscal[3:6]).ravel(),
                                   rtol=1e-10)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
def test_q_step_kernel_shared_memory_by_hand(fb, itemsize):
    """fe_step.nl_smem_bytes at q > 1 (csrc/nl_tiled.cuh,
    nl_tiled_smem_bytes): the q = 1 kernel's bytes at the tile grown by
    q - 1 reaches per side, counted here by hand with every arm, plus a
    second ssh pair (2 values per window site); and the q-step scratch is
    8 + 2 nT planes of the grown tile a tile."""
    k, ks, q = 100, 4, 2
    kc = fe_step.level_split(k)[1]
    (hm, hi), (dr, dc) = fe_step.NL_REACH[fb], fe_step.NL_RING[fb]
    rt, ct = 2 + 2 * hm * (q - 1), 4 + 2 * hi * (q - 1)
    w, d = (rt + 2 * hm) * (ct + 2 * hi), (rt + 2 * dr) * (ct + 2 * dc)
    f, core = (rt + 2) * (ct + 2), rt * ct
    n_tr = 2
    vals = (2 * (8 + 2 * n_tr) * w * ks + 20 * d * ks + 24 * w + 2 * (f if fb else core)
            + 2 * f + 6 * core * kc + 2 * w)
    want = (itemsize * vals + 8 * w + 16 + itemsize * (6 * f * kc + k * kc)
            + 16 + (itemsize + 4) * 6 * core)
    got = fe_step.nl_smem_bytes((2, 4), k, itemsize, fb, ks, forced=True, n_tracers=n_tr,
                                strat=True, q=q)
    assert got == want
    assert got - fe_step.nl_smem_bytes((rt, ct), k, itemsize, fb, ks, forced=True,
                                       n_tracers=n_tr, strat=True) == 2 * w * itemsize
    assert fe_step.nl_scratch_size(20, 32, k, (2, 4), q, fb, n_tr) == \
        (10 * 8) * (8 + 2 * n_tr) * core * k


def test_tiled_reverse_q_arms_shared_memory_by_hand():
    """tiled_adjoint.smem_bytes at q > 1 with tracers and stratification
    (csrc/tiled_adjoint.cu, smem_bytes) against bytes counted by hand: the
    tracer planes in all q + 2 chunks, the S chunk on R_{q-1} in chunks of
    the power of two at or above the level chunk; the tracer arm's levels
    over up to 16 blocks at q > 1 (15 blocks of 7 at K = 100), 8 without
    tracers or at q = 1; bench.py's FTS gradient at q = 2 on 256 x 256 x 100
    f32 fits the (2, 4) tile, at the 8-block split not even (1, 1)."""
    assert tiled_adjoint.level_split(100, 2, 2) == (15, 7)
    assert tiled_adjoint.level_split(100, 2) == (8, 13)
    assert tiled_adjoint.level_split(100, 1, 2) == (7, 16)
    assert tiled_adjoint.level_split(36, 3, 1) == (12, 3)
    k, q, n_tr, item = 100, 2, 2, 4
    rt, ct, halo = 2, 4, (1, 2)
    ranks, kc = tiled_adjoint.level_split(k, q, n_tr)
    sites = (rt + 2 * 3) * (ct + 4 * 3)
    s_cells = (rt + 2) * (ct + 4)
    assert tiled_adjoint.window_sites(rt, ct, q, halo) == sites
    assert tiled_adjoint.strat_cells(rt, ct, q, halo) == s_cells
    kp = 8  # the power of two at or above kc = 7
    want = (8 * 16 + item * (sites * ((8 + 2 * n_tr) * (q + 2) * kc + 8 + 2 * q + 6)
                             + ranks * 2 * rt * ct)
            + 8 * sites + 16 + item * 6 * sites + 4 * 6 * sites
            + 16 + item * (2 * s_cells * kp + k * kp))
    got = tiled_adjoint.smem_bytes(sites, rt * ct, k, q, item, True, n_tr, True, s_cells)
    assert got == want
    assert tiled_diff.adjoint_window_bytes(rt, ct, q, halo, k, item, True, n_tr, True) == want
    assert want <= tiled_adjoint.SMEM_BYTES
    assert tiled_diff.tiled_adjoint_plan(128, 256, k, item, 100, halo=halo, q=2, n_tracers=2,
                                         strat=True, forced=True)[:3] == (2, 4, 2)
    narrow = ((8 + 2 * n_tr) * (q + 2) * 13 + 8 + 2 * q + 6) * item * \
        tiled_adjoint.window_sites(1, 1, q, halo)
    assert narrow > tiled_adjoint.SMEM_BYTES


def test_plans_that_do_not_fit_are_refused():
    """An explicit q is run or refused with a ValueError that names the
    shared memory: the nonlinear planner at q > 1 for a composition that no
    tile fits (FB, every arm, q = 2 at 100 levels of f64; in f32, where no
    tile of fe_step.NL_Q_SITES sites fits at any slice, its tile is sized at
    one level per slice), the tiled
    reverse's planner for a window no tile fits (tracers at q = 3 and 100
    levels of f32); nothing lowers q for it."""
    with pytest.raises(ValueError, match="shared memory"):
        fe_step.nl_plan(128, 256, 100, 8, True, forced=True, n_tracers=2, strat=True, q=2)
    arms = dict(forced=True, n_tracers=2, strat=True)
    rt, ct, ks = fe_step.nl_plan(128, 256, 100, 4, True, **arms, q=2)
    assert (rt, ct, ks) == (4, 4, 1)  # no 32-site tile fits: sized at one level per slice
    assert fe_step.nl_smem_bytes((rt, ct), 100, 4, True, 1, **arms, q=2) <= fe_step.SMEM_BYTES
    assert fe_step.nl_smem_bytes((rt, ct), 100, 4, True, 2, **arms, q=2) > fe_step.SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        tiled_diff.tiled_adjoint_plan(128, 256, 100, 4, 99, halo=(1, 2), q=3, n_tracers=2)


def test_nonlinear_q2_plain_windows_match_the_roll_steps():
    """tiled_run_loop's plain nonlinear windows at q = 2 and q = 3 (FE, FB;
    the 28 x 28 x 4 lattice with every option) against structured_run_loop's
    roll steps on the same state, 6 steps: within 1e-12 of scale, the plan's
    q kept."""
    from mpas_ocean_tpu_torch.structured import structured_run_loop

    _, smp, _, stp, (_, fp), (_, sp) = _case(28)
    sm = smp.struct_mesh
    for fb, q in ((False, 2), (False, 3), (True, 2)):
        out = tiled_run_loop(stp, sm, DT, 6, q=q, nonlinear=True, fb=fb, forcing=fp, strat=sp,
                             **TR_KW)
        ref = structured_run_loop(stp, sm, DT, 6, nonlinear=True, fb=fb, forcing=fp, strat=sp,
                                  **TR_KW)
        for f in FIELDS:
            err = max_rel_err(getattr(out, f).numpy(), getattr(ref, f).numpy())
            assert err <= 1e-12, (fb, q, f, err)
    assert torch.is_tensor(out.tracers)


def test_nl_window_shared_memory_and_scratch_by_hand():
    """adjoint_step.nl_window_smem_bytes (csrc/nl_window_adjoint.cuh,
    nl_window_smem_bytes) against bytes counted by hand for a (4, 8) tile
    at 100 f32 levels in slices of 2 with two tracers, W and forcing: 128
    bytes of d(dt) sums and 4 ints per reverse window site, then the larger
    of the reverse's layout (two slices of 12 planes on the 12 x 20 window,
    rings A, B, C, 24 values a window site, the partial sums, the S chunk and
    W rows) and the recompute's (one slice on the 8 x 16 FE window, 20
    derived planes on the 6 x 12 ring, 24 values a window site, the partial
    sums, Phi's ssh and the kept momentum, StratSmem with the h chunk, the
    winds and levels); the same at any q. The scratch of a (2, 4) tile
    counted by hand at q = 2 and 3: q - 1 primal slots over the tile grown by
    q (4, 6) + (q - 2) (2, 4), min(q - 1, 2) cotangent slots over the tile
    grown by (q - 1) (4, 6), each 7 ranks' ssh pairs and 12 planes of 100
    levels."""
    from mpas_ocean_tpu_torch.kernels import adjoint_step

    k, kc, ks, n_tr, item = 100, 16, 2, 2, 4
    w, a, b, c = 12 * 20, 10 * 16, 8 * 12, 6 * 10
    fw, d, fs, core = 8 * 16, 6 * 12, 6 * 10, 32
    rev = (item * ((2 * 12 * w + 12 * a + 14 * b + 8 * c) * ks + 24 * w + 2 * core)
           + 16 + item * (2 * core * kc + k * kc))
    fwd = (item * ((12 * fw + 20 * d) * ks + 24 * fw + 2 * core + 2 * fs + 6 * core * kc)
           + 16 + item * (6 * fs * kc + k * kc) + 16 + (item + 4) * 6 * core)
    want = 128 + 16 * w + max(rev, fwd)
    assert rev > fwd and want == 113808
    assert adjoint_step.nl_window_smem_bytes((4, 8), k, item, ks, n_tr, True, True) == want
    planes = 12 * k
    ps2, cs2 = (2 + 16) * (4 + 24), (2 + 8) * (4 + 12)
    assert adjoint_step.nl_window_scratch_values((2, 4), 2, k, n_tr) == \
        (2 * 7 * ps2 + planes * ps2) + (2 * 7 * cs2 + planes * cs2)
    ps3, cs3 = (2 + 28) * (4 + 44), (2 + 16) * (4 + 24)
    assert adjoint_step.nl_window_scratch_values((2, 4), 3, k, n_tr) == \
        2 * (2 * 7 * ps3 + planes * ps3) + 2 * (2 * 7 * cs3 + planes * cs3)


def test_nl_window_plan_and_refusals(monkeypatch):
    """tiled_adjoint_plan's nonlinear tile: at the default q = 1 the
    nonlinear reverse's (nl_adjoint_plan's), at an explicit q = 2 the q-step
    kernel's (nl_window_plan over the tiles that divide the lattice; 256 x
    256 x 100 f32: (8, 8), and (4, 8) with forcing, two tracers and W),
    which fits one block; a composition no tile fits (60 tracers at 100 f64
    levels) raises ValueError naming the shared memory, as does the
    wrapper for a tile that does not divide the lattice."""
    from mpas_ocean_tpu_torch.kernels import adjoint_step

    halo = (2, 4)
    assert tiled_diff.tiled_adjoint_plan(128, 256, 100, 4, 100, halo=halo,
                                         nonlinear=True)[:3] == (8, 8, 1)
    assert tiled_diff.tiled_adjoint_plan(128, 256, 100, 4, 100, halo=halo, nonlinear=True,
                                         q=2)[:3] == (8, 8, 2)
    arms = dict(n_tracers=2, strat=True, forced=True)
    rt, ct, q, _ = tiled_diff.tiled_adjoint_plan(128, 256, 100, 4, 100, halo=halo,
                                                 nonlinear=True, q=2, **arms)
    assert (rt, ct, q) == (4, 8, 2)
    ks = adjoint_step.nl_window_slice((rt, ct), 100, 4, **arms)
    assert adjoint_step.nl_window_smem_bytes((rt, ct), 100, 4, ks, **arms) <= \
        adjoint_step.SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        adjoint_step.nl_window_plan(128, 256, 100, 8, n_tracers=60)
    with pytest.raises(ValueError, match="shared memory"):
        tiled_diff.tiled_adjoint_plan(128, 256, 100, 8, 100, halo=halo, nonlinear=True, q=2,
                                      n_tracers=60)
    monkeypatch.setattr(adjoint_step, "lattice_dims", lambda h, name="": tuple(h.shape[1:]))
    stack = tuple(torch.zeros((1, *s), dtype=torch.float64) for s in
                  ((2, 8, 8), (2, 8, 8, 4), (3, 2, 8, 8, 4)))
    with pytest.raises(ValueError, match="divide"):
        adjoint_step.nl_window_adjoint_rollout(stack, None, *(None,) * 8, *(1.0,) * 7, 1, 2,
                                               None, tile=(3, 4))


@pytest.mark.parametrize("combo", ["N", "NFTS"])
def test_card_route_runs_the_q_step_nonlinear_reverse(monkeypatch, combo):
    """A CPU rehearsal of the card's nonlinear tiled reverse at q = 2 (the
    kernel library stubbed: torch_port_cases.stub_card): tiled_diff's steps
    at plan (2, 4, 2, 3) on the 8 x 8 x 4 channel run a 12-step sweep, the
    forward rebuild 6 supersteps and the reverse one launch of the q-step
    nonlinear reverse per superstep (6, each in its arms' counters), none
    of the q = 1 nonlinear reverse; every launch takes q = 2, the tile, the
    tracer count, the wind, the tracer planes and W where the arms' pointers
    go, and a scratch of nl_window_scratch_values per tile."""
    from types import SimpleNamespace

    from mpas_ocean_tpu_torch.kernels import adjoint_step
    from mpas_ocean_tpu_torch.structured import diff_model
    from torch_port_cases import stub_card

    lib = stub_card(monkeypatch)
    forced, tracers, strat = (c in combo for c in "FTS")
    _, smp, _, stp, (_, fp), (_, sp) = _case(8, channel=True)
    sm = smp.struct_mesh
    fp = fp if forced else None
    sp = sp if strat else None
    st = stp if tracers else type(stp)(stp.ssh, stp.layer_thickness, stp.normal_velocity)
    like = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float64)
    steps = tiled_diff._TiledSteps(sm, DT, like, (2, 4, 2, 3), True, fp, sp, tracers=tracers,
                                   tracer_kappa=5.0, tracer_upwind=0.7)
    final, ckpts = diff_model._forward(diff_model._planes_state(st), sm, DT, 12, 6, True, fp,
                                       (5.0, 0.7), steps=steps, strat=sp)
    res = diff_model._reverse(steps, ckpts, 6, 3, st, final)
    assert len(res) == 2 + forced + strat and (res[0].tracers is not None) == tracers
    counts = [adjoint_step.nl_window_launches] + [
        getattr(adjoint_step, f"nl_window_{a}_launches") for a in ("forced", "tracer", "strat")]
    assert counts == [6] + [6 * a for a in (forced, tracers, strat)]
    assert adjoint_step.nl_launches == 0
    calls = lib.mot_nl_window_adjoint_f64.calls
    assert len(calls) == 2
    wind = steps.kf.wind.data_ptr() if forced else None
    w = steps.sw.data_ptr() if strat else None
    per_tile = adjoint_step.nl_window_scratch_values((2, 4), 2, 4, 2 if tracers else 0)
    for c in calls:
        assert c[4] == wind and (c[29] is not None) == tracers and c[36] == w
        assert c[60:62] == (2, 4) and c[63] == (2 if tracers else 0) and c[64] == 2
        assert c[40] == (sm.ny2 // 2) * (sm.nx // 4) * per_tile


def test_nonlinear_q2_gradient_on_the_cpu():
    """tiled_rollout_diff with the nonlinear core at plan (2, 4, 2, 1) on a
    CPU state (the plain supersteps; the card's route at q = 2 is the q-step
    nonlinear reverse kernel), 4 steps of the 8 x 8 x 4 lattice with
    forcing, two tracers and W: the gradient with respect to the state, the
    tracers, the wind, the coefficients and W within 1e-12 of the q = 1
    route's (plan (2, 4, 1, 1))."""
    from mpas_ocean_tpu_torch.models import Stratification
    from mpas_ocean_tpu_torch.models.forcing import Forcing
    from mpas_ocean_tpu_torch.structured import StructState, tiled_rollout_diff

    _, smp, _, stp, (_, fp), (_, sp) = _case(8)
    sm = smp.struct_mesh
    g = _random_cotangent(stp, 21)
    grads = []
    for q in (1, 2):
        x = [getattr(stp, f).clone().requires_grad_(True) for f in FIELDS]
        wind = fp.wind_edge.clone().requires_grad_(True)
        w = sp.phi_weights.clone().requires_grad_(True)
        f = Forcing(wind, fp.top_mask, fp.bottom_mask, fp.drag_linear, fp.drag_quadratic,
                    fp.rayleigh)
        out = tiled_rollout_diff(StructState(*x), sm, DT, 4, plan=(2, 4, q, 1), nonlinear=True,
                                 forcing=f, strat=Stratification(w, sp.densities), **TR_KW)
        inner = sum((getattr(out, name) * torch.from_numpy(g[name])).sum() for name in FIELDS)
        grads.append(torch.autograd.grad(inner, (*x, wind, w)))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
