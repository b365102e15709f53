"""The q > 1 arms of the port's tiled kernels on the CPU at f64, against the
JAX package (numpy-seeded inputs, lattices of 8 x 8 and 28 x 28 with
4 levels; each JAX call in interpret mode costs ~15-27 s of tracing):
* the nonlinear forward-backward window steps at q = 2 with forcing, two
  tracers and stratification together (``tiled_run_loop``'s plain version)
  against ``pallas_tiled_run_loop`` in interpret mode;
* the tiled reverse at q = 2 with tracers, and with tracers, W and forcing
  together (``tiled_adjoint_rollout``'s plain supersteps) against
  ``_pallas_tiled_adjoint`` in interpret mode (the stratified reverse
  alone at q = 2: tests/test_torch_strat_adjoint.py);
* the Python mirrors of the q-step kernels' shared memory
  (csrc/nl_tiled.cuh, csrc/tiled_adjoint.cu) against bytes counted by hand,
  the wide level split of the tracer reverse at q > 1, and the refusals of
  plans that do not fit.
The kernels themselves run on a card: tests/test_torch_window_kernel.py,
tests/test_torch_window_adjoint_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from mpas_ocean_tpu.structured.pallas_model import (
    _cot_from_planes,
    _forcing_setup,
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


@pytest.mark.parametrize("arms", ["tracers", "tracers+strat+forcing"])
def test_tiled_reverse_q2_matches_jax_tiled_adjoint(arms):
    """tiled_adjoint_rollout's plain route at q = 2 (the vjp of the slab
    windows, tiles of 2 x 4, groups of 2) against _pallas_tiled_adjoint in
    interpret mode (row tile 2, q = 2, groups of 2), 4 steps with two
    tracers (kappa 5, upwind 0.7) on the 8 x 8 x 4 channel (the windows wrap
    onto themselves), or on the periodic lattice with the tracers, a
    stratification and forcing
    together: the state's cotangent, the tracers' among it, within 1e-12 of
    scale; d(dt), d(W), d(wind) and d(r_lin, Cd, lambda) to 1e-10 of
    theirs."""
    full = arms != "tracers"
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
    cot, dscal, dwind, dsw = _pallas_tiled_adjoint(
        _tiled_scal(sj_m, DT, dtype, fj), stj.ssh[..., None], stj.layer_thickness,
        stj.normal_velocity.reshape(6, ny2, nx, k), sj_m.f_edge.reshape(6, ny2, nx, 1),
        sj_m.resting_thickness_sum[..., None],
        (gj.ssh[..., None], gj.layer_thickness, gj.normal_velocity.reshape(6, ny2, nx, k),
         _tr_planes(gj.tracers, ny2, nx, k)),
        mask, terms=sj_m.coriolis_terms, row_tile=rt, n_steps=n, b=b, interpret=True, q=2,
        fwind=fwind, fidx=fidx, tracers0=_tr_planes(stj.tracers, ny2, nx, k), cmask=cmask,
        strat_w=_strat_w(sj, dtype),
        tropts=(TR_KW["tracer_kappa"], TR_KW["tracer_upwind"]))
    ref = _cot_from_planes(cot, ny2, nx, k)
    res = tiled_adjoint_rollout(stp, smp.struct_mesh, DT, n, struct_state_from_numpy(g),
                                plan=(rt, 4, 2, b), forcing=fp, strat=sp, **TR_KW)
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
