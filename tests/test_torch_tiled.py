"""The port's tiled rollout and forward-backward stepper against the JAX
package's, on the CPU at f64 (numpy-seeded inputs):

* plain ``structured_run_loop(fb=True)`` against the JAX roll model;
* ``slab.window_steps`` against ``pallas_model._window_steps`` on one random
  full-width window (padded periodically in i on the port's side);
* ``tiled_run_loop`` on a CPU state (the tiled kernel's plain version) for
  several plans against the JAX roll model, and against
  ``pallas_tiled_run_loop`` in interpret mode;
* the stencil reach, the planner and its errors;
* ``structured_auto_run_loop(fb=True)`` end to end from ``StructuredModel``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu_torch.constants import GRAVITY
from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.pallas_model import (
    _reach as jax_reach,
    _window_steps as jax_window_steps,
    pallas_tiled_run_loop,
    structured_auto_run_loop as jax_auto_run_loop,
)
from mpas_ocean_tpu_torch.kernels import tiled_step
from mpas_ocean_tpu_torch.structured import (
    struct_mesh_from_numpy,
    struct_state_from_numpy,
    structured_run_loop,
    tile_plan,
    tiled_run_loop,
    window_steps,
)
from mpas_ocean_tpu_torch.structured.fused_model import _scal
from mpas_ocean_tpu_torch.structured.slab import reach, stencil_reach
from mpas_ocean_tpu_torch.structured.tiled_model import resolve_plan, window_bytes

from torch_port_cases import (
    STATE_FIELDS,
    both_meshes,
    jax_lattice,
    jax_prog,
    jax_struct_mesh_dict,
    jax_struct_state_dict,
    max_rel_err,
    port_prog,
    random_state,
)

DT = 10.0


def _port_inputs(sm, st):
    return (struct_state_from_numpy(jax_struct_state_dict(st)),
            struct_mesh_from_numpy(jax_struct_mesh_dict(sm.struct_mesh)))


@pytest.fixture(scope="module")
def lattice32():
    """32x32x3 (ny2 = 16): large enough that FB at q = 2 keeps its q with
    an 8-row tile (8 + 2 * 2 * 2 <= 16)."""
    sm, st = jax_lattice(32, 32, 3, seed=5)
    return sm, st, *_port_inputs(sm, st)


def test_fb_run_loop_matches_jax():
    """16x16x4, 20 FB steps: <= 1e-12 of each field's magnitude (the two
    sum each column in another order)."""
    sm, st = jax_lattice(16, 16, 4, seed=3)
    state, mesh = _port_inputs(sm, st)
    ref = jax_run_loop(st, sm.struct_mesh, DT, 20, fb=True)
    out = structured_run_loop(state, mesh, DT, 20, fb=True)
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(out, f).numpy(), getattr(ref, f)) <= 1e-12, f


def test_stencil_reach_of_the_tables():
    """The halo a step consumes per side: rows as JAX's _reach (1 FE, 2
    FB); columns 2, from the Coriolis stencil's |di| <= 2 (the neighbour
    and incoming-edge tables reach 1 column)."""
    sm, _ = jax_lattice(16, 16, 2, seed=1)
    terms = sm.struct_mesh.coriolis_terms
    assert max(abs(t[4]) for t in terms) == 1
    assert max(abs(t[5]) for t in terms) == 2
    for fb in (False, True):
        assert stencil_reach(terms, fb) == (reach(fb), 2)
        assert reach(fb) == jax_reach(False, fb)


def _pad_i(x, p):
    """Periodic padding of p columns on both sides of (ch, R, nx, K)."""
    return np.concatenate([x[:, :, -p:], x, x[:, :, :p]], axis=2)


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("q", [1, 2])
def test_window_steps_match_jax(fb, q):
    """One random full-width window, 3 interior rows, 8 columns, 3 levels:
    <= 1e-13 of each field's magnitude."""
    sm, _ = jax_lattice(8, 8, 3, seed=2)
    terms = sm.struct_mesh.coriolis_terms
    rows, nx, k = 3, 8, 3
    hm, hi = stencil_reach(terms, fb)
    full = rows + 2 * hm * q
    rng = np.random.default_rng(11 + q + 2 * fb)
    h = 10.0 + 0.01 * rng.normal(size=(2, full, nx, k))
    u = 0.01 * rng.normal(size=(6, full, nx, k))
    rts = np.full((2, full, nx, 1), 10.0 * k)
    ssh = h.sum(-1, keepdims=True) - rts
    f = 1e-4 + 1e-6 * rng.normal(size=(6, full, nx, 1))
    dt, inv_dc, s_div = DT, 1e-3, 2.0 / (np.sqrt(3.0) * 1e3)
    scal = jnp.asarray([[dt, inv_dc, s_div, 0, 0, 0, 0, 0]], jnp.float64)
    planes = lambda x: tuple(jnp.asarray(p) for p in x)
    ref = jax_window_steps(
        planes(ssh), planes(h), planes(u), None, scal, f_full=planes(f),
        rts_full=planes(rts), terms=terms, fb=fb, rows=rows, q=q, reach=hm, full=full,
    )[:3]
    t = lambda x: torch.from_numpy(_pad_i(x, hi * q))
    out = window_steps(t(ssh), t(h), t(u), t(f), t(rts), dt, inv_dc, s_div, terms,
                       rows=rows, cols=nx, q=q, halo=(hm, hi), fb=fb)
    for got, want, name in zip(out, ref, STATE_FIELDS):
        want = np.stack([np.asarray(p) for p in want])
        assert got.shape == want.shape, name
        assert max_rel_err(got.numpy(), want) <= 1e-13, name


@pytest.mark.parametrize("fb, plan", [
    (False, (1, 16, 4)), (False, (4, 8, 2)), (False, (16, 4, 1)),
    (True, (8, 8, 2)), (True, (2, 16, 1)),
])
def test_plain_tiled_rollout_matches_jax(lattice32, fb, plan):
    """tiled_run_loop on a CPU state, 8 steps on 32x32x3: <= 1e-12 of each
    field's magnitude against the JAX roll model, with the plan's q kept."""
    sm, st, state, mesh = lattice32
    rt, ct, q = plan
    n = 8
    assert resolve_plan(16, 32, 3, 8, stencil_reach(mesh.coriolis_terms, fb), n,
                        rt, ct, q) == plan
    ref = jax_run_loop(st, sm.struct_mesh, DT, n, fb=fb)
    out = tiled_run_loop(state, mesh, DT, n, row_tile=rt, col_tile=ct, q=q, fb=fb)
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(out, f).numpy(), getattr(ref, f)) <= 1e-12, f


@pytest.mark.parametrize("fb", [False, True])
def test_plain_tiled_rollout_matches_pallas_interpret(fb):
    """8x8x4, 4 steps, against the JAX tiled kernel in interpret mode at
    tests/test_pallas.py's tolerances (row tile 2, q = 1; full-width
    columns on the JAX side, 4-column tiles on the port's)."""
    sm, st = jax_lattice(8, 8, 4, seed=7)
    state, mesh = _port_inputs(sm, st)
    ref = pallas_tiled_run_loop(st, sm.struct_mesh, DT, 4, row_tile=2, q=1, fb=fb,
                                interpret=True)
    out = tiled_run_loop(state, mesh, DT, 4, row_tile=2, col_tile=4, q=1, fb=fb)
    for f, atol in (("ssh", 1e-11), ("layer_thickness", 1e-11),
                    ("normal_velocity", 1e-13)):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=atol)


def test_q_is_clamped_to_the_lattice():
    """The reach*q clamp (pallas_model.py:1381-1384) on rows, and the same
    on columns; q stays a divisor of n_steps."""
    fe, fb = (1, 2), (2, 2)
    assert resolve_plan(16, 32, 3, 8, fb, 8, 8, 8, 2) == (8, 8, 2)
    assert resolve_plan(16, 32, 3, 8, fb, 8, 16, 8, 4) == (16, 8, 1)
    assert resolve_plan(8, 8, 3, 8, fe, 8, 2, 4, 4) == (2, 4, 1)
    assert resolve_plan(16, 16, 3, 8, fe, 6, 4, 4, 4) == (4, 4, 3)
    assert resolve_plan(16, 32, 3, 8, fe, 9, 4, 8, 4) == (4, 8, 3)


@pytest.mark.parametrize("shape", [(128, 256, 100), (32, 64, 100), (32, 64, 4),
                                   (16, 32, 3)])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("fb", [False, True])
def test_tile_plan_fits(shape, itemsize, fb):
    """The planner's tiles divide the lattice, its window fits one block's
    shared memory, its q divides n_steps and keeps the clamp."""
    ny2, nx, k = shape
    halo = (reach(fb), 2)
    for n_steps in (1000, 6, 5):
        rt, ct, q = tile_plan(ny2, nx, k, itemsize, halo, n_steps)
        assert ny2 % rt == 0 and nx % ct == 0 and n_steps % q == 0
        assert window_bytes(rt, ct, q, halo, k, itemsize) <= tiled_step.SMEM_BYTES
        assert rt + 2 * halo[0] * q <= ny2 and ct + 2 * halo[1] * q <= nx
        assert resolve_plan(ny2, nx, k, itemsize, halo, n_steps) == (rt, ct, q)


def test_level_split_leaves_no_block_empty():
    for k in range(1, 300):
        ranks, kc = tiled_step.level_split(k)
        assert 1 <= ranks <= tiled_step.MAX_CLUSTER
        assert (ranks - 1) * kc < k <= ranks * kc


def test_tile_that_does_not_divide_raises(lattice32):
    _, _, state, mesh = lattice32
    with pytest.raises(ValueError, match="row_tile"):
        tiled_run_loop(state, mesh, DT, 2, row_tile=3, col_tile=4, q=1)
    with pytest.raises(ValueError, match="col_tile"):
        tiled_run_loop(state, mesh, DT, 2, row_tile=4, col_tile=5, q=1)


def test_kernel_wrapper_refuses_cpu_tensors(lattice32):
    _, _, state, mesh = lattice32
    with pytest.raises(ValueError, match="CUDA"):
        tiled_step.tiled_rollout(
            state.ssh, state.layer_thickness, state.normal_velocity,
            mesh.f_edge, mesh.resting_thickness_sum, mesh.stencil_table,
            mesh.coriolis_weight, DT, 1e-3, 1e-3, 2, row_tile=4, col_tile=4, q=1,
            halo=(1, 2),
        )


def test_auto_run_loop_fb_matches_jax_entry():
    """StructuredModel -> to_struct -> structured_auto_run_loop(fb=True) ->
    from_struct on a random 16x16x3 state, 12 steps, against the JAX entry
    (which runs the roll model off the TPU): <= 1e-12 relative."""
    nx, ny, k, n = 16, 16, 3, 12
    mj, mp = both_meshes(nx, ny, k)
    init = random_state(mj, 8)
    from mpas_ocean_tpu.structured.model import StructuredModel as JaxStructuredModel

    sm_j = JaxStructuredModel(mj, nx, ny)
    ref = sm_j.from_struct(jax_auto_run_loop(
        sm_j.to_struct(jax_prog(*init)), sm_j.struct_mesh, DT, n, fb=True))
    model = mt.StructuredModel(mp, nx, ny, device="cpu")
    out = model.from_struct(mt.structured_auto_run_loop(
        model.to_struct(port_prog(*init)), model.struct_mesh, DT, n, fb=True))
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(out, f).numpy(), getattr(ref, f)) <= 1e-12, f


def _walk_tiled_launch(ssh, h, u, f, rts, table, w, dt, inv_dc, s_div, rt, ct, q,
                       halo, fb):
    """One launch as csrc/tiled_step.cu computes it, on numpy planes: per
    tile, the wrapped window with flattened site offsets (dm * Wi + di), the
    shrinking continuity and momentum regions, the level chunks of a cluster
    and their partial column sums added in rank order, the ping-pong
    buffers, and the core written back. ssh (2, ny2, nx), h (2, ny2, nx, K),
    u (6, ny2, nx, K), f (6, ny2, nx), rts (2, ny2, nx)."""
    _, ny2, nx, k = h.shape
    hm, hi = halo
    ranks, kc = tiled_step.level_split(k)
    n = table[0]
    nbr, inc, off = table[1:19].reshape(6, 3), table[19:37].reshape(6, 3), table[37:44]
    taps = table[44:44 + 3 * n].reshape(n, 3)
    wm, wi = rt + 2 * hm * q, ct + 2 * hi * q
    nbr_d = nbr[:, 1] * wi + nbr[:, 2]
    inc_d = inc[:, 1] * wi + inc[:, 2]
    inc_nd = inc_d + nbr_d[inc[:, 0]]
    tap_d = taps[:, 1] * wi + taps[:, 2]
    pg_scale = -GRAVITY * dt

    def region(r0, c0):
        r, c = np.meshgrid(np.arange(r0, wm - r0), np.arange(c0, wi - c0), indexing="ij")
        return (r * wi + c).ravel()

    out = [np.empty_like(x) for x in (ssh, h, u)]
    for tm in range(ny2 // rt):
        for ti in range(nx // ct):
            gm = (tm * rt - hm * q + np.arange(wm)) % ny2
            gi = (ti * ct - hi * q + np.arange(wi)) % nx
            win = lambda x: x[:, gm[:, None], gi[None, :]].reshape(x.shape[0], wm * wi,
                                                                   *x.shape[3:])
            cur, s_cur = np.concatenate([win(h), win(u)]), win(ssh)
            f_w, rts_w = win(f), win(rts)
            for j in range(q):
                # NaN outside what a step writes: a read there fails the test
                nxt, s_nxt = np.full_like(cur, np.nan), np.full_like(s_cur, np.nan)
                s = region(hm * j + 1, hi * j + 1) if fb else region(hm * (j + 1),
                                                                     hi * (j + 1))
                for p in (0, 1):
                    total = None
                    for fam in range(3):
                        c = fam * 2 + p
                        he = 0.5 * (cur[nbr[c, 0], s + nbr_d[c]] + cur[p, s])
                        fl = cur[2 + c, s] * he
                        total = fl if total is None else total + fl
                    for x in range(3 * p, 3 * p + 3):
                        se = s + inc_d[x]
                        he = 0.5 * (cur[nbr[inc[x, 0], 0], s + inc_nd[x]]
                                    + cur[inc[x, 0] & 1, se])
                        total = total - cur[2 + inc[x, 0], se] * he
                    nxt[p, s] = cur[p, s] - (dt * s_div) * total
                    col = None
                    for rank in range(ranks):
                        lv = nxt[p, s, rank * kc:min(k, (rank + 1) * kc)]
                        part = lv[:, 0].copy()
                        for kl in range(1, lv.shape[1]):
                            part = part + lv[:, kl]
                        col = part if col is None else col + part
                    s_nxt[p, s] = col - rts_w[p, s]
                pg = s_nxt if fb else s_cur
                s = region(hm * (j + 1), hi * (j + 1))
                for c in range(6):
                    acc = None
                    for t in range(off[c], off[c + 1]):
                        src = s + tap_d[t]
                        contrib = w[t] * (cur[2 + taps[t, 0], src]
                                          * f_w[taps[t, 0], src][:, None])
                        acc = contrib if acc is None else acc + contrib
                    grad = (pg[nbr[c, 0], s + nbr_d[c]] - pg[c & 1, s]) * inv_dc
                    nxt[2 + c, s] = cur[2 + c, s] + dt * acc + pg_scale * grad[:, None]
                cur, s_cur = nxt, s_nxt
            core = region(hm * q, hi * q)
            rows, cols = tm * rt + np.arange(rt), ti * ct + np.arange(ct)
            put = lambda dst, x: dst.__setitem__(
                (slice(None), rows[:, None], cols[None, :]),
                x[:, core].reshape(x.shape[0], rt, ct, *x.shape[2:]))
            put(out[0], s_cur)
            put(out[1], cur[:2])
            put(out[2], cur[2:])
    return out


@pytest.mark.parametrize("fb, plan", [
    (False, (1, 4, 1)), (False, (4, 2, 2)), (False, (2, 8, 4)),
    (True, (1, 8, 1)), (True, (4, 4, 2)),
])
def test_kernel_window_walk_matches_plain(fb, plan):
    """The tiled kernel's index arithmetic, walked in numpy (the CUDA
    arithmetic itself is checked on the card, tests/test_torch_tiled_kernel.py
    and chip_smoke.py phase 7): 8 steps on 24x24x5 (ny2 = 12, three level
    chunks of 2, 2 and 1), <= 1e-12 of each field's magnitude against the
    plain version."""
    sm, st = jax_lattice(24, 24, 5, seed=6)
    state, mesh = _port_inputs(sm, st)
    rt, ct, q = plan
    n = 8
    ny2, nx, k = mesh.ny2, mesh.nx, 5
    dt_, inv_dc, s_div = _scal(mesh, DT, torch.float64)
    fields = (state.ssh.numpy(), state.layer_thickness.numpy(),
              state.normal_velocity.numpy().reshape(6, ny2, nx, k))
    halo = stencil_reach(mesh.coriolis_terms, fb)
    for _ in range(n // q):
        fields = _walk_tiled_launch(
            *fields, mesh.f_edge.numpy().reshape(6, ny2, nx),
            mesh.resting_thickness_sum.numpy(), mesh.stencil_table.numpy(),
            mesh.coriolis_weight.numpy(), dt_, inv_dc, s_div, rt, ct, q, halo, fb)
    ref = structured_run_loop(state, mesh, DT, n, fb=fb)
    for got, f in zip(fields, STATE_FIELDS):
        want = getattr(ref, f).numpy()
        assert max_rel_err(got.reshape(want.shape), want) <= 1e-12, f
