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
from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
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
    shared memory, its q divides n_steps and keeps the clamp. One block
    holds one window copy of its level chunk at q = 1 and two at q > 1, then
    ssh, partial sums, f_edge and rts (16 planes) and the sites' indices
    and live bits (csrc/tiled_step.cu's one-stage reckoning)."""
    ny2, nx, k = shape
    halo = (reach(fb), 2)
    _, kc = tiled_step.level_split(k)
    for n_steps in (1000, 6, 5):
        rt, ct, q = tile_plan(ny2, nx, k, itemsize, halo, n_steps)
        assert ny2 % rt == 0 and nx % ct == 0 and n_steps % q == 0
        assert window_bytes(rt, ct, q, halo, k, itemsize) <= tiled_step.SMEM_BYTES
        assert rt + 2 * halo[0] * q <= ny2 and ct + 2 * halo[1] * q <= nx
        assert resolve_plan(ny2, nx, k, itemsize, halo, n_steps) == (rt, ct, q)
        for qq in (1, 2, 4):
            sites = (rt + 2 * halo[0] * qq) * (ct + 2 * halo[1] * qq)
            copies = 1 if qq == 1 else 2
            assert window_bytes(rt, ct, qq, halo, k, itemsize) == (
                itemsize * sites * (8 * copies * kc + 16) + 8 * sites)


@pytest.mark.parametrize("shape", [(128, 256, 100), (32, 64, 100), (32, 64, 4),
                                   (4, 8, 300), (5, 12, 33)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_fe_tile_fits(shape, itemsize):
    """fe_step's tile lies within the lattice and its window fits one
    block's shared memory: the level chunk of 8 state planes, ssh, f_edge
    and rts (10 planes), the ranks' partial sums of the tile's sites and
    the sites' indices and live bits (csrc/fe_step.cu's reckoning). Where
    any tile lets two blocks share an SM, the chosen one does."""
    ny2, nx, k = shape
    rt, ct = fe_step.fe_tile(ny2, nx, k, itemsize)
    assert 1 <= rt <= ny2 and 1 <= ct <= nx
    ranks, kc = fe_step.level_split(k)
    hm, hi = fe_step.FE_REACH
    sites = (rt + 2 * hm) * (ct + 2 * hi)
    need = itemsize * (sites * (8 * kc + 10) + ranks * 2 * rt * ct) + 8 * sites
    assert fe_step.smem_bytes((rt, ct), k, itemsize) == need <= fe_step.SMEM_BYTES
    if fe_step.smem_bytes((1, 1), k, itemsize) <= fe_step.TWO_BLOCK_BYTES:
        assert need <= fe_step.TWO_BLOCK_BYTES
    if (ny2, nx, k, itemsize) in ((128, 256, 100, 4), (32, 64, 100, 4)):
        assert (rt, ct) == (4, 16)  # the fastest tile at both sizes (PERF.md section 5)


def test_level_split_leaves_no_block_empty():
    """The forward kernels' level chunks: a power of two of levels per
    block (so the kernels index by shifts), no block without levels, and
    whole 16-byte vectors from 4 f32 or 2 f64 levels up."""
    for k in range(1, 300):
        ranks, kc = tiled_step.level_split(k)
        assert 1 <= ranks <= tiled_step.MAX_CLUSTER
        assert (ranks - 1) * kc < k <= ranks * kc
        assert kc & (kc - 1) == 0
        assert kc < 4 or (kc * 4) % 16 == 0


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
            mesh.f_edge, mesh.resting_thickness_sum, *mesh.host_stencil,
            DT, 1e-3, 1e-3, 2, row_tile=4, col_tile=4, q=1,
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


def _chunk_sums(v, kc, lanes):
    """A block's partial column sums as the window kernels take them
    (csrc/step_window.cuh): v (..., kr) the block's levels; lane l of a
    site's group adds levels l, l + lanes, ... in order from 0, then the
    lanes are added by a xor shuffle tree; lane 0's value."""
    acc = np.zeros(v.shape[:-1] + (lanes,))
    for j0 in range(0, kc, lanes):
        seg = v[..., j0:j0 + lanes]
        acc[..., :seg.shape[-1]] = acc[..., :seg.shape[-1]] + seg
    off = lanes // 2
    while off:
        acc = acc + acc[..., np.arange(lanes) ^ off]
        off //= 2
    return acc[..., 0]


def _column_sums(hn, k, split, lanes):
    """sum_k of hn (..., K) as a cluster takes it: each block's chunk sum,
    then the blocks' partials in rank order. ``lanes`` None: the kernels'
    min(16, kc)."""
    ranks, kc = split
    lanes = lanes or min(16, kc)
    col = None
    for rank in range(ranks):
        part = _chunk_sums(hn[..., rank * kc:min(k, (rank + 1) * kc)], kc, lanes)
        col = part if col is None else col + part
    return col


def _stencil_offsets(table, wi):
    """The packed table as flattened window-site offsets (dm * wi + di), as
    csrc/step_window.cuh's resolve_taps makes them."""
    n = table[0]
    nbr, inc, off = table[1:19].reshape(6, 3), table[19:37].reshape(6, 3), table[37:44]
    taps = table[44:44 + 3 * n].reshape(n, 3)
    nbr_d = nbr[:, 1] * wi + nbr[:, 2]
    inc_d = inc[:, 1] * wi + inc[:, 2]
    return nbr, inc, off, taps, nbr_d, inc_d, inc_d + nbr_d[inc[:, 0]], taps[:, 1] * wi + taps[:, 2]


def _continuity(cur, s, p, st, dt, s_div):
    """h' of plane p at window sites s from the window state cur (8, W, K)."""
    nbr, inc, _, _, nbr_d, inc_d, inc_nd, _ = st
    total = None
    for fam in range(3):
        c = fam * 2 + p
        he = 0.5 * (cur[nbr[c, 0], s + nbr_d[c]] + cur[p, s])
        fl = cur[2 + c, s] * he
        total = fl if total is None else total + fl
    for x in range(3 * p, 3 * p + 3):
        se = s + inc_d[x]
        he = 0.5 * (cur[nbr[inc[x, 0], 0], s + inc_nd[x]] + cur[inc[x, 0] & 1, se])
        total = total - cur[2 + inc[x, 0], se] * he
    return cur[p, s] - (dt * s_div) * total


def _momentum(cur, s, c, pg, f_w, w, st, dt, inv_dc):
    """u' of channel c at window sites s: the Coriolis taps in order and the
    pressure gradient of pg (2, W)."""
    nbr, _, off, taps, nbr_d, _, _, tap_d = st
    acc = None
    for t in range(off[c], off[c + 1]):
        src = s + tap_d[t]
        contrib = w[t] * (cur[2 + taps[t, 0], src] * f_w[taps[t, 0], src][:, None])
        acc = contrib if acc is None else acc + contrib
    grad = (pg[nbr[c, 0], s + nbr_d[c]] - pg[c & 1, s]) * inv_dc
    return cur[2 + c, s] + dt * acc + (-GRAVITY * dt) * grad[:, None]


def _masked(u_new, live_w, s):
    """u' of the window sites s with the masked arms' live bits applied
    (live_w, one int per window site: u' = 0 where channel c's bit is
    clear); u' itself without them."""
    if live_w is None:
        return u_new
    bits = (live_w[s][None, :] >> np.arange(6)[:, None]) & 1
    return np.where(bits[..., None] == 1, u_new, 0.0)


def _walk_tiled_launch(ssh, h, u, f, rts, table, w, dt, inv_dc, s_div, rt, ct, q,
                       halo, fb, split=None, lanes=None, live=None):
    """One launch as csrc/tiled_step.cu computes it, on numpy planes: per
    tile, the wrapped window with flattened site offsets (dm * Wi + di), the
    shrinking continuity and momentum regions, the level chunks of a cluster
    (``split`` = (ranks, kc), the kernel's by default) with each block's
    lane-group partial sums added in rank order, the second window copy of
    the steps before the last, and the last step's core written straight
    to the output. ssh (2, ny2, nx), h (2, ny2, nx, K), u (6, ny2, nx, K),
    f (6, ny2, nx), rts (2, ny2, nx); ``live`` (ny2, nx), the masked arm's
    live bits, or None."""
    _, ny2, nx, k = h.shape
    hm, hi = halo
    split = split or tiled_step.level_split(k)
    wm, wi = rt + 2 * hm * q, ct + 2 * hi * q
    st = _stencil_offsets(table, wi)

    def region(r0, c0):
        r, c = np.meshgrid(np.arange(r0, wm - r0), np.arange(c0, wi - c0), indexing="ij")
        return (r * wi + c).ravel()

    out = [np.full_like(x, np.nan) for x in (ssh, h, u)]
    core = region(hm * q, hi * q)
    for tm in range(ny2 // rt):
        for ti in range(nx // ct):
            gm = (tm * rt - hm * q + np.arange(wm)) % ny2
            gi = (ti * ct - hi * q + np.arange(wi)) % nx
            win = lambda x: x[:, gm[:, None], gi[None, :]].reshape(x.shape[0], wm * wi,
                                                                   *x.shape[3:])
            rows, cols = tm * rt + np.arange(rt), ti * ct + np.arange(ct)
            put = lambda dst, x: dst.__setitem__(
                (slice(None), rows[:, None], cols[None, :]),
                x.reshape(x.shape[0], rt, ct, *x.shape[2:]))
            cur, s_cur = np.concatenate([win(h), win(u)]), win(ssh)
            f_w, rts_w = win(f), win(rts)
            live_w = None if live is None else win(live[None])[0]
            for j in range(q):
                last = j == q - 1
                # NaN outside what a step writes: a read there fails the test
                nxt, s_nxt = np.full_like(cur, np.nan), np.full_like(s_cur, np.nan)
                s = region(hm * j + 1, hi * j + 1) if fb else region(hm * (j + 1),
                                                                     hi * (j + 1))
                h_new = np.stack([_continuity(cur, s, p, st, dt, s_div) for p in (0, 1)])
                s_nxt[:, s] = _column_sums(h_new, k, split, lanes) - rts_w[:, s]
                pg = s_nxt if fb else s_cur
                su = region(hm * (j + 1), hi * (j + 1))
                u_new = _masked(np.stack([_momentum(cur, su, c, pg, f_w, w, st, dt, inv_dc)
                                          for c in range(6)]), live_w, su)
                if last:  # the core, straight to the output
                    put(out[1], h_new[:, np.searchsorted(s, core)])
                    put(out[2], u_new)
                else:
                    nxt[:2, s], nxt[2:, su] = h_new, u_new
                cur, s_cur = nxt, s_nxt
            put(out[0], s_cur[:, core])
    return out


@pytest.mark.parametrize("fb, plan, split", [
    (False, (1, 4, 1), None), (False, (4, 2, 2), None), (False, (2, 8, 4), None),
    (True, (1, 8, 1), None), (True, (4, 4, 2), None),
    (False, (2, 4, 1), (3, 2)), (True, (4, 4, 1), (2, 4)), (True, (2, 8, 2), (3, 2)),
])
def test_kernel_window_walk_matches_plain(fb, plan, split):
    """The tiled kernel's index arithmetic, walked in numpy (the CUDA
    arithmetic itself is checked on the card, tests/test_torch_tiled_kernel.py
    and chip_smoke.py phase 7): 8 steps on 24x24x5 (ny2 = 12), <= 1e-12 of
    each field's magnitude against the plain version. The kernel's split
    puts 5 levels in 5 one-level chunks; the cases with ``split`` run the
    same scheme with 2-lane groups over chunks of 2 or 4 levels, so that the
    lanes' level loops and shuffle are walked too."""
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
            mesh.coriolis_weight.numpy(), dt_, inv_dc, s_div, rt, ct, q, halo, fb,
            split=split, lanes=None if split is None else 2)
    ref = structured_run_loop(state, mesh, DT, n, fb=fb)
    for got, f in zip(fields, STATE_FIELDS):
        want = getattr(ref, f).numpy()
        assert max_rel_err(got.reshape(want.shape), want) <= 1e-12, f


def _fe_reach(table):
    """csrc/fe_step.cu's fe_reach: rows and columns one FE step reads."""
    nbr, inc, _, taps, *_ = _stencil_offsets(table, 0)
    d = [tuple(x[1:]) for x in nbr] + [tuple(x[1:]) for x in taps]
    d += [(x[1], x[2]) for x in inc] + [(x[1] + nbr[x[0], 1], x[2] + nbr[x[0], 2])
                                         for x in inc]
    return max(abs(a) for a, _ in d), max(abs(b) for _, b in d)


def _walk_fe_launch(ssh, h, u, f, rts, table, w, dt, inv_dc, s_div, rt, ct,
                    split=None, lanes=None, live=None):
    """One launch as csrc/fe_step.cu computes it, on numpy planes: tiles of
    rt x ct sites that need not divide the lattice (sites past its edge are
    skipped), each tile's window wrapped periodically (over itself where it
    is wider than the lattice), h' and u' of a core site in one pass from
    the old state, and ssh' from the blocks' lane-group partial sums added in
    rank order; ``live`` (ny2, nx), the masked arm's live bits, or None.
    Returns the new fields and how often each site was written."""
    _, ny2, nx, k = h.shape
    hm, hi = _fe_reach(table)
    split = split or fe_step.level_split(k)
    wm, wi = rt + 2 * hm, ct + 2 * hi
    st = _stencil_offsets(table, wi)
    out = [np.full_like(x, np.nan) for x in (ssh, h, u)]
    written = np.zeros((ny2, nx), int)
    r, c = np.meshgrid(np.arange(rt), np.arange(ct), indexing="ij")
    s_core = ((hm + r) * wi + hi + c).ravel()
    for tm in range(-(-ny2 // rt)):
        for ti in range(-(-nx // ct)):
            gm = (tm * rt - hm + np.arange(wm)) % ny2
            gi = (ti * ct - hi + np.arange(wi)) % nx
            win = lambda x: x[:, gm[:, None], gi[None, :]].reshape(x.shape[0], wm * wi,
                                                                   *x.shape[3:])
            cur, s_cur, f_w, rts_w = np.concatenate([win(h), win(u)]), win(ssh), win(f), win(rts)
            live_w = None if live is None else win(live[None])[0]
            lm, li = (tm * rt + r).ravel(), (ti * ct + c).ravel()
            keep = (lm < ny2) & (li < nx)
            s, lm, li = s_core[keep], lm[keep], li[keep]
            h_new = np.stack([_continuity(cur, s, p, st, dt, s_div) for p in (0, 1)])
            u_new = _masked(np.stack([_momentum(cur, s, ch, s_cur, f_w, w, st, dt, inv_dc)
                                      for ch in range(6)]), live_w, s)
            out[0][:, lm, li] = _column_sums(h_new, k, split, lanes) - rts_w[:, s]
            out[1][:, lm, li], out[2][:, lm, li] = h_new, u_new
            written[lm, li] += 1
    return out, written


@pytest.mark.parametrize("shape, tile, split", [
    ((16, 16, 3), (8, 16), None),   # the tile is the whole lattice; the window wraps
    ((16, 16, 5), (3, 5), None),    # ragged tiles in both directions
    ((12, 20, 5), (4, 8), (3, 2)),  # ragged columns, three chunks of 2 levels
    ((32, 32, 4), (8, 16), (2, 2)),
    ((8, 8, 5), (4, 8), (2, 4)),    # one tile; its 6 x 12 window wraps over the 4 x 8 lattice
])
def test_fe_step_tile_walk_matches_plain(shape, tile, split):
    """fe_step's tile scheme, walked in numpy (the CUDA arithmetic itself is
    checked on the card, tests/test_torch_kernel.py and chip_smoke.py): 6
    FE steps, every site written exactly once per step, <= 1e-12 of each
    field's magnitude against the plain version. ``split`` (ranks, kc) runs
    the same scheme with 2-lane groups over chunks of 2 or 4 levels, so the
    rank-order sum and the lanes' level loops are walked at a few levels."""
    nx_c, ny_c, k = shape
    sm, st = jax_lattice(nx_c, ny_c, k, seed=4)
    state, mesh = _port_inputs(sm, st)
    ny2, nx = mesh.ny2, mesh.nx
    assert _fe_reach(mesh.stencil_table.numpy()) == fe_step.FE_REACH
    dt_, inv_dc, s_div = _scal(mesh, DT, torch.float64)
    fields = (state.ssh.numpy(), state.layer_thickness.numpy(),
              state.normal_velocity.numpy().reshape(6, ny2, nx, k))
    rt, ct = min(tile[0], ny2), min(tile[1], nx)
    for _ in range(6):
        fields, written = _walk_fe_launch(
            *fields, mesh.f_edge.numpy().reshape(6, ny2, nx),
            mesh.resting_thickness_sum.numpy(), mesh.stencil_table.numpy(),
            mesh.coriolis_weight.numpy(), dt_, inv_dc, s_div, rt, ct,
            split=split, lanes=None if split is None else 2)
        assert (written == 1).all()
    ref = structured_run_loop(state, mesh, DT, 6)
    for got, f in zip(fields, STATE_FIELDS):
        want = getattr(ref, f).numpy()
        assert max_rel_err(got.reshape(want.shape), want) <= 1e-12, f


# csrc/step_window.cuh's hex:: maps: the number of the u source each
# incoming edge and each Coriolis tap reads, and of the h source each
# owned edge's neighbour and each incoming edge's two cells read
_HEX_INC_U = (6, 7, 8, 9, 2, 10)
_HEX_TAP_U = (2, 4, 7, 8, 11, 12, 13, 10, 3, 5, 2, 10, 13, 14, 15, 16,
              4, 6, 8, 0, 10, 1, 5, 9, 5, 9, 10, 1, 16, 17, 18, 19,
              6, 7, 0, 2, 9, 20, 21, 22, 9, 2, 1, 3, 19, 23, 24, 20)
_HEX_NB_H = (2, 3, 1, 4, 5, 6)
_HEX_INC_H = ((7, 0), (8, 0), (9, 0), (5, 1), (0, 1), (2, 1))  # (own cell, neighbour)


def _maps_as_hex(table) -> bool:
    """Whether a packed table is one the forward kernels take
    (csrc/step_window.cuh's resolve_taps): 8 taps per channel, and its u
    and h reads, each a (plane, dm, di) numbered in order of first use
    (own channels, incoming edges, taps; own cells, neighbours, incoming
    edges' cells), are the 25 and 10 sources that hex:: lists."""
    nbr, inc, off, taps, *_ = _stencil_offsets(table, 0)
    u_src, h_src = [], []

    def number(src, read):
        if read not in src:
            src.append(read)
        return src.index(read)

    u = [number(u_src, (c, 0, 0)) for c in range(6)]
    u += [number(u_src, tuple(x)) for x in list(inc) + list(taps)]
    h = [number(h_src, (p, 0, 0)) for p in (0, 1)] + [number(h_src, tuple(x)) for x in nbr]
    for c, dm, di in inc:
        e = nbr[c]
        h += [number(h_src, (c & 1, dm, di)), number(h_src, (e[0], dm + e[1], di + e[2]))]
    want_u = list(range(6)) + list(_HEX_INC_U) + list(_HEX_TAP_U)
    want_h = [0, 1] + list(_HEX_NB_H) + [x for pair in _HEX_INC_H for x in pair]
    return (table[0] == 48 and list(off) == [8 * c for c in range(7)]
            and (u, len(u_src), h, len(h_src)) == (want_u, 25, want_h, 10))


@pytest.mark.parametrize("nx, ny", [(6, 6), (10, 12), (16, 16), (64, 64)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_every_lattice_table_maps_as_the_forward_kernels_take_it(nx, ny, dtype):
    """The forward kernels take the hex lattice's stencil table only (their
    entries raise ValueError for any other): every uniform periodic lattice
    StructuredModel builds, in f32 and f64, has that table, carried to the
    host for the kernels; the same stencil with each channel's terms in
    reverse order does not map so."""
    horz = mt.planar_hex_mesh(nx, ny, 1000.0, f0=1e-4, beta=1e-11, dtype=dtype)
    vert = mt.make_vertical_mesh(horz, 2, dtype=dtype,
                                 resting_thickness=np.full((horz.n_cells, 2), 10.0, dtype=dtype))
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), nx, ny, device="cpu")
    sm = model.struct_mesh
    table, weights = sm.host_stencil
    np.testing.assert_array_equal(table, sm.stencil_table.numpy())
    np.testing.assert_array_equal(weights, sm.coriolis_weight.numpy().astype(np.float64))
    assert weights.dtype == np.float64 and _maps_as_hex(table)
    d = mt.structured.struct_mesh_to_numpy(sm)
    d["coriolis_terms"] = tuple(reversed(sm.coriolis_terms))
    assert not _maps_as_hex(mt.structured.struct_mesh_from_numpy(d).host_stencil[0])
