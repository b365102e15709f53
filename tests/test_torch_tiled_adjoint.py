"""The port's tiled reverse against the JAX package's, on the CPU, f64
(numpy-seeded inputs):

* ``tiled_adjoint_rollout``'s plain route (``plain_tiled_adjoint_superstep``
  per superstep) against the JAX tiled Pallas adjoint in interpret mode, and
  against ``jax.vjp`` of the JAX roll model over several tile plans;
* ``tiled_rollout_diff`` under ``torch.autograd.grad`` against ``jax.grad``,
  and its d(dt) against a central finite difference;
* the reverse stencil's reach, the planner, ``halo_unscatter`` as the
  transpose of the window cut, the wrapper's refusal of CPU tensors,
  ``auto_rollout_diff``'s CPU route;
* a numpy walk of one launch of the tiled adjoint kernel, step for step as
  csrc/tiled_adjoint.cu computes it, against the plain superstep: the index
  arithmetic is checked here, the CUDA arithmetic on the card
  (tests/test_torch_tiled_adjoint_kernel.py, chip_smoke.py phase 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.pallas_model import (
    _cot_from_planes,
    _pallas_tiled_adjoint,
    _tiled_scal,
)
from mpas_ocean_tpu_torch.constants import GRAVITY
from mpas_ocean_tpu_torch.kernels import tiled_adjoint, tiled_step
from mpas_ocean_tpu_torch.structured import (
    StructState,
    adjoint_plan,
    adjoint_stencil_reach,
    auto_rollout_diff,
    fused_rollout_diff,
    halo_unscatter,
    plain_tiled_adjoint_superstep,
    struct_mesh_from_numpy,
    struct_state_from_numpy,
    structured_run_loop,
    tiled_adjoint_plan,
    tiled_adjoint_rollout,
    tiled_rollout_diff,
)
from mpas_ocean_tpu_torch.structured.fused_model import _scal
from mpas_ocean_tpu_torch.structured.slab import stencil_reach
from mpas_ocean_tpu_torch.structured.tiled_diff import adjoint_window_bytes, reverse_halo
from mpas_ocean_tpu_torch.structured.tiled_model import _windows

from torch_port_cases import (
    STATE_FIELDS,
    jax_lattice,
    jax_struct_mesh_dict,
    jax_struct_state_dict,
    max_rel_err,
)

DT = 10.0


def _port(sm, st):
    return (struct_state_from_numpy(jax_struct_state_dict(st)),
            struct_mesh_from_numpy(jax_struct_mesh_dict(sm.struct_mesh)))


def _fields(state):
    return [getattr(state, f) for f in STATE_FIELDS]


def _random_cotangent(state, seed):
    rng = np.random.default_rng(seed)
    return StructState(*(torch.from_numpy(rng.normal(size=tuple(x.shape)))
                         for x in _fields(state)))


@pytest.fixture(scope="module")
def lattice8():
    """tests/test_pallas.py's 8x8x4 random state (seed 7)."""
    sm, st = jax_lattice(8, 8, 4, seed=7)
    return sm, st, *_port(sm, st)


@pytest.fixture(scope="module")
def lattice16():
    sm, st = jax_lattice(16, 16, 3, seed=4)
    return sm, st, *_port(sm, st)


def _jax_vjp(sm, st, n):
    out, vjp = jax.vjp(lambda s, t: jax_run_loop(s, sm.struct_mesh, t, n), st, DT)
    g = jax.tree.map(lambda a: a + 0.5, out)  # dense arbitrary cotangent
    d_ref, ddt_ref = vjp(g)
    return g, d_ref, float(ddt_ref)


@pytest.mark.parametrize("q", [1, 2])
def test_plain_route_matches_pallas_tiled_adjoint(lattice8, q):
    """8x8x4, 6 steps, against _pallas_tiled_adjoint in interpret mode, as
    tests/test_pallas.py:671-709 runs it (row tile 2, groups of 3
    supersteps; full-width rows on the JAX side, 4-column tiles on the
    port's): atol 1e-12, d(dt) to rtol 1e-10 against dscal[0]."""
    sm, st, state, mesh = lattice8
    smesh = sm.struct_mesh
    n, rt, b = 6, 2, 3
    out = jax_run_loop(st, smesh, DT, n)
    g = jax.tree.map(lambda a: a + 0.5, out)
    ny2, nx, k = smesh.ny2, smesh.nx, st.layer_thickness.shape[-1]
    dtype = st.layer_thickness.dtype
    cot, dscal, _, _ = _pallas_tiled_adjoint(
        _tiled_scal(smesh, DT, dtype), st.ssh[..., None], st.layer_thickness,
        st.normal_velocity.reshape(6, ny2, nx, k),
        smesh.f_edge.reshape(6, ny2, nx, 1).astype(dtype),
        smesh.resting_thickness_sum[..., None].astype(dtype),
        (g.ssh[..., None], g.layer_thickness, g.normal_velocity.reshape(6, ny2, nx, k)),
        None, terms=smesh.coriolis_terms, row_tile=rt, n_steps=n, b=b,
        interpret=True, q=q,
    )
    d_ref = _cot_from_planes(cot, ny2, nx, k)
    d, d_dt = tiled_adjoint_rollout(state, mesh, DT, n,
                                    struct_state_from_numpy(jax_struct_state_dict(g)),
                                    plan=(rt, 4, q, b))
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(d, f).numpy(), np.asarray(getattr(d_ref, f)),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(d_dt), float(dscal[0]), rtol=1e-10)


@pytest.mark.parametrize("plan", [
    (2, 4, 1, 2),   # 16 tiles, column tiles a quarter of nx
    (4, 8, 2, 2),   # q = 2: the window spans 10 x 20 sites of an 8 x 16 lattice
    (8, 16, 1, 3),  # one tile: its window wraps onto itself in rows and columns
    (1, 2, 2, 1),   # one-row tiles, two columns wide
])
def test_plain_route_matches_jax_vjp(lattice16, plan):
    """16x16x3 (ny2 = 8, nx = 16), 6 steps, against jax.vjp of the JAX
    roll model: 1e-12 of each field's magnitude, and of d(dt)."""
    sm, st, state, mesh = lattice16
    n = 6
    g, d_ref, ddt_ref = _jax_vjp(sm, st, n)
    d, d_dt = tiled_adjoint_rollout(state, mesh, DT, n,
                                    struct_state_from_numpy(jax_struct_state_dict(g)),
                                    plan=plan)
    assert d_dt.dtype == torch.float64 and d_dt.shape == ()
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(d, f).numpy(), np.asarray(getattr(d_ref, f))) <= 1e-12, f
    assert abs(float(d_dt) - ddt_ref) <= 1e-12 * abs(ddt_ref)


def _objective(out):
    return (out.ssh ** 2).sum()


@pytest.mark.parametrize("plan", [None, (2, 4, 2, 2)])
def test_tiled_rollout_diff_grad_matches_jax_grad(lattice8, plan):
    """grad of sum(ssh_final^2) in the state and dt, 6 steps on 8x8x4,
    against jax.grad of the JAX roll model; the forward is the plain
    rollout's, bitwise."""
    sm, st, state, mesh = lattice8
    n = 6

    def obj_jax(s, dt):
        return jnp.sum(jax_run_loop(s, sm.struct_mesh, dt, n).ssh ** 2)

    r_s, r_dt = jax.grad(obj_jax, argnums=(0, 1))(st, jnp.float64(DT))
    x = [t.clone().requires_grad_(True) for t in _fields(state)]
    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    out = tiled_rollout_diff(StructState(*x), mesh, dt, n, plan=plan)
    grads = torch.autograd.grad(_objective(out), x + [dt])
    for f, got in zip(STATE_FIELDS, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(r_s, f)),
                                   rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(float(grads[3]), float(r_dt), rtol=1e-9)
    assert grads[3].dtype == torch.float64
    ref = structured_run_loop(state, mesh, DT, n)
    for a, b in zip(_fields(out), _fields(ref)):
        assert torch.equal(a.detach(), b)


def test_tiled_d_dt_matches_finite_differences(lattice8):
    """The directional derivative in dt by central differences, with
    Richardson's extrapolation over eps and eps / 2 (as
    tests/test_torch_adjoint.py does for the whole gradient): the objective
    is a polynomial of degree 2n in dt, so the extrapolated difference is
    off by ~1e-11 of the derivative."""
    *_, state, mesh = lattice8
    n, plan = 8, (2, 4, 2, 2)

    def objective(dt):
        return float(_objective(tiled_rollout_diff(state, mesh, dt, n, plan=plan)))

    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    (d_dt,) = torch.autograd.grad(_objective(tiled_rollout_diff(state, mesh, dt, n,
                                                                plan=plan)), [dt])

    def central(eps):
        return (objective(DT + eps) - objective(DT - eps)) / (2 * eps)

    eps = 1e-2
    fd = (4 * central(eps / 2) - central(eps)) / 3
    assert abs(fd - float(d_dt)) <= 1e-8 * abs(float(d_dt))


def test_adjoint_stencil_reach_of_the_tables(lattice16):
    """One reverse step reads (1, 2) sites per side, as the FE forward step
    does: the transposed Coriolis taps reach |dm| = 1 and |di| = 2, the
    continuity taps (G, u dG, S_e) one site."""
    *_, mesh = lattice16
    terms = mesh.coriolis_terms
    assert adjoint_stencil_reach(terms) == (1, 2)
    assert adjoint_stencil_reach(terms) == stencil_reach(terms, False)
    assert reverse_halo(terms) == (1, 2)


@pytest.mark.parametrize("shape", [(128, 256, 100), (32, 64, 100)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_tiled_adjoint_plan_fits(shape, itemsize):
    """The planner's tiles divide the lattice, the adjoint window leaves
    room for two blocks per SM, q divides n_steps, and group is
    adjoint_plan's over the supersteps."""
    ny2, nx, k = shape
    halo = (1, 2)
    state_bytes = itemsize * 2 * ny2 * nx * (1 + 4 * k)
    for n_steps in (100, 6, 5):
        rt, ct, q, group = tiled_adjoint_plan(ny2, nx, k, itemsize, n_steps, halo=halo)
        assert ny2 % rt == 0 and nx % ct == 0 and n_steps % q == 0 and q == 1
        assert adjoint_window_bytes(rt, ct, q, halo, k, itemsize) <= tiled_step.TWO_BLOCK_BYTES
        assert group == adjoint_plan(n_steps // q, state_bytes, float("inf"))
    want = (4, 8) if itemsize == 4 else (2, 8)
    assert tiled_adjoint_plan(ny2, nx, k, itemsize, 100, halo=halo)[:2] == want
    # a caller's q is kept where it divides n_steps, and its window must fit
    rt, ct, q, group = tiled_adjoint_plan(ny2, nx, k, itemsize, 100, halo=halo,
                                          row_tile=2, col_tile=4, q=2)
    assert (rt, ct, q, group) == (2, 4, 2, adjoint_plan(50, state_bytes, float("inf")))
    with pytest.raises(ValueError, match="budget"):
        tiled_adjoint_plan(ny2, nx, k, itemsize, 100, halo=halo, budget=4 * state_bytes)


def test_halo_unscatter_is_the_transpose_of_the_window_cut():
    """<windows(x), w> = <x, halo_unscatter(w)> for random x and w, on a
    lattice smaller than one window (so sites repeat within a window)."""
    rng = np.random.default_rng(3)
    ny2, nx, k = 4, 6, 2
    for rt, ct, hm, hi in ((2, 3, 1, 2), (4, 6, 3, 4), (1, 1, 2, 2)):
        x = torch.from_numpy(rng.normal(size=(3, ny2, nx, k)))
        wx = _windows(x, rt, ct, hm, hi)
        w = torch.from_numpy(rng.normal(size=tuple(wx.shape)))
        lhs = float((wx * w).sum())
        rhs = float((x * halo_unscatter(w, ny2, nx, hm, hi)).sum())
        assert abs(lhs - rhs) <= 1e-13 * abs(lhs)


def test_tiled_adjoint_wrapper_refuses_cpu_tensors(lattice8):
    *_, state, mesh = lattice8
    stack = tuple(x[None] for x in _fields(state))
    with pytest.raises(ValueError, match="CUDA"):
        tiled_adjoint.tiled_adjoint_rollout(
            stack, tuple(_fields(state)), mesh.f_edge, mesh.resting_thickness_sum,
            *mesh.host_stencil, *mesh.host_adjoint_stencil, DT, 1e-3, 1e-3, 1,
            torch.zeros(1, dtype=torch.float64),
            row_tile=2, col_tile=4, q=1, halo=(1, 2))


def test_tiled_rollout_diff_rejects_a_q_that_does_not_divide(lattice8):
    *_, state, mesh = lattice8
    with pytest.raises(ValueError, match="divide"):
        tiled_rollout_diff(state, mesh, DT, 5, plan=(2, 4, 2, 1))


def test_auto_rollout_diff_on_the_cpu_is_fused_rollout_diff(lattice8):
    """A CPU state takes the fused route's plain version, bit for bit."""
    *_, state, mesh = lattice8
    n = 5
    got, want = [], []
    for fn, acc in ((auto_rollout_diff, got), (fused_rollout_diff, want)):
        x = [t.clone().requires_grad_(True) for t in _fields(state)]
        dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
        out = fn(StructState(*x), mesh, dt, n)
        acc += [t.detach() for t in _fields(out)]
        acc += list(torch.autograd.grad(_objective(out), x + [dt]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _walk_tiled_adjoint_launch(ssh, h, u, gs, gh, gu, f, rts, table, w, adj_table, adj_w,
                               dt, inv_dc, s_div, rt, ct, q, halo):
    """One launch as csrc/tiled_adjoint.cu computes it, on numpy planes: per
    tile, the wrapped primal window R_{2q-1} and the end cotangent on R_q
    with flattened site offsets (dm * Wi + di); the primal states 1 .. q - 1
    recomputed forward on the shrinking window; the reverse steps on the
    shrinking regions R_j, with the level chunks of a cluster and their
    partial sums of S_e added in rank order; d(dt) on the core. NaN stands
    outside what each step writes, so a read there fails the test. ssh and
    gs (2, ny2, nx), h and gh (2, ny2, nx, K), u and gu (6, ny2, nx, K), f
    (6, ny2, nx), rts (2, ny2, nx). Returns (ds, dh, du, d(dt))."""
    _, ny2, nx, k = h.shape
    hm, hi = halo
    ranks, kc = tiled_adjoint.level_split(k, q)
    span = 2 * q - 1
    wm, wi = rt + 2 * hm * span, ct + 2 * hi * span
    nbr, inc, off = table[1:19].reshape(6, 3), table[19:37].reshape(6, 3), table[37:44]
    taps = table[44:44 + 3 * table[0]].reshape(-1, 3)
    aoff = adj_table[37:44]
    ataps = adj_table[44:44 + 3 * adj_table[0]].reshape(-1, 3)
    nbr_d = nbr[:, 1] * wi + nbr[:, 2]
    inc_d = inc[:, 1] * wi + inc[:, 2]
    inc_nd = inc_d + nbr_d[inc[:, 0]]
    tap_d = taps[:, 1] * wi + taps[:, 2]
    atap_d = ataps[:, 1] * wi + ataps[:, 2]
    dt_div = dt * s_div

    def region(r0, c0):
        r, c = np.meshgrid(np.arange(r0, wm - r0), np.arange(c0, wi - c0), indexing="ij")
        return (r * wi + c).ravel()

    def level_sum(x, combine=lambda parts: parts[0]):
        """Column sums of x (columns, sites, K) as the cluster takes them:
        ``combine`` joins the columns per level, each rank sums its levels,
        then the ranks' partials are added in rank order."""
        col = None
        for rank in range(ranks):
            lv = [xc[:, rank * kc:min(k, (rank + 1) * kc)] for xc in x]
            part = combine([xc[:, 0] for xc in lv])
            for kl in range(1, lv[0].shape[1]):
                part = part + combine([xc[:, kl] for xc in lv])
            col = part if col is None else col + part
        return col

    out = [np.empty_like(x) for x in (gs, gh, gu)]
    ddt = 0.0
    for tm in range(ny2 // rt):
        for ti in range(nx // ct):
            gm = (tm * rt - hm * span + np.arange(wm)) % ny2
            gi = (ti * ct - hi * span + np.arange(wi)) % nx
            win = lambda x: x[:, gm[:, None], gi[None, :]].reshape(x.shape[0], wm * wi,
                                                                   *x.shape[3:])
            f_w, rts_w = win(f), win(rts)
            prim, s_prim = [np.concatenate([win(h), win(u)])], [win(ssh)]
            for j in range(q - 1):  # the forward recompute, FE
                cur, s_cur = prim[-1], s_prim[-1]
                nxt, s_nxt = np.full_like(cur, np.nan), np.full_like(s_cur, np.nan)
                s = region(hm * (j + 1), hi * (j + 1))
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
                    nxt[p, s] = cur[p, s] - dt_div * total
                    s_nxt[p, s] = level_sum([nxt[p, s]]) - rts_w[p, s]
                for c in range(6):
                    acc = None
                    for t in range(off[c], off[c + 1]):
                        src = s + tap_d[t]
                        contrib = w[t] * (cur[2 + taps[t, 0], src]
                                          * f_w[taps[t, 0], src][:, None])
                        acc = contrib if acc is None else acc + contrib
                    grad = (s_cur[nbr[c, 0], s + nbr_d[c]] - s_cur[c & 1, s]) * inv_dc
                    nxt[2 + c, s] = cur[2 + c, s] + dt * acc - GRAVITY * dt * grad[:, None]
                prim.append(nxt)
                s_prim.append(s_nxt)
            # the end cotangent on R_q only
            rq = region(hm * (q - 1), hi * (q - 1))
            cot, g_s = (np.full((8, wm * wi, k), np.nan), np.full((2, wm * wi), np.nan))
            cot[:, rq] = np.concatenate([win(gh), win(gu)])[:, rq]
            g_s[:, rq] = win(gs)[:, rq]
            core = region(hm * span, hi * span)
            for j in reversed(range(q)):
                P, sp = prim[j], s_prim[j]
                s = region(hm * (span - j), hi * (span - j))
                in_core = np.isin(s, core)
                nxt, s_nxt = np.full_like(cot, np.nan), np.full_like(g_s, np.nan)
                for p in (0, 1):
                    g_c = cot[p, s] + g_s[p, s][:, None]
                    # S_e of the 3 owned edges, then of the 3 incoming ones
                    edges = ([cot[2 + f2 * 2 + p, s] for f2 in range(3)]
                             + [cot[2 + inc[x, 0], s + inc_d[x]] for x in range(3 * p, 3 * p + 3)])
                    s_nxt[p, s] = (GRAVITY * dt * inv_dc) * level_sum(
                        edges, lambda S: (S[0] + S[1] + S[2]) - (S[3] + S[4] + S[5]))
                    flux = 0.0
                    for fam in range(3):
                        c = fam * 2 + p
                        pin = nbr[c, 0]
                        d_g = cot[pin, s + nbr_d[c]] + g_s[pin, s + nbr_d[c]][:, None] - g_c
                        he = 0.5 * (P[pin, s + nbr_d[c]] + P[p, s])
                        c_t = 0.0
                        for t in range(aoff[c], aoff[c + 1]):
                            c_t = c_t + adj_w[t] * cot[2 + ataps[t, 0], s + atap_d[t]]
                        fct = f_w[c, s][:, None] * c_t
                        nxt[2 + c, s] = cot[2 + c, s] + he * (dt_div * d_g) + dt * fct
                        flux = flux + P[2 + c, s] * (dt_div * d_g)
                        grad = (sp[pin, s + nbr_d[c]] - sp[p, s]) * inv_dc
                        share = (P[2 + c, s] * (s_div * d_g * he + fct)
                                 - GRAVITY * grad[:, None] * cot[2 + c, s])
                        ddt += float(share[in_core].sum())
                    for x in range(3 * p, 3 * p + 3):
                        own = inc[x, 0] & 1
                        d_g = g_c - (cot[own, s + inc_d[x]] + g_s[own, s + inc_d[x]][:, None])
                        flux = flux + P[2 + inc[x, 0], s + inc_d[x]] * (dt_div * d_g)
                    nxt[p, s] = g_c + 0.5 * flux
                cot, g_s = nxt, s_nxt
            rows, cols = tm * rt + np.arange(rt), ti * ct + np.arange(ct)
            put = lambda dst, x: dst.__setitem__(
                (slice(None), rows[:, None], cols[None, :]),
                x[:, core].reshape(x.shape[0], rt, ct, *x.shape[2:]))
            put(out[0], g_s)
            put(out[1], cot[:2])
            put(out[2], cot[2:])
    return (*out, ddt)


@pytest.mark.parametrize("plan", [(1, 4, 1), (4, 2, 1), (2, 8, 2), (3, 4, 2)])
def test_kernel_window_walk_matches_plain(plan):
    """The tiled adjoint kernel's index arithmetic, walked in numpy: one
    reverse superstep on 24x24x5 (ny2 = 12, three level chunks of 2, 2 and
    1) from the state after 3 steps and a random cotangent, <= 1e-12 of
    each field's magnitude and of d(dt) against the plain superstep."""
    sm, st = jax_lattice(24, 24, 5, seed=6)
    state, mesh = _port(sm, st)
    rt, ct, q = plan
    ny2, nx, k = mesh.ny2, mesh.nx, 5
    start = structured_run_loop(state, mesh, DT, 3)
    g = _random_cotangent(start, 8)
    dt_, inv_dc, s_div = _scal(mesh, DT, torch.float64)
    six = lambda x: x.numpy().reshape(6, ny2, nx, k)
    *got, got_dt = _walk_tiled_adjoint_launch(
        start.ssh.numpy(), start.layer_thickness.numpy(), six(start.normal_velocity),
        g.ssh.numpy(), g.layer_thickness.numpy(), six(g.normal_velocity),
        mesh.f_edge.numpy().reshape(6, ny2, nx), mesh.resting_thickness_sum.numpy(),
        mesh.stencil_table.numpy(), mesh.coriolis_weight.numpy(),
        mesh.adjoint_table.numpy(), mesh.adjoint_weight.numpy(),
        dt_, inv_dc, s_div, rt, ct, q, reverse_halo(mesh.coriolis_terms))
    ref, ref_dt = plain_tiled_adjoint_superstep(start, g, mesh, DT, rt, ct, q)
    for x, f in zip(got, STATE_FIELDS):
        want = getattr(ref, f).numpy()
        assert max_rel_err(x.reshape(want.shape), want) <= 1e-12, f
    assert abs(got_dt - float(ref_dt)) <= 1e-12 * abs(float(ref_dt))
