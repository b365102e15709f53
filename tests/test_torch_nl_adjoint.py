"""The port's nonlinear (vector-invariant) reverse against the JAX package's,
on the CPU at f64 (numpy-seeded inputs): the hand-written plain reverse step
against ``torch.func.vjp`` and ``jax.vjp``; the CPU routes of
``fused_rollout_diff`` and ``tiled_rollout_diff`` against the JAX package's
fused and tiled adjoint kernels in interpret mode; the dot-product identity;
the reverse's rings derived from the tables against the kernel's constants
and the step's measured footprint; the transposed vertex tables as
csrc/nl_adjoint.cuh takes them (hex_vadj::, parsed from the source) and a
numpy walk of the kernel's four stages against the plain reverse (the CUDA
arithmetic itself is checked on the card: tests/test_torch_adjoint_kernel.py,
tests/test_torch_tiled_adjoint_kernel.py, chip_smoke.py phase 13); the
planners; the refusals.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.structured.model import structured_step as jax_step
from mpas_ocean_tpu.structured.pallas_model import (
    _cot_from_planes,
    _nl_setup as jax_nl_setup,
    _pallas_tiled_adjoint,
    _tiled_scal,
    pallas_adjoint_rollout,
)
from mpas_ocean_tpu_torch.constants import GRAVITY
from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step
from mpas_ocean_tpu_torch.structured import (
    StructState,
    auto_rollout_diff,
    fused_adjoint_rollout,
    fused_rollout_diff,
    structured_nl_adjoint_step,
    structured_run_loop,
    structured_step,
    tiled_adjoint_plan,
    tiled_adjoint_rollout,
    tiled_rollout_diff,
)
from mpas_ocean_tpu_torch.structured import model as pm
from mpas_ocean_tpu_torch.structured.fused_model import (
    _scal,
    kernel_live,
    nl_adjoint_scal,
    nl_scal,
    nl_setup,
)
from mpas_ocean_tpu_torch.structured.slab import adjoint_stencil_reach, nl_adjoint_rings
from mpas_ocean_tpu_torch.structured.stencils import (
    CURL_TERMS,
    transpose_curl_terms,
    transpose_endpoint_terms,
    transpose_kite_terms,
)
from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo

from test_torch_nonlinear import _cuh_maps
from test_torch_tiled import _stencil_offsets
from torch_port_cases import STATE_FIELDS, nl_channel, nl_periodic

FIELDS = STATE_FIELDS
DT = 2.0
_CUH = Path(mt.__file__).parent / "csrc" / "nl_adjoint.cuh"


@pytest.fixture(scope="module")
def periodic8():
    return nl_periodic(8, 2)


@pytest.fixture(scope="module")
def channel8():
    return nl_channel(8, 2)


@pytest.fixture(scope="module")
def lattices16():
    return {"periodic": nl_periodic(16, 3), "channel": nl_channel(16, 2)}


def _case(case, periodic8, channel8):
    return periodic8 if case == "periodic" else channel8


def _cotangent(like, seed):
    rng = np.random.default_rng(seed)
    return StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(like, f).shape)))
                         for f in FIELDS))


def _close(got, want, d_dt=None, d_dt_want=None, tol=1e-12):
    """Each field within tol of its scale (max |want|), and d(dt)."""
    for f in FIELDS:
        a = getattr(got, f).detach().double().numpy()
        b = np.asarray(getattr(want, f), np.float64)
        assert a.shape == b.shape, f
        err = float(np.abs(a - b).max() / np.abs(b).max())
        assert err <= tol, f"{f}: {err:.3e}"
    if d_dt is not None:
        err = abs(float(d_dt) - float(d_dt_want)) / abs(float(d_dt_want))
        assert err <= tol, f"d_dt: {err:.3e}"


# ---- the plain reverse step ----------------------------------------------------

@pytest.mark.parametrize("case", ["periodic", "channel"])
def test_nl_adjoint_step_matches_autograd_and_jax_vjp(case, periodic8, channel8):
    """structured_nl_adjoint_step against torch.func.vjp of the plain
    structured_step(nonlinear=True) and against jax.vjp of the JAX package's
    structured_step(nonlinear=True) (structured/model.py:272) on the same
    numpy-seeded state and cotangent, d(dt) included: 1e-12 of scale."""
    smj, smp, st_j, st = _case(case, periodic8, channel8)[:4]
    mesh = smp.struct_mesh
    g = _cotangent(st, 3)
    got, d_dt = structured_nl_adjoint_step(st, g, mesh, DT)

    _, vjp = torch.func.vjp(
        lambda s, h, u, t: tuple(getattr(structured_step(StructState(s, h, u), mesh, t, True), f)
                                 for f in FIELDS),
        st.ssh, st.layer_thickness, st.normal_velocity, torch.tensor(DT, dtype=torch.float64))
    *ref, ref_dt = vjp(tuple(getattr(g, f) for f in FIELDS))
    _close(got, StructState(*(x.numpy() for x in ref)), d_dt, ref_dt)

    _, jvjp = jax.vjp(lambda s, t: jax_step(s, smj.struct_mesh, t, nonlinear=True), st_j,
                      jnp.float64(DT))
    g_j = dataclasses.replace(st_j, **{f: jnp.asarray(getattr(g, f).numpy()) for f in FIELDS})
    d_j, ddt_j = jvjp(g_j)
    _close(got, d_j, d_dt, ddt_j)
    if case == "channel":
        # no NaN through the guarded division; the plain reverse's own
        # autograd twin agrees there too
        assert all(bool(torch.isfinite(getattr(got, f)).all()) for f in FIELDS)


# ---- the routes against the JAX package's kernels in interpret mode -----------

@pytest.mark.parametrize("case", ["periodic", "channel"])
def test_fused_route_matches_pallas_adjoint(case, periodic8, channel8):
    """fused_adjoint_rollout(nonlinear=True) on a CPU state (the plain steps
    and structured_nl_adjoint_step, groups of 2) against
    pallas_adjoint_rollout(plan=(1, 2), interpret=True, nonlinear=True), as
    tests/test_pallas.py:360-376 and tests/test_nonlinear.py:323-345 run it
    (with plan (2, 3) the in-kernel vjp of 2 steps takes 4x as long in
    interpret mode): 4 steps of 8x8x2, 1e-12 of scale, d(dt) included."""
    smj, smp, st_j, st = _case(case, periodic8, channel8)[:4]
    g = _cotangent(st, 5)
    got, d_dt = fused_adjoint_rollout(st, smp.struct_mesh, DT, 4, g, plan=2, nonlinear=True)
    g_j = dataclasses.replace(st_j, **{f: jnp.asarray(getattr(g, f).numpy()) for f in FIELDS})
    d_j, ddt_j = pallas_adjoint_rollout(st_j, smj.struct_mesh, DT, 4, g_j, plan=(1, 2),
                                        interpret=True, nonlinear=True)
    _close(got, d_j, d_dt, ddt_j)


@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("case", ["periodic", "channel"])
def test_tiled_route_matches_pallas_tiled_adjoint(case, q, periodic8, channel8):
    """tiled_adjoint_rollout(nonlinear=True) on a CPU state (the plain
    superstep, the VJP of slab.window_steps with the vertex constants, 2 x 4
    tiles, q steps per superstep: the plain version of the nonlinear
    reverse kernel at q = 1 and of the q-step one at q = 2) against
    _pallas_tiled_adjoint(nl_terms=, f_vert=, q=q, interpret=True)
    (pallas_model.py:2284, with _nl_setup and _tiled_scal(nonlinear=True)):
    2 steps of 8x8x2, 1e-12 of scale, d(dt) against dscal[0]."""
    smj, smp, st_j, st = _case(case, periodic8, channel8)[:4]
    sj = smj.struct_mesh
    n, k = 2, st.layer_thickness.shape[-1]
    ny2, nx = sj.ny2, sj.nx
    g = _cotangent(st, 6)
    got, d_dt = tiled_adjoint_rollout(st, smp.struct_mesh, DT, n, g, plan=(2, 4, q, 1),
                                      nonlinear=True)
    dtype = st_j.layer_thickness.dtype
    nl_terms, f_vert = jax_nl_setup(sj, dtype, True)
    mask = None if sj.edge_mask is None else sj.edge_mask.reshape(6, ny2, nx, 1).astype(dtype)
    cot, dscal, _, _ = _pallas_tiled_adjoint(
        _tiled_scal(sj, DT, dtype, nonlinear=True), st_j.ssh[..., None], st_j.layer_thickness,
        st_j.normal_velocity.reshape(6, ny2, nx, k), sj.f_edge.reshape(6, ny2, nx, 1),
        sj.resting_thickness_sum[..., None],
        tuple(jnp.asarray(x) for x in (g.ssh[..., None].numpy(), g.layer_thickness.numpy(),
                                       g.normal_velocity.reshape(6, ny2, nx, k).numpy())),
        mask, terms=sj.coriolis_terms, row_tile=2, n_steps=n, b=1, interpret=True, q=q,
        f_vert=f_vert, nl_terms=nl_terms)
    _close(got, _cot_from_planes(cot, ny2, nx, k), d_dt, dscal[0])


@pytest.mark.parametrize("q", [1, 2])
def test_tiled_route_matches_fused_route(q, lattices16):
    """The tiled route's plain superstep at q = 1 and 2 (the CPU runs any
    q) on a 16x16 channel, 4 steps, against the fused route: 1e-12."""
    smp, st = lattices16["channel"][1], lattices16["channel"][3]
    g = _cotangent(st, 9)
    ref, ref_dt = fused_adjoint_rollout(st, smp.struct_mesh, DT, 4, g, plan=2, nonlinear=True)
    got, d_dt = tiled_adjoint_rollout(st, smp.struct_mesh, DT, 4, g, plan=(4, 8, q, 2),
                                      nonlinear=True)
    _close(got, ref, d_dt, ref_dt)


def test_dot_product_identity(lattices16):
    """<J v, g> = <v, J^T g> at f64 over 7 steps on the 16x16 lattices,
    J v by torch.func.jvp of the plain nonlinear rollout, J^T g by
    torch.autograd.grad through fused_rollout_diff(nonlinear=True) and
    auto_rollout_diff(nonlinear=True) (their CPU route): 1e-12 relative;
    d(dt) of the grad against a central difference."""
    for case in ("periodic", "channel"):
        smp, st = lattices16[case][1], lattices16[case][3]
        sm = smp.struct_mesh
        v, g = _cotangent(st, 12), _cotangent(st, 14)
        if sm.edge_mask is not None:  # a tangent that keeps the walls closed
            v = StructState(v.ssh, v.layer_thickness, v.normal_velocity * sm.edge_mask[..., None])
        fields = lambda s: tuple(getattr(s, f) for f in FIELDS)  # noqa: E731
        _, jv = torch.func.jvp(
            lambda *xs: fields(structured_run_loop(StructState(*xs), sm, DT, 7, nonlinear=True)),
            fields(st), fields(v))
        lhs = sum(float((x * y).sum()) for x, y in zip(jv, fields(g)))
        for route in (fused_rollout_diff, auto_rollout_diff):
            leaves = [x.clone().requires_grad_(True) for x in fields(st)]
            out = route(StructState(*leaves), sm, DT, 7, plan=3, nonlinear=True)
            jtg = torch.autograd.grad(fields(out), leaves, fields(g))
            rhs = sum(float((x * y).sum()) for x, y in zip(fields(v), jtg))
            assert abs(lhs - rhs) <= 1e-12 * abs(rhs), (case, route.__name__, lhs, rhs)
    smp, st = lattices16["periodic"][1], lattices16["periodic"][3]
    sm = smp.struct_mesh
    t = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    obj = lambda d: float((structured_run_loop(st, sm, d, 7, nonlinear=True).ssh ** 2).sum())  # noqa
    out = fused_rollout_diff(st, sm, t, 7, nonlinear=True)
    (d_dt,) = torch.autograd.grad((out.ssh ** 2).sum(), [t])
    eps = 1e-4
    fd = (obj(DT + eps) - obj(DT - eps)) / (2 * eps)
    assert abs(float(d_dt) - fd) <= 1e-6 * abs(fd)


# ---- the reach, the tables and the kernel's scheme ----------------------------

def _tables(n=8, dtype=np.float64):
    hp = mt.planar_hex_mesh(n, n, 1000.0, f0=1e-4, dtype=dtype)
    lay = mt.structured.HexLayout(hp, n, n)
    terms = tuple((t.f_out, t.p_out, t.f_in, t.p_in, t.dm, t.di, t.w) for t in lay.coriolis_terms)
    return terms, (lay.vertex_cell_terms, lay.edge_vertex_terms)


def _vadj_maps() -> dict:
    """csrc/nl_adjoint.cuh's hex_vadj:: maps and ring constants, read from
    the source."""
    text = _CUH.read_text()
    out = {}
    for name, body in re.findall(
            r"constexpr int (\w+)\(int t, int j\) \{\s*constexpr int m\[kTaps\]\[6\] = (\{.*?\});",
            text, re.S):
        out[name] = tuple(tuple(int(x) for x in row) for row in
                          np.array(re.findall(r"-?\d+", body), int).reshape(-1, 6))
    out["own_v"] = [int(x) for x in re.search(
        r"own_v\(int v4\) \{\s*constexpr int m\[4\] = \{([^}]*)\}", text).group(1).split(",")]
    consts = dict((k, int(v)) for k, v in re.findall(r"(k(?:Ring|Win)\w+) = (\d+)", text))
    out["rings"] = ((consts["kRingCm"], consts["kRingCi"]), (consts["kRingBm"], consts["kRingBi"]),
                    (consts["kRingAm"], consts["kRingAi"]), (consts["kWinM"], consts["kWinI"]))
    return out


def test_reverse_rings_derived_from_the_tables():
    """The nonlinear reverse's rings (slab.nl_adjoint_rings, from the
    tables' taps) are the kernel's constants and the wrapper's
    (adjoint_step.NL_ADJ_RINGS): (1, 1), (2, 2), (3, 4) and a (4, 6) window,
    wider than the forward's (2, 4) composition, since the gather form
    reads each output site's dependents' dependents. The measured footprint
    of the plain reverse step (which cotangent and primal sites move a
    site's result) lies inside the window: (1, 2), the forward step's own;
    the linear reverse's reach stays (1, 2)."""
    terms, nl_terms = _tables()
    rings = nl_adjoint_rings(terms, nl_terms)
    assert rings == adjoint_step.NL_ADJ_RINGS == _vadj_maps()["rings"]
    assert rings == ((1, 1), (2, 2), (3, 4), (4, 6))
    assert adjoint_stencil_reach(terms, nl_terms) == (4, 6)
    assert adjoint_stencil_reach(terms) == (1, 2)
    assert reverse_halo(terms, nl_terms) == (2, 4)

    lattice = nl_periodic(16, 1)
    mesh, st = lattice[1].struct_mesh, lattice[3]
    g = _cotangent(st, 4)
    base, _ = structured_nl_adjoint_step(st, g, mesh, DT)
    sums = {3: (0,), 4: (0, 3), 5: (0, 1, 4)}  # ssh, h, u -> (ny2, nx)
    cm, ci = 4, 8
    for which in ("primal", "cotangent"):
        src = [getattr(st if which == "primal" else g, f).clone() for f in FIELDS]
        src[0][:, cm, ci] += 1e-3
        src[1][:, cm, ci] += 1e-3
        src[2][:, :, cm, ci] += 1e-3
        s2, g2 = (StructState(*src), g) if which == "primal" else (st, StructState(*src))
        out, _ = structured_nl_adjoint_step(s2, g2, mesh, DT)
        moved = sum((a - b).abs().sum(sums[a.dim()]) for a, b in (
            (getattr(out, f), getattr(base, f)) for f in FIELDS)) > 1e-14
        rows, cols = np.nonzero(moved.numpy())
        assert (np.abs(rows - cm).max(), np.abs(cols - ci).max()) == (1, 2), which


def test_curl_terms_are_the_models_curl(periodic8):
    """stencils.CURL_TERMS applied as a table gives model.curl_on_vertex."""
    smp, st = periodic8[1], periodic8[3]
    u = st.normal_velocity
    sm = smp.struct_mesh
    out = [[None, None], [None, None]]
    for (kind, p, ch, dm, di, sign) in CURL_TERMS:
        x = sign * pm._shift(u[ch // 2, ch % 2], dm, di)
        out[kind][p] = x if out[kind][p] is None else out[kind][p] + x
    got = torch.stack([torch.stack(x) for x in out]) * (sm.dc / (sm.area_cell * 0.5))
    assert torch.allclose(got, pm.curl_on_vertex(u, sm), rtol=1e-14, atol=0)


@pytest.mark.parametrize("n, dtype", [(6, np.float64), (10, np.float32), (16, np.float64)])
def test_transposed_vertex_tables_map_as_the_kernel_takes_them(n, dtype):
    """The kernel takes the hex lattice's vertex tables only: every
    lattice's transposed kite, endpoint and curl tables (stencils.py) are
    csrc/nl_adjoint.cuh's hex_vadj:: maps, and each transposed tap is the
    transpose of a forward tap (the tables' sizes, 12 each, and the own
    vertex map against hex_vert::v_src)."""
    _, (vc, ev) = _tables(n, dtype)
    maps = _vadj_maps()
    assert transpose_kite_terms(vc) == maps["kite_t"]
    assert transpose_endpoint_terms(ev) == maps["ev_t"]
    assert transpose_curl_terms() == maps["curl_t"]
    hv = _cuh_maps()
    assert [tuple(hv["v_src"][v]) for v in maps["own_v"]] == [(c, 0, 0) for c in range(4)]
    fwd_kite = {(t[0], t[1], t[2], t[3], t[4]) for t in vc}
    assert {(k, po, p, -dm, -di) for (p, k, po, dm, di, _) in maps["kite_t"]} == fwd_kite
    assert {(f, po, k, p, -dm, -di) for (k, p, f, po, dm, di) in maps["ev_t"]} == set(ev)


def _walk_nl_adjoint_launch(st, g, mesh, fv, scal, rt, ct, live=None):
    """One launch of the nonlinear reverse as csrc/nl_adjoint.cuh computes
    it, on numpy planes, all levels at once: per tile (sites past the
    lattice's edge skipped), the wrapped window of the primal state and the
    cotangent (gs folded into gh, the live bits into gu); stage A (F, q_e) on
    ring A through hex_vert::'s maps; stage B (dq_e, dF, Sg) on ring B at the
    tables' offsets in ring A's geometry, with the tile's d(dt); stage C
    (the vertex cotangents) on ring C through hex_vadj::'s maps; stage D on
    the tile. Returns (d_state as numpy planes, d(dt))."""
    dt, inv_dc, s_div, s_ke, s_curl = scal
    hv, va = _cuh_maps(), _vadj_maps()
    (cm, ci), (bm, bi), (am, ai), (wm, wi) = va["rings"]
    ssh, h, u = (np.asarray(x) for x in st)
    gs, gh, gu = (np.asarray(x) for x in g)
    _, ny2, nx, k = h.shape
    table, w = mesh.host_stencil
    adj, wt = mesh.host_adjoint_stencil
    nbr, inc, off, taps, *_ = _stencil_offsets(table, 0)
    _, _, off_t, taps_t, *_ = _stencil_offsets(adj, 0)
    _, kw, _ = fe_step.vertex_tables(mesh.vertex_cell_terms, mesh.edge_vertex_terms)
    masked = fv.shape[0] == 20
    out = [np.full_like(x, np.nan) for x in (ssh, h, u)]
    ddt = 0.0
    Wi, Ai, Bi, Ci = ct + 2 * wi, ct + 2 * ai, ct + 2 * bi, ct + 2 * ci

    def region(mm, ii):
        r, c = np.meshgrid(np.arange(rt + 2 * mm), np.arange(ct + 2 * ii), indexing="ij")
        return r.ravel(), c.ravel()

    def vertex_pv(us, hs, fv_w, sv, v):
        cls = hv["v_src"][v][0]
        cu = [us[i] for i in hv["curl_u"][v]]
        zeta = ((cu[0] - cu[1]) - cu[2] if cls < 2 else (cu[0] + cu[1]) - cu[2]) * s_curl
        hsum = 0.0
        for t, i in zip(hv["kite_t"][v], hv["kite_h"][v]):
            wgt = fv_w[8 + t, sv][:, None] if masked else kw[t]
            hsum = hsum + wgt * hs[i]
        num = fv_w[cls, sv][:, None] + zeta
        if masked:
            vm = fv_w[4 + cls, sv][:, None]
            safe = np.where(vm > 0, hsum, 1.0)
            return num / safe * vm, safe
        return num / hsum, hsum

    for tm in range(-(-ny2 // rt)):
        for ti in range(-(-nx // ct)):
            gm = (tm * rt - wm + np.arange(rt + 2 * wm)) % ny2
            gi = (ti * ct - wi + np.arange(ct + 2 * wi)) % nx
            win = lambda x: x[:, gm[:, None], gi[None, :]].reshape(  # noqa: E731
                x.shape[0], -1, *x.shape[3:])
            cur = np.concatenate([win(h), win(u)])
            cot = np.concatenate([win(gh) + win(gs)[..., None], win(gu)])
            if live is not None:
                lw = win(live[None])[0]
                for c6 in range(6):
                    cot[2 + c6] = np.where(((lw >> c6) & 1)[:, None] == 1, cot[2 + c6], 0.0)
            ssh_w, fv_w = win(ssh), win(fv)

            def loads(sw):
                us = [cur[2 + c, sw + a * Wi + b] for c, a, b in hv["u_src"]]
                hs = [cur[p, sw + a * Wi + b] for p, a, b in hv["h_src"]]
                return us, hs

            # stage A on ring A
            r, c = region(am, ai)
            sw = (r + wm - am) * Wi + c + wi - ai
            us, hs = loads(sw)
            qv = [vertex_pv(us, hs, fv_w, sw + hv["v_src"][v][1] * Wi + hv["v_src"][v][2], v)[0]
                  for v in range(8)]
            pa = np.stack([us[ch] * (0.5 * (hs[hv["nb_h"][ch]] + hs[ch & 1])) for ch in range(6)]
                          + [0.5 * (qv[hv["ev_v"][2 * ch]] + qv[hv["ev_v"][2 * ch + 1]])
                             for ch in range(6)])
            # stage B on ring B
            r, c = region(bm, bi)
            sw = (r + wm - bm) * Wi + c + wi - bi
            sa = (r + am - bm) * Ai + c + ai - bi
            on_tile = ((r >= bm) & (r < bm + rt) & (c >= bi) & (c < bi + ct)
                       & (tm * rt + r - bm < ny2) & (ti * ct + c - bi < nx))
            gcot = lambda ch, a, b: cot[2 + ch, sw + a * Wi + b]  # noqa: E731
            G = lambda p, a, b: cot[p, sw + a * Wi + b]  # noqa: E731
            pb = np.zeros((14, len(r), k))
            part = np.zeros((len(r), k))
            for ch in range(6):
                tf = tg = tgq = 0.0
                for t in range(off[ch], off[ch + 1]):
                    tf = tf + w[t] * pa[taps[t, 0], sa + taps[t, 1] * Ai + taps[t, 2]]
                for t in range(off_t[ch], off_t[ch + 1]):
                    x = gcot(*taps_t[t])
                    tg = tg + wt[t] * x
                    tgq = tgq + wt[t] * (x * pa[6 + taps_t[t, 0],
                                                sa + taps_t[t, 1] * Ai + taps_t[t, 2]])
                ta = dt * tg
                fc, qc, guc = pa[ch, sa], pa[6 + ch, sa], gcot(ch, 0, 0)
                dG = G(*nbr[ch]) - G(ch & 1, 0, 0)
                pb[ch] = 0.5 * ((dt * guc) * tf + fc * ta)
                pb[6 + ch] = dG * (dt * s_div) + 0.5 * (dt * tgq + qc * ta)
                part += (s_div * fc * dG + 0.5 * guc * qc * tf) + 0.5 * (fc * qc) * tg
            for p in range(2):
                sg = (gcot(p, 0, 0) + gcot(2 + p, 0, 0) + gcot(4 + p, 0, 0)) - sum(
                    gcot(*inc[x]) for x in range(3 * p, 3 * p + 3))
                pb[12 + p] = sg
                ke = sum(cur[2 + ch, sw] ** 2 for ch in (p, 2 + p, 4 + p)) + sum(
                    cur[2 + inc[x, 0], sw + inc[x, 1] * Wi + inc[x, 2]] ** 2
                    for x in range(3 * p, 3 * p + 3))
                part += (GRAVITY * ssh_w[p, sw][:, None] + ke * s_ke) * inv_dc * sg
            ddt += float(part[on_tile].sum())
            # stage C on ring C
            r, c = region(cm, ci)
            sw = (r + wm - cm) * Wi + c + wi - ci
            sb = (r + bm - cm) * Bi + c + bi - ci
            us, hs = loads(sw)
            pc = np.zeros((8, len(r), k))
            for v4 in range(4):
                taps_v = va["ev_t"][3 * v4:3 * v4 + 3]
                assert all(t[0] * 2 + t[1] == v4 for t in taps_v)
                dqv = 0.5 * sum(pb[t[2] * 2 + t[3], sb + t[4] * Bi + t[5]] for t in taps_v)
                q, safe = vertex_pv(us, hs, fv_w, sw, va["own_v"][v4])
                dz = dqv * fv_w[4 + v4, sw][:, None] / safe if masked else dqv / safe
                pc[v4] = dz * s_curl
                pc[4 + v4] = -(dqv * q) / safe
            # stage D on the tile
            r, c = region(0, 0)
            sw = (r + wm) * Wi + c + wi
            sb = (r + bm) * Bi + c + bi
            sc = (r + cm) * Ci + c + ci
            du, dh = [], []
            for ch in range(6):
                he = 0.5 * (cur[nbr[ch, 0], sw + nbr[ch, 1] * Wi + nbr[ch, 2]] + cur[ch & 1, sw])
                dke = dt * inv_dc * (pb[12 + nbr[ch, 0], sb + nbr[ch, 1] * Bi + nbr[ch, 2]]
                                     + pb[12 + (ch & 1), sb])
                curl = sum(t[5] * pc[t[1] * 2 + t[2], sc + t[3] * Ci + t[4]]
                           for t in va["curl_t"][2 * ch:2 * ch + 2])
                du.append(cot[2 + ch, sw] + he * pb[6 + ch, sb]
                          + 2 * s_ke * cur[2 + ch, sw] * dke + curl)
            for p in range(2):
                flux = sum(cur[2 + ch, sw] * pb[6 + ch, sb] for ch in (p, 2 + p, 4 + p))
                for x in range(3 * p, 3 * p + 3):
                    ch, a, b = inc[x]
                    flux = flux + cur[2 + ch, sw + a * Wi + b] * pb[6 + ch, sb + a * Bi + b]
                kite = 0.0
                for (_, kind, po, a, b, t) in va["kite_t"][6 * p:6 * p + 6]:
                    wgt = fv_w[8 + t, sw + a * Wi + b][:, None] if masked else kw[t]
                    kite = kite + wgt * pc[4 + kind * 2 + po, sc + a * Ci + b]
                dh.append(cot[p, sw] + 0.5 * flux + kite)
            ds = GRAVITY * dt * inv_dc * pb[12:14, sb].sum(-1)
            lm, li = tm * rt + r, ti * ct + c
            keep = (lm < ny2) & (li < nx)
            out[0][:, lm[keep], li[keep]] = ds[:, keep]
            out[1][:, lm[keep], li[keep]] = np.stack(dh)[:, keep]
            out[2][:, lm[keep], li[keep]] = np.stack(du)[:, keep]
    return out, ddt


@pytest.mark.parametrize("case, tile", [
    ("periodic", (4, 8)),
    ("periodic", (3, 5)),    # ragged tiles
    ("periodic", (8, 16)),   # the tile is the whole lattice; the window wraps onto itself
    ("channel", (2, 8)),
    ("channel", (8, 16)),
])
def test_nl_adjoint_kernel_walk_matches_plain(case, tile, lattices16):
    """The nonlinear reverse kernel's scheme (csrc/nl_adjoint.cuh), walked
    in numpy through its host-resolved taps (hex_vert::, hex_vadj:: and the
    packed Coriolis tables, parsed or packed as the kernel takes them): two
    reverse steps on 16x16 (every site written) within 1e-12 of the plain
    structured_nl_adjoint_step, d(dt) included."""
    smp, st = lattices16[case][1], lattices16[case][3]
    sm = smp.struct_mesh
    ny2, nx, k = sm.ny2, sm.nx, st.layer_thickness.shape[-1]
    scal = (*_scal(sm, DT, torch.float64), *nl_scal(sm, torch.float64))
    live = None if case == "periodic" else kernel_live(sm).numpy()
    fv = nl_setup(sm, torch.float64).numpy()
    st1 = structured_step(st, sm, DT, True)
    g = _cotangent(st, 2)
    ref, walk = g, (g.ssh.numpy(), g.layer_thickness.numpy(),
                    g.normal_velocity.numpy().reshape(6, ny2, nx, k))
    ref_dt = walk_dt = 0.0
    for s in (st1, st):
        ref, dd = structured_nl_adjoint_step(s, ref, sm, DT)
        ref_dt += float(dd)
        planes = (s.ssh.numpy(), s.layer_thickness.numpy(),
                  s.normal_velocity.numpy().reshape(6, ny2, nx, k))
        walk, dd = _walk_nl_adjoint_launch(planes, walk, sm, fv, scal, min(tile[0], ny2),
                                           min(tile[1], nx), live)
        walk_dt += dd
        assert not any(np.isnan(x).any() for x in walk)
    got = StructState(*(torch.from_numpy(x) for x in (walk[0], walk[1],
                                                      walk[2].reshape(3, 2, ny2, nx, k))))
    _close(got, ref, walk_dt, ref_dt)


# ---- planners, wrappers, refusals ------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
def test_nl_adjoint_plans_fit(itemsize):
    """nl_adjoint_plan at 64^2 and 256^2 x 100 levels: the plan fits a
    block's shared memory (nl_adjoint_smem_bytes, the kernel's own
    reckoning), gives every SM a block, takes the largest slice that fits,
    and over the tiles that divide the lattice (the tiled route's) picks the
    same plan; f32 (8, 8, 4) at both (the fastest plan of the sweep on an
    H100, PERF.md section 6), f64 (4, 4, 4); the reckoning counted by hand
    for one plan;
    tiled_adjoint_plan's nonlinear plan (q = 1)."""
    for n in (64, 256):
        ny2, nx = n // 2, n
        rt, ct, ks = adjoint_step.nl_adjoint_plan(ny2, nx, 100, itemsize)
        assert adjoint_step.nl_adjoint_smem_bytes((rt, ct), itemsize, ks) \
            <= fe_step.SMEM_BYTES
        assert ks == 16 or adjoint_step.nl_adjoint_smem_bytes(
            (rt, ct), itemsize, 2 * ks) > fe_step.SMEM_BYTES
        assert -(-ny2 // rt) * -(-nx // ct) * 7 >= fe_step.SMS
        dividing = [(r, c) for r in range(1, ny2 + 1) for c in range(1, nx + 1)
                    if ny2 % r == 0 and nx % c == 0]
        assert adjoint_step.nl_adjoint_plan(ny2, nx, 100, itemsize, dividing) == (rt, ct, ks)
        assert (rt, ct, ks) == {4: (8, 8, 4), 8: (4, 4, 4)}[itemsize]
        assert tiled_adjoint_plan(ny2, nx, 100, itemsize, 100, halo=(2, 4),
                                  nonlinear=True)[:3] == (rt, ct, 1)
    w, a, b, c = 12 * 20, 10 * 16, 8 * 12, 6 * 10
    vals = (16 * w + 12 * a + 14 * b + 8 * c) * 2 + 8 * w + 2 * 32
    assert adjoint_step.nl_adjoint_smem_bytes((4, 8), itemsize, 2) == \
        128 + itemsize * vals + 8 * w + 24 * c


def test_fe_nl_fill_stack_and_the_reverse_refuse_cpu_tensors(periodic8):
    """The nonlinear stack fill and the nonlinear reverse run on the card
    only: a CPU tensor raises before any build."""
    smp, st = periodic8[1], periodic8[3]
    sm = smp.struct_mesh
    stack = tuple(torch.stack([x, x]) for x in (st.ssh, st.layer_thickness, st.normal_velocity))
    fv = nl_setup(sm, torch.float64)
    scal = (*_scal(sm, DT, torch.float64), *nl_scal(sm, torch.float64))
    with pytest.raises(ValueError, match="CUDA device"):
        fe_step.fe_nl_fill_stack(stack, sm.resting_thickness_sum, *sm.host_stencil, fv,
                                 sm.vertex_cell_terms, sm.edge_vertex_terms, *scal, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        adjoint_step.nl_adjoint_rollout(
            stack, (st.ssh, st.layer_thickness, st.normal_velocity), fv, *sm.host_stencil,
            *sm.host_adjoint_stencil, sm.vertex_cell_terms, sm.edge_vertex_terms, *scal,
            *nl_adjoint_scal(sm, DT, torch.float64), 1, torch.zeros(1, dtype=torch.float64))


def test_a_mesh_without_vertex_constants_raises(periodic8):
    """A hand-built mesh without the vertex stencils refuses the nonlinear
    reverse on every entry point; the linear gradient needs none."""
    smp, st = periodic8[1], periodic8[3]
    bare = dataclasses.replace(smp.struct_mesh, vertex_cell_terms=(), edge_vertex_terms=(),
                               f_vertex=None)
    g = _cotangent(st, 1)
    with pytest.raises(ValueError, match="vertex stencils"):
        structured_nl_adjoint_step(st, g, bare, DT)
    for run in (fused_rollout_diff, tiled_rollout_diff, auto_rollout_diff):
        with pytest.raises(ValueError, match="vertex stencils"):
            run(st, bare, DT, 2, nonlinear=True)
    with pytest.raises(ValueError, match="vertex stencils"):
        fused_adjoint_rollout(st, bare, DT, 2, g, nonlinear=True)
    fused_rollout_diff(st, bare, DT, 2)
