"""The port's nonlinear (vector-invariant) core against the JAX package's, on
the CPU at f64 (numpy-seeded inputs): the vertex maps and stencils of
``HexLayout``, the vertex constants of ``StructuredModel`` (periodic and on
a culled channel), each operator, the roll model's FE and FB steps (with a
linear control that must miss the tolerance), the Pallas kernels in
interpret mode, the culled gather path, the port's windows and planners,
the kernels' schemes walked in numpy with their hex_vert:: maps read from
csrc/nl_step.cuh, volume on a channel, and the forward-backward gradient.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpas_ocean_tpu as mo
import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.forward.run_loop import ocn_run_loop
from mpas_ocean_tpu.structured import model as jm
from mpas_ocean_tpu.structured.hex_layout import HexLayout as JaxHexLayout
from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.pallas_model import (
    _nl_setup as jax_nl_setup,
    _reach as jax_reach,
    pallas_run_loop,
    pallas_tiled_run_loop,
)
from mpas_ocean_tpu_torch.constants import GRAVITY
from mpas_ocean_tpu_torch.kernels import fe_step
from mpas_ocean_tpu_torch.structured import model as pm
from mpas_ocean_tpu_torch.structured import (
    StructState,
    struct_mesh_from_numpy,
    struct_mesh_to_numpy,
    structured_auto_run_loop,
    structured_run_loop,
    tiled_run_loop,
)
from mpas_ocean_tpu_torch.structured.fused_model import _scal, kernel_live, nl_scal, nl_setup
from mpas_ocean_tpu_torch.structured.slab import derived_ring, reach, stencil_reach
from mpas_ocean_tpu_torch.structured.tiled_model import resolve_plan

from test_torch_tiled import _chunk_sums, _stencil_offsets
from torch_port_cases import STATE_FIELDS, nl_channel, nl_periodic

FIELDS = STATE_FIELDS
DT = 2.0


# ---- inputs ------------------------------------------------------------------

@pytest.fixture(scope="module")
def periodic8():
    return nl_periodic(8, 2)


@pytest.fixture(scope="module")
def channel8():
    return nl_channel(8, 2)


@pytest.fixture(scope="module")
def periodic16():
    return nl_periodic(16, 3)


@pytest.fixture(scope="module")
def channel16():
    return nl_channel(16, 2)


def _close(out, ref, tol=1e-12):
    """max |out - ref| over each field's scale (ssh: the column thickness,
    whose rounding it carries) <= tol; returns the worst ratio."""
    worst = 0.0
    for f in FIELDS:
        a = getattr(out, f).detach().double().numpy()
        b = np.asarray(getattr(ref, f), np.float64)
        scale = np.abs(np.asarray(ref.layer_thickness).sum(-1)).max() if f == "ssh" \
            else np.abs(b).max()
        err = float(np.abs(a - b).max() / scale)
        assert err <= tol, f"{f}: {err:.3e}"
        worst = max(worst, err)
    return worst


def _err(out, ref):
    return max(float(np.abs(getattr(out, f).double().numpy() - np.asarray(getattr(ref, f))).max()
                     / np.abs(np.asarray(getattr(ref, f))).max())
               for f in ("layer_thickness", "normal_velocity"))


# ---- layout and constants ------------------------------------------------------

@pytest.mark.parametrize("n", [8, 16])
def test_vertex_maps_and_stencils_match_jax(n):
    """vertex_of, vertex_owner, vertex_kind, the kite taps (partition of
    unity) and the endpoint taps equal the JAX HexLayout's, and
    vertices_to_struct / vertices_from_struct agree and invert."""
    hj, hp = mo.planar_hex_mesh(n, n, 1000.0, f0=1e-4), mt.planar_hex_mesh(n, n, 1000.0, f0=1e-4)
    lj, lp = JaxHexLayout(hj, n, n), mt.structured.HexLayout(hp, n, n)
    for name in ("vertex_of", "vertex_owner", "vertex_kind"):
        np.testing.assert_array_equal(getattr(lp, name), getattr(lj, name), err_msg=name)
    assert lp.edge_vertex_terms == lj.edge_vertex_terms
    assert len(lp.vertex_cell_terms) == len(lj.vertex_cell_terms) == 12
    for a, b in zip(lp.vertex_cell_terms, lj.vertex_cell_terms):
        assert a[:5] == b[:5] and abs(a[5] - b[5]) <= 1e-15
    f_v = np.random.default_rng(n).normal(size=(hp.n_vertices, 3))
    struct = lp.vertices_to_struct(f_v)
    assert struct.shape == (2, 2, n // 2, n, 3)
    np.testing.assert_array_equal(struct, lj.vertices_to_struct(f_v))
    np.testing.assert_array_equal(lp.vertices_from_struct(struct), f_v)


@pytest.mark.parametrize("case", ["periodic", "channel"])
def test_struct_mesh_vertex_constants_match_jax(case, periodic8, channel8):
    """f_vertex, and on the channel the live-renormalised kite planes and
    the vertex mask, equal the JAX StructuredModel's, and carry across as
    numpy both ways."""
    smj, smp = (periodic8 if case == "periodic" else channel8)[:2]
    sj, sp = smj.struct_mesh, smp.struct_mesh
    names = ["f_vertex"] + (["vertex_kite_planes", "vertex_mask"] if case == "channel" else [])
    for name in names:
        np.testing.assert_array_equal(getattr(sp, name).numpy(), np.asarray(getattr(sj, name)))
    if case == "periodic":
        assert sp.vertex_kite_planes is None and sp.vertex_mask is None
    else:
        vm = sp.vertex_mask.numpy()
        assert 0 < (vm == 0).sum() < vm.size  # dead vertices on the culled rows
    assert sp.vertex_cell_terms == sj.vertex_cell_terms
    assert sp.edge_vertex_terms == sj.edge_vertex_terms
    d = {f: getattr(sj, f) for f in ("nx", "ny2", "n_vert_levels", "coriolis_terms",
                                     "vertex_cell_terms", "edge_vertex_terms")}
    d.update({f: None if getattr(sj, f) is None else np.asarray(getattr(sj, f)) for f in (
        "dc", "dv", "area_cell", "f_edge", "resting_thickness_sum", "edge_mask", "cell_mask",
        "f_vertex", "vertex_kite_planes", "vertex_mask")})
    carried = struct_mesh_from_numpy(d)
    back = struct_mesh_to_numpy(carried)
    for name in names:
        assert torch.equal(getattr(carried, name), getattr(sp, name))
        np.testing.assert_array_equal(back[name], d[name])
    assert back["vertex_cell_terms"] == sj.vertex_cell_terms


@pytest.mark.parametrize("case", ["periodic", "channel"])
def test_nl_setup_matches_jax(case, periodic8, channel8):
    """The kernels' vertex operand: 4 f_vertex planes, or on a channel
    f_vertex, the vertex mask and the 12 kite planes (pallas_model._nl_setup)."""
    smj, smp = (periodic8 if case == "periodic" else channel8)[:2]
    _, want = jax_nl_setup(smj.struct_mesh, jnp.float64, True)
    got = nl_setup(smp.struct_mesh, torch.float64)
    assert got.is_contiguous() and tuple(got.shape) == (4 if case == "periodic" else 20, 4, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[..., 0])


# ---- operators and steps ------------------------------------------------------

_OPERATORS = {
    "kinetic_energy_cell": lambda mod, st, sm: mod.kinetic_energy_cell(st.normal_velocity, sm),
    "curl_on_vertex": lambda mod, st, sm: mod.curl_on_vertex(st.normal_velocity, sm),
    "cell_to_vertex_kite": lambda mod, st, sm: mod.cell_to_vertex_kite(st.layer_thickness, sm),
    "pv_on_vertex_struct": lambda mod, st, sm: mod.pv_on_vertex_struct(
        st.normal_velocity, st.layer_thickness, sm),
    "vertex_to_edge_mean": lambda mod, st, sm: mod.vertex_to_edge_mean(
        mod.curl_on_vertex(st.normal_velocity, sm), sm),
    "tangential_weights_only": lambda mod, st, sm: mod.tangential_weights_only(
        st.normal_velocity * st.layer_thickness[None], sm),
}


@pytest.mark.parametrize("case", ["periodic", "channel"])
@pytest.mark.parametrize("op", sorted(_OPERATORS))
def test_operator_matches_jax(op, case, periodic16, channel16):
    """Each nonlinear operator within 1e-13 of its JAX twin's magnitude (the
    channel's kite and PV with the masked vertex constants)."""
    smj, smp, st_j, st_p = (periodic16 if case == "periodic" else channel16)[:4]
    want = np.asarray(_OPERATORS[op](jm, st_j, smj.struct_mesh))
    got = _OPERATORS[op](pm, st_p, smp.struct_mesh).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


@pytest.mark.parametrize("case", ["periodic", "channel"])
@pytest.mark.parametrize("fb", [False, True])
def test_nonlinear_run_loop_matches_jax(fb, case, periodic16, channel16):
    """structured_run_loop(nonlinear=True), FE and FB, within 1e-12 of the
    JAX roll model's (20 steps); the linear run misses that by >= 100x."""
    smj, smp, st_j, st_p = (periodic16 if case == "periodic" else channel16)[:4]
    ref = jax_run_loop(st_j, smj.struct_mesh, DT, 20, nonlinear=True, fb=fb)
    _close(structured_run_loop(st_p, smp.struct_mesh, DT, 20, nonlinear=True, fb=fb), ref)
    linear = structured_run_loop(st_p, smp.struct_mesh, DT, 20, fb=fb)
    assert _err(linear, ref) >= 100 * 1e-12


def test_nonlinear_matches_the_pallas_kernels_in_interpret_mode(periodic8):
    """Once at 8x8x2: the port's roll model against the JAX package's fused
    kernel and its tiled kernel at q = 2 (interpret mode), nonlinear FE."""
    smj, smp, st_j, st_p = periodic8[:4]
    out = structured_run_loop(st_p, smp.struct_mesh, DT, 4, nonlinear=True)
    _close(out, pallas_run_loop(st_j, smj.struct_mesh, DT, 4, interpret=True, nonlinear=True))
    _close(out, pallas_tiled_run_loop(st_j, smj.struct_mesh, DT, 4, row_tile=2, interpret=True,
                                      q=2, nonlinear=True))


def test_channel_matches_the_culled_gather_path(channel16):
    """The masked nonlinear roll model against the JAX package's gather
    path on the culled mesh (as tests/test_nonlinear.py:276 holds the JAX
    package): u to 1e-13, ssh to 1e-12."""
    _, smp, _, st_p, mj, _ = channel16
    start = smp.from_struct(st_p)
    prog = mo.PrognosticVars(*(jnp.asarray(getattr(start, f).numpy()) for f in FIELDS))
    ref = ocn_run_loop(prog, mj.to_device(), DT, 8, nonlinear=True)
    out = smp.from_struct(structured_run_loop(st_p, smp.struct_mesh, DT, 8, nonlinear=True))
    assert np.abs(out.normal_velocity.numpy() - np.asarray(ref.normal_velocity)).max() < 1e-13
    assert np.abs(out.ssh.numpy() - np.asarray(ref.ssh)).max() < 1e-12


@pytest.mark.parametrize("fb", [False, True])
def test_volume_conserved_with_walls(channel16, fb):
    """The nonlinear channel's volume over 20 steps to 1e-12 relative, FE
    and FB; u on the walls stays exactly 0 and h on culled cells 0."""
    _, smp, _, st_p, _, mp = channel16
    sm = smp.struct_mesh
    out = structured_run_loop(st_p, sm, DT, 20, nonlinear=True, fb=fb)
    vol = lambda s: float(s.layer_thickness.sum())  # noqa: E731 (uniform cell areas)
    assert abs(vol(out) - vol(st_p)) < 1e-12 * vol(st_p)
    assert (out.normal_velocity[(sm.edge_mask == 0)[..., None].expand_as(out.normal_velocity)]
            == 0).all()
    assert (out.layer_thickness[(sm.cell_mask == 0)[..., None].expand_as(
        out.layer_thickness)] == 0).all()


def test_a_mesh_without_vertex_constants_raises(periodic8):
    """A hand-built periodic mesh without the vertex stencils refuses the
    nonlinear core on every entry point."""
    smp, st_p = periodic8[1], periodic8[3]
    bare = dataclasses.replace(smp.struct_mesh, vertex_cell_terms=(), edge_vertex_terms=(),
                               f_vertex=None)
    for run in (structured_run_loop, structured_auto_run_loop, tiled_run_loop):
        with pytest.raises(ValueError, match="vertex stencils"):
            run(st_p, bare, DT, 2, nonlinear=True)
    structured_run_loop(st_p, bare, DT, 2)  # the linear core needs none


@pytest.mark.parametrize("nonlinear, tracers, strat",
                         [pytest.param(False, False, False, id="False"),
                          pytest.param(True, False, False, id="True"),
                          pytest.param(False, True, False, id="tracers"),
                          pytest.param(False, False, True, id="strat")])
def test_fb_gradient_matches_jax_grad(nonlinear, tracers, strat, periodic8):
    """The forward-backward gradient: torch.autograd through the plain
    structured_run_loop(fb=True) against jax.grad of the JAX package's, the
    objective sum ssh^2 over 6 steps (with ``tracers``, two tracers carried
    with kappa 5 and upwind 0.5 and sum T^2 added; with ``strat``, a dense
    random W of the layered stratification), w.r.t. the state (its tracers
    among it), dt and W, to 1e-12."""
    from mpas_ocean_tpu.models.stratification import Stratification as JaxStratification

    smj, smp, st_j, st_p = periodic8[:4]
    fields, kw = FIELDS, {}
    if tracers:
        from test_torch_tracers import tracer_lattice

        smj, smp, st_j, st_p = tracer_lattice(8, 2)[:4]
        fields, kw = FIELDS + ("tracers",), dict(tracer_kappa=5.0, tracer_upwind=0.5)
    k = st_p.layer_thickness.shape[-1]
    w0 = 0.05 * np.random.default_rng(13).normal(size=(k, k))
    rho = np.full(k, 1025.0)

    def objective(out, total):
        return total(out.ssh ** 2) + (total(out.tracers ** 2) if tracers else 0.0)

    def jax_obj(s, t, w):
        sw = JaxStratification(phi_weights=w, densities=jnp.asarray(rho)) if strat else None
        return objective(jax_run_loop(s, smj.struct_mesh, t, 6, nonlinear=nonlinear, fb=True,
                                      strat=sw, **kw), jnp.sum)

    g_j, gdt_j, gw_j = jax.grad(jax_obj, argnums=(0, 1, 2))(st_j, jnp.float64(DT),
                                                            jnp.asarray(w0))
    leaves = [getattr(st_p, f).clone().requires_grad_(True) for f in fields]
    t = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    w = torch.tensor(w0, requires_grad=True)
    sp = mt.models.Stratification(w, torch.from_numpy(rho)) if strat else None
    obj = objective(structured_run_loop(StructState(*leaves), smp.struct_mesh, t, 6,
                                        nonlinear=nonlinear, fb=True, strat=sp, **kw), torch.sum)
    # FB reads no ssh (it takes the pressure of the fresh one): its gradient is 0
    grads = torch.autograd.grad(obj, [*leaves, t, w], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, [*leaves, t, w])]
    for got, f in zip(grads, fields):
        want = np.asarray(getattr(g_j, f))
        assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max(), f
    assert abs(float(grads[-2]) - float(gdt_j)) <= 1e-12 * abs(float(gdt_j))
    if strat:
        want = np.asarray(gw_j)
        assert np.abs(want).max() > 0
        assert np.abs(grads[-1].numpy() - want).max() <= 1e-12 * np.abs(want).max()


# ---- windows and planners ------------------------------------------------------

def test_nonlinear_reach():
    """The nonlinear step reaches 2 rows (FE) and 3 (FB), as
    pallas_model._reach, and 4 columns, with derived planes on a (1, 2)
    (FE) or (2, 2) (FB) ring: the reach and ring the kernels take
    (fe_step.NL_REACH, NL_RING)."""
    hp = mt.planar_hex_mesh(8, 8, 1000.0, f0=1e-4)
    lay = mt.structured.HexLayout(hp, 8, 8)
    terms = tuple((t.f_out, t.p_out, t.f_in, t.p_in, t.dm, t.di, t.w) for t in lay.coriolis_terms)
    nl_terms = (lay.vertex_cell_terms, lay.edge_vertex_terms)
    for fb in (False, True):
        assert stencil_reach(terms, fb, nl_terms) == fe_step.NL_REACH[fb] == (reach(fb, True), 4)
        assert reach(fb, True) == jax_reach(True, fb)
        assert derived_ring(terms, fb) == fe_step.NL_RING[fb]


@pytest.fixture(scope="module")
def lattices32():
    """32x32x2, periodic and channel: room for q = 2 windows (a window may
    not exceed the lattice's 16 rows)."""
    return {"periodic": nl_periodic(32, 2), "channel": nl_channel(32, 2)}


@pytest.mark.parametrize("case, n, fb, plan", [
    ("periodic", 16, False, (4, 8, 1)), ("periodic", 16, True, (4, 16, 1)),
    ("periodic", 32, False, (4, 8, 2)), ("periodic", 32, True, (4, 8, 2)),
    ("channel", 16, False, (2, 8, 1)), ("channel", 16, True, (4, 4, 1)),
    ("channel", 32, True, (2, 8, 2)),
])
def test_nonlinear_windows_match_the_roll(case, n, fb, plan, periodic16, channel16, lattices32):
    """tiled_run_loop(nonlinear=True) on a CPU state (the tiled kernel's
    plain version, slab.window_steps) for several plans, q = 2 among them,
    within 1e-12 of the roll model's 8 steps (reach 2 for FE, 3 for FB)."""
    small = periodic16 if case == "periodic" else channel16
    _, smp, _, st_p = (small if n == 16 else lattices32[case])[:4]
    sm = smp.struct_mesh
    rt, ct, q = plan
    assert resolve_plan(sm.ny2, sm.nx, st_p.layer_thickness.shape[-1], 8,
                        stencil_reach(sm.coriolis_terms, fb, (sm.vertex_cell_terms,
                                                            sm.edge_vertex_terms)),
                        8, rt, ct, q) == plan
    out = tiled_run_loop(st_p, sm, DT, 8, row_tile=rt, col_tile=ct, q=q, nonlinear=True, fb=fb)
    ref = structured_run_loop(st_p, sm, DT, 8, nonlinear=True, fb=fb)
    _close(out, ref)


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_nonlinear_plans_fit(fb, itemsize):
    """The nonlinear arms' planner at 64^2 and 256^2 x 100 levels: the
    plan fits a block's shared memory (nl_smem_bytes, the kernels' own
    reckoning) and leaves no SM of the card without a block, the slice is
    the largest that fits, and over the tiles that divide the lattice (the
    tiled route's candidates) it picks the same plan; at f32 the plans the
    sweep on an H100 chose (PERF.md section 6); and the reckoning's terms
    for one plan, counted by hand."""
    for n in (64, 256):
        ny2, nx = n // 2, n
        rt, ct, ks = fe_step.nl_plan(ny2, nx, 100, itemsize, fb)
        assert fe_step.nl_smem_bytes((rt, ct), 100, itemsize, fb, ks) <= fe_step.SMEM_BYTES
        assert ks == 16 or fe_step.nl_smem_bytes((rt, ct), 100, itemsize, fb, 2 * ks) \
            > fe_step.SMEM_BYTES
        assert -(-ny2 // rt) * -(-nx // ct) * 7 >= fe_step.SMS
        assert ny2 % rt == 0 and nx % ct == 0
        dividing = [(r, c) for r in range(1, ny2 + 1) for c in range(1, nx + 1)
                    if ny2 % r == 0 and nx % c == 0]
        assert fe_step.nl_plan(ny2, nx, 100, itemsize, fb, dividing) == (rt, ct, ks)
        if itemsize == 4:
            assert (rt, ct, ks) == {
                (False, 64): (4, 16, 8), (False, 256): (8, 16, 4),
                (True, 64): (8, 8, 4), (True, 256): (8, 8, 4)}[fb, n]
    (hm, hi), (dr, dc) = fe_step.NL_REACH[fb], fe_step.NL_RING[fb]
    w, d, f = (4 + 2 * hm) * (8 + 2 * hi), (4 + 2 * dr) * (8 + 2 * dc), 6 * 10
    vals = 16 * w * 4 + 20 * d * 4 + 24 * w + 2 * (f if fb else 32) + (2 * f + 6 * 32 * 16
                                                                          if fb else 0)
    assert fe_step.nl_smem_bytes((4, 8), 100, itemsize, fb, 4) == itemsize * vals + 8 * w


# ---- the kernels' schemes, walked in numpy --------------------------------------

_CUH = Path(mt.__file__).parent / "csrc" / "nl_step.cuh"


def _cuh_maps() -> dict:
    """csrc/nl_step.cuh's hex_vert:: constant maps, read from the source:
    {function name: int array}."""
    text = _CUH.read_text()
    out = {}
    for name, shape, body in re.findall(
            r"constexpr int (\w+)\([^)]*\) \{\s*constexpr int m((?:\[\w+\])+) = (\{.*?\});",
            text, re.S):
        out[name] = np.array([int(x) for x in re.findall(r"-?\d+", body)])
    sizes = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    for name in ("vc_tap", "ev_tap", "u_src", "h_src", "v_src", "curl_u", "kite_t", "kite_h"):
        out[name] = out[name].reshape(-1, {"vc_tap": 5, "ev_tap": 6}.get(name, 3))
    assert int(sizes["kU"]) == len(out["u_src"]) and int(sizes["kV"]) == len(out["v_src"])
    return out


@pytest.mark.parametrize("n, dtype", [(6, np.float64), (10, np.float32), (16, np.float64),
                                      (64, np.float32)])
def test_vertex_tables_map_as_the_nonlinear_kernels_take_them(n, dtype):
    """The nonlinear arms take the hex lattice's vertex tables only (their
    entries raise ValueError for others): every lattice's kite and endpoint
    taps equal hex_vert::'s, and the sources hex_vert:: numbers (u, h and
    the endpoint vertices, in order of first use) and its curl, kite and
    endpoint maps are what those taps read."""
    hp = mt.planar_hex_mesh(n, n, 1000.0, f0=1e-4, dtype=dtype)
    lay = mt.structured.HexLayout(hp, n, n)
    hv = _cuh_maps()
    vc, vc_w, ev = fe_step.vertex_tables(lay.vertex_cell_terms, lay.edge_vertex_terms)
    np.testing.assert_array_equal(vc, hv["vc_tap"])
    np.testing.assert_array_equal(ev, hv["ev_tap"])
    np.testing.assert_allclose(vc_w, 1.0 / 3.0, rtol=1e-14)
    u_src, h_src, v_src = [], [], []

    def number(src, read):
        if read not in src:
            src.append(read)
        return src.index(read)

    nbr = mt.structured.stencils.NEIGHBOR
    inc = mt.structured.stencils.INCOMING
    assert [number(u_src, (c, 0, 0)) for c in range(6)] == list(range(6))
    assert [number(h_src, (p, 0, 0)) for p in (0, 1)] == [0, 1]
    assert [number(h_src, nbr[divmod(c, 2)]) for c in range(6)] == list(hv["nb_h"])
    assert [number(u_src, t) for p in (0, 1) for t in inc[p]] == list(hv["inc_u"])
    assert [number(v_src, (t[2] * 2 + t[3], t[4], t[5])) for t in ev] == list(hv["ev_v"])
    for v, (cls, dm, di) in enumerate(v_src):
        kind, p = divmod(cls, 2)
        if kind == 0:  # u_NE - u_E(NW) - u_NW
            reads = [(2 + p, 0, 0), (1, 0, -1) if p == 0 else (0, 1, 0), (4 + p, 0, 0)]
        else:          # u_E + u_NW(E) - u_NE
            reads = [(p, 0, 0), (4 + p, 0, 1), (2 + p, 0, 0)]
        assert [number(u_src, (c, dm + a, di + b)) for c, a, b in reads] == list(hv["curl_u"][v])
        taps = [t for t, x in enumerate(vc) if x[0] * 2 + x[1] == cls]
        assert taps == list(hv["kite_t"][v])
        assert [number(h_src, (vc[t][2], dm + vc[t][3], di + vc[t][4])) for t in taps] == list(
            hv["kite_h"][v])
    assert (u_src, h_src, v_src) == ([tuple(x) for x in hv["u_src"]],
                                     [tuple(x) for x in hv["h_src"]],
                                     [tuple(x) for x in hv["v_src"]])


def _walk_nl_launch(ssh, h, u, rts, fv, table, w, kw, scal, rt, ct, fb, split, ks, live=None):
    """One launch of the nonlinear step as csrc/nl_step.cuh computes it, on
    numpy planes: per tile (ragged ones skipped past the lattice's edge),
    the wrapped window; stage A on the tile plus its ring from the window's
    flattened site offsets through hex_vert::'s maps (read from the
    source); stage B from the derived planes at the table's offsets in the
    ring's geometry; FB's fresh continuity on the tile plus one ring; the
    column sums per slice of ks lanes, added over the slices and then the
    ranks (``split`` = (ranks, kc)) in order; u' = 0 on masked channels
    (``live``). ssh (2, ny2, nx), h (2, ny2, nx, K), u (6, ny2, nx, K), rts
    (2, ny2, nx), fv (4 or 20, ny2, nx)."""
    dt, inv_dc, s_div, s_ke, s_curl = scal
    hv = _cuh_maps()
    _, ny2, nx, k = h.shape
    (hm, hi), (dr, dc) = fe_step.NL_REACH[fb], fe_step.NL_RING[fb]
    wm, wi, di_ = rt + 2 * hm, ct + 2 * hi, ct + 2 * dc
    n_d, fi = (rt + 2 * dr) * di_, ct + 2
    nbr, inc, off, taps, *_ = _stencil_offsets(table, 0)
    masked = fv.shape[0] == 20
    ranks, kc = split
    out = [np.full_like(x, np.nan) for x in (ssh, h, u)]

    def column(hn):  # (..., K) -> (...), in the kernel's order
        col = None
        for rank in range(ranks):
            part = None
            for k0 in range(rank * kc, min(k, (rank + 1) * kc), ks):
                s = _chunk_sums(hn[..., k0:min(k0 + ks, (rank + 1) * kc, k)], ks, ks)
                part = s if part is None else part + s
            col = part if col is None else col + part
        return col

    for tm in range(-(-ny2 // rt)):
        for ti in range(-(-nx // ct)):
            gm = (tm * rt - hm + np.arange(wm)) % ny2
            gi = (ti * ct - hi + np.arange(wi)) % nx
            win = lambda x: x[:, gm[:, None], gi[None, :]].reshape(x.shape[0], wm * wi,  # noqa
                                                                   *x.shape[3:])
            cur, ssh_w, rts_w, fv_w = np.concatenate([win(h), win(u)]), win(ssh), win(rts), win(fv)
            live_w = None if live is None else win(live[None])[0]
            # stage A on the ring's sites
            d = np.arange(n_d)
            sw = (d // di_ + hm - dr) * wi + d % di_ + hi - dc
            us = [cur[2 + c, sw + a * wi + b] for c, a, b in hv["u_src"]]
            hs = [cur[p, sw + a * wi + b] for p, a, b in hv["h_src"]]
            flux = [us[c] * (0.5 * (hs[hv["nb_h"][c]] + hs[c & 1])) for c in range(6)]
            ke = []
            for p in (0, 1):
                tot = us[p] * us[p] + us[2 + p] * us[2 + p] + us[4 + p] * us[4 + p]
                for x in range(3 * p, 3 * p + 3):
                    tot = tot + us[hv["inc_u"][x]] ** 2
                ke.append(tot * s_ke)
            qv = []
            for v, (cls, a, b) in enumerate(hv["v_src"]):
                sv = sw + a * wi + b
                cu = [us[i] for i in hv["curl_u"][v]]
                zeta = ((cu[0] - cu[1]) - cu[2] if cls < 2 else (cu[0] + cu[1]) - cu[2]) * s_curl
                hsum = 0.0
                for t, i in zip(hv["kite_t"][v], hv["kite_h"][v]):
                    wgt = fv_w[8 + t, sv][:, None] if masked else kw[t]
                    hsum = hsum + wgt * hs[i]
                num = fv_w[cls, sv][:, None] + zeta
                if masked:
                    vm = fv_w[4 + cls, sv][:, None]
                    qv.append(num / np.where(vm > 0, hsum, 1.0) * vm)
                else:
                    qv.append(num / hsum)
            qe = [0.5 * (qv[hv["ev_v"][2 * c]] + qv[hv["ev_v"][2 * c + 1]]) for c in range(6)]
            dsm = np.stack(flux + [flux[c] * qe[c] for c in range(6)] + qe + ke)  # (20, D, K)

            def sites(r0, r1, c0, c1):
                r, c = np.meshgrid(np.arange(r0, r1), np.arange(c0, c1), indexing="ij")
                return r.ravel(), c.ravel()

            def continuity(r, c):
                s, dd = (hm + r) * wi + hi + c, (dr + r) * di_ + dc + c
                hn = []
                for p in (0, 1):
                    total = dsm[p, dd] + dsm[2 + p, dd] + dsm[4 + p, dd]
                    for x in range(3 * p, 3 * p + 3):
                        total = total - dsm[inc[x, 0], dd + inc[x, 1] * di_ + inc[x, 2]]
                    hn.append(cur[p, s] - (dt * s_div) * total)
                return np.stack(hn)

            r, c = sites(0, rt, 0, ct)
            s, dd = (hm + r) * wi + hi + c, (dr + r) * di_ + dc + c
            if fb:  # the fresh h and ssh on the tile plus one ring
                rf, cf = sites(-1, rt + 1, -1, ct + 1)
                sf = (hm + rf) * wi + hi + cf
                h_ring = continuity(rf, cf)
                pg = column(h_ring) - rts_w[:, sf]
                h_new = h_ring[:, ((rf >= 0) & (rf < rt) & (cf >= 0) & (cf < ct))]
                ssh_new = pg[:, (r + 1) * fi + c + 1]
                at, pw, pi = (r + 1) * fi + c + 1, (rt + 2) * fi, fi
            else:
                h_new = continuity(r, c)
                ssh_new = column(h_new) - rts_w[:, s]
                pg, at, pw, pi = ssh_w, s, wm * wi, wi
            u_new = []
            for ch in range(6):
                tf = tfq = 0.0
                for t in range(off[ch], off[ch + 1]):
                    src = dd + taps[t, 1] * di_ + taps[t, 2]
                    tf = tf + w[t] * dsm[taps[t, 0], src]
                    tfq = tfq + w[t] * dsm[6 + taps[t, 0], src]
                pv = 0.5 * (dsm[12 + ch, dd] * tf + tfq)
                gke = (dsm[18 + nbr[ch, 0], dd + nbr[ch, 1] * di_ + nbr[ch, 2]]
                       - dsm[18 + (ch & 1), dd]) * inv_dc
                nb_p = nbr[ch, 0] * pw + nbr[ch, 1] * pi + nbr[ch, 2]
                grad = (pg.reshape(-1)[at + nb_p] - pg[ch & 1, at]) * inv_dc
                un = cur[2 + ch, s] + dt * (pv - gke) + (-GRAVITY * dt) * grad[:, None]
                if live_w is not None:
                    un = np.where(((live_w[s] >> ch) & 1)[:, None] == 1, un, 0.0)
                u_new.append(un)
            lm, li = tm * rt + r, ti * ct + c
            keep = (lm < ny2) & (li < nx)
            out[0][:, lm[keep], li[keep]] = ssh_new[:, keep]
            out[1][:, lm[keep], li[keep]] = h_new[:, keep]
            out[2][:, lm[keep], li[keep]] = np.stack(u_new)[:, keep]
    return out


@pytest.mark.parametrize("case, fb, tile, split, ks", [
    ("periodic", False, (4, 8), None, 4),
    ("periodic", False, (3, 5), (2, 2), 1),     # ragged tiles, slices of one level
    ("periodic", False, (8, 16), (1, 4), 2),    # the tile is the whole lattice; windows wrap
    ("periodic", True, (4, 4), None, 2),
    ("periodic", True, (2, 8), (2, 2), 2),
    ("channel", False, (2, 8), (2, 1), 1),
    ("channel", True, (4, 8), None, 2),
])
def test_nonlinear_kernel_walk_matches_plain(case, fb, tile, split, ks, periodic16, channel16):
    """The nonlinear step's scheme (csrc/nl_step.cuh; fe_step's FE arm with
    ragged tiles, tiled_step's FE and FB arms), walked in numpy (the CUDA
    arithmetic itself is checked on the card, tests/test_torch_kernel.py,
    tests/test_torch_tiled_kernel.py and chip_smoke.py phase 12): 4 steps
    on 16x16, every site written, within 1e-12 of the plain roll model's.
    ``split`` (ranks, kc) and ks run the column sums over other level chunks
    and slices."""
    _, smp, _, st_p = (periodic16 if case == "periodic" else channel16)[:4]
    sm = smp.struct_mesh
    ny2, nx, k = sm.ny2, sm.nx, st_p.layer_thickness.shape[-1]
    table, w = sm.host_stencil
    _, kw, _ = fe_step.vertex_tables(sm.vertex_cell_terms, sm.edge_vertex_terms)
    live = None if case == "periodic" else kernel_live(sm).numpy()
    scal = (*_scal(sm, DT, torch.float64), *nl_scal(sm, torch.float64))
    fields = (st_p.ssh.numpy(), st_p.layer_thickness.numpy(),
              st_p.normal_velocity.numpy().reshape(6, ny2, nx, k))
    for _ in range(4):
        fields = _walk_nl_launch(*fields, sm.resting_thickness_sum.numpy(),
                                 nl_setup(sm, torch.float64).numpy(), table, w, kw, scal,
                                 min(tile[0], ny2), min(tile[1], nx), fb,
                                 split or fe_step.level_split(k), ks, live)
        assert not any(np.isnan(x).any() for x in fields)
    ref = structured_run_loop(st_p, sm, DT, 4, nonlinear=True, fb=fb)
    got = StructState(*(torch.from_numpy(x) for x in (
        fields[0], fields[1], fields[2].reshape(3, 2, ny2, nx, k))))
    _close(got, ref)
    if live is not None:
        closed = (sm.edge_mask == 0)[..., None].expand_as(got.normal_velocity)
        assert (got.normal_velocity[closed] == 0).all()

