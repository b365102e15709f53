"""The reverse kernels' window scheme (csrc/adjoint_window.cuh,
csrc/adjoint_step.cu, csrc/tiled_adjoint.cu), checked on the CPU:

* every lattice's transposed stencil table numbers and maps its sources as
  hex_adj:: lists them, and a reordered table does not;
* a numpy walk of adjoint_step's tile scheme, reading each source at the
  number the map gives it, against the plain adjoint step;
* the reverse planners and the size rule of ``auto_rollout_diff``;
* the f32 reverse against f64, the port's plain version beside ``jax.vjp``
  of the JAX package's step.

The CUDA arithmetic itself is checked on the card
(tests/test_torch_adjoint_kernel.py, tests/test_torch_tiled_adjoint_kernel.py,
chip_smoke.py).
"""

import dataclasses
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu_torch.constants import GRAVITY
from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
from mpas_ocean_tpu_torch.structured import (
    StructState,
    diff_model,
    struct_mesh_from_numpy,
    struct_state_from_numpy,
    structured_adjoint_run_loop,
    structured_run_loop,
    tiled_adjoint_plan,
    tiled_diff,
)
from mpas_ocean_tpu_torch.structured.fused_model import _scal

from torch_port_cases import (
    STATE_FIELDS,
    JaxStructuredModel,
    both_meshes,
    jax_lattice,
    jax_prog,
    jax_struct_mesh_dict,
    jax_struct_state_dict,
    max_rel_err,
)

DT = 10.0
DT_IGW = 30.0
CSRC = Path(mt.__file__).resolve().parent / "csrc"

# csrc/step_window.cuh's hex:: numbers of the site's own cells, the cells
# across its owned edges, its incoming edges' owner cells (h sources) and
# its incoming edges (u sources); csrc/adjoint_window.cuh's hex_adj:: number
# of the gu source each transposed Coriolis tap reads
_SELF_H = (0, 1)
_NB_H = (2, 3, 1, 4, 5, 6)
_INC_SELF_H = (7, 8, 9, 5, 0, 2)
_INC_U = (6, 7, 8, 9, 2, 10)
_ADJ_TAP_U = (11, 2, 7, 12, 10, 4, 8, 13, 2, 11, 14, 3, 10, 15, 16, 5,
              0, 6, 1, 9, 4, 10, 5, 8, 17, 18, 1, 9, 19, 10, 5, 16,
              0, 6, 9, 20, 2, 21, 22, 7, 18, 23, 1, 9, 24, 2, 3, 22)


def _adjoint_sources(table):
    """The reads of a packed transposed table, numbered in order of first
    use as csrc/adjoint_window.cuh's resolve_adjoint_taps numbers them:
    (gu sources, G sources) as (plane, dm, di) lists, with planes 0, 1 the
    cell parities and 2 + c edge channel c, and the number of each read:
    own channels, incoming edges, taps; own cells, neighbours, incoming
    edges' owners."""
    nbr, inc = table[1:19].reshape(6, 3), table[19:37].reshape(6, 3)
    taps = table[44:44 + 3 * table[0]].reshape(-1, 3)
    u_src, h_src = [], []

    def number(src, read):
        if read not in src:
            src.append(read)
        return src.index(read)

    u = [number(u_src, (2 + c, 0, 0)) for c in range(6)]
    u += [number(u_src, (2 + c, dm, di)) for c, dm, di in list(inc) + list(taps)]
    h = [number(h_src, (p, 0, 0)) for p in (0, 1)]
    h += [number(h_src, tuple(x)) for x in nbr]
    h += [number(h_src, (c & 1, dm, di)) for c, dm, di in inc]
    return u_src, h_src, u, h


def _maps_as_hex_adj(table) -> bool:
    """Whether a packed transposed table is one the reverse kernels take:
    8 taps per channel, and its reads number as hex:: and hex_adj:: list
    them, 25 gu sources and 10 G sources."""
    u_src, h_src, u, h = _adjoint_sources(table)
    want_u = list(range(6)) + list(_INC_U) + list(_ADJ_TAP_U)
    want_h = list(_SELF_H) + list(_NB_H) + list(_INC_SELF_H)
    return (table[0] == 48 and list(table[37:44]) == [8 * c for c in range(7)]
            and (u, len(u_src), h, len(h_src)) == (want_u, 25, want_h, 10))


def _lattice(nx, ny, k, dtype=np.float64):
    horz = mt.planar_hex_mesh(nx, ny, 1000.0, f0=1e-4, beta=1e-11, dtype=dtype)
    vert = mt.make_vertical_mesh(horz, k, dtype=dtype,
                                 resting_thickness=np.full((horz.n_cells, k), 10.0, dtype=dtype))
    return mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), nx, ny, device="cpu")


@pytest.mark.parametrize("nx, ny", [(6, 6), (10, 12), (16, 16), (64, 64)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_every_transposed_table_maps_as_the_reverse_kernels_take_it(nx, ny, dtype):
    """The reverse kernels take the hex lattice's transposed table only
    (their entries raise ValueError for any other): every uniform periodic
    lattice StructuredModel builds, in f32 and f64, has that table, carried
    to the host for the kernels; the same stencil with each channel's terms
    in reverse order does not map so."""
    sm = _lattice(nx, ny, 2, dtype).struct_mesh
    table, weights = sm.host_adjoint_stencil
    np.testing.assert_array_equal(table, sm.adjoint_table.numpy())
    np.testing.assert_array_equal(weights, sm.adjoint_weight.numpy().astype(np.float64))
    assert weights.dtype == np.float64 and _maps_as_hex_adj(table)
    d = mt.structured.struct_mesh_to_numpy(sm)
    d["coriolis_terms"] = tuple(reversed(sm.coriolis_terms))
    assert not _maps_as_hex_adj(mt.structured.struct_mesh_from_numpy(d).host_adjoint_stencil[0])


def _walk_adjoint_step(state, g, mesh, dt, tile):
    """One launch as csrc/adjoint_step.cu computes it, on numpy planes: per
    rt x ct tile (ragged at the lattice's edge), the wrapped window of
    (rt + 2) x (ct + 4) sites flattened; gs folded into gh (G); per core
    site and level the 25 gu, 10 G, 7 h and 11 u values read at the offsets
    their hex:: / hex_adj:: numbers give; S partials per level chunk added
    in rank order; d(dt) on the valid sites. Returns (ds, dh, du, d(dt),
    how often each site was written)."""
    ny2, nx = mesh.ny2, mesh.nx
    k = state.layer_thickness.shape[-1]
    table, w = mesh.host_adjoint_stencil
    dt_, inv_dc, s_div = _scal(mesh, dt, torch.float64)
    dt_div = dt_ * s_div
    u_src, h_src, *_ = _adjoint_sources(table)
    nbr = table[1:19].reshape(6, 3)
    ranks, kc = fe_step.level_split(k)
    rt, ct = tile
    hm, hi = adjoint_step.REACH
    wm, wi = rt + 2 * hm, ct + 2 * hi
    six = lambda x: x.numpy().reshape(6, ny2, nx, k)
    prim = np.concatenate([state.layer_thickness.numpy(), six(state.normal_velocity)])
    cot = np.concatenate([g.layer_thickness.numpy() + g.ssh.numpy()[..., None],
                          six(g.normal_velocity)])
    ssh, f_edge = state.ssh.numpy(), mesh.f_edge.numpy().reshape(6, ny2, nx)
    ds, dh, du = (np.full((2, ny2, nx), np.nan), np.full((2, ny2, nx, k), np.nan),
                  np.full((6, ny2, nx, k), np.nan))
    written = np.zeros((ny2, nx), dtype=int)
    ddt = 0.0
    for tm in range(-(-ny2 // rt)):
        for ti in range(-(-nx // ct)):
            gm = (tm * rt - hm + np.arange(wm)) % ny2
            gi = (ti * ct - hi + np.arange(wi)) % nx
            win = lambda x: x[:, gm[:, None], gi[None, :]].reshape(x.shape[0], wm * wi,
                                                                   *x.shape[3:])
            P, C, S, F = win(prim), win(cot), win(ssh), win(f_edge)
            r, c = (x.ravel() for x in np.meshgrid(np.arange(rt), np.arange(ct), indexing="ij"))
            s = (hm + r) * wi + hi + c
            valid = (tm * rt + r < ny2) & (ti * ct + c < nx)
            read = lambda X, src: X[src[0], s + src[1] * wi + src[2]]
            gu = [read(C, x) for x in u_src]
            gv = [read(C, x) for x in h_src]
            h = [read(P, x) for x in h_src[:7]]
            u = [read(P, x) for x in u_src[:11]]
            grad = [(S[n[0], s + n[1] * wi + n[2]] - S[ch & 1, s]) * inv_dc
                    for ch, n in enumerate(nbr)]
            out_h, out_u, out_s, dd = [None] * 2, [None] * 6, [None] * 2, 0.0
            for p in (0, 1):
                g_c, hc, flux = gv[_SELF_H[p]], h[_SELF_H[p]], 0.0
                for fam in range(3):
                    ch = fam * 2 + p
                    d_g = gv[_NB_H[ch]] - g_c
                    gflux = dt_div * d_g
                    he = 0.5 * (h[_NB_H[ch]] + hc)
                    c_t = sum(w[8 * ch + x] * gu[_ADJ_TAP_U[8 * ch + x]] for x in range(8))
                    fct = F[ch, s][:, None] * c_t
                    out_u[ch] = gu[ch] + he * gflux + dt_ * fct
                    flux = flux + u[ch] * gflux
                    dd = (dd + u[ch] * (s_div * d_g * he + fct)
                          - GRAVITY * grad[ch][:, None] * gu[ch])
                for x in range(3 * p, 3 * p + 3):
                    flux = flux + u[_INC_U[x]] * (dt_div * (g_c - gv[_INC_SELF_H[x]]))
                out_h[p] = g_c + 0.5 * flux
                lv = ((gu[p] + gu[2 + p] + gu[4 + p])
                      - (gu[_INC_U[3 * p]] + gu[_INC_U[3 * p + 1]] + gu[_INC_U[3 * p + 2]]))
                chunks = [lv[:, rank * kc:(rank + 1) * kc].sum(-1) for rank in range(ranks)]
                out_s[p] = (GRAVITY * dt_ * inv_dc) * sum(chunks[1:], chunks[0])
            ddt += float(dd[valid].sum())
            m, i = tm * rt + r[valid], ti * ct + c[valid]
            written[m, i] += 1
            ds[:, m, i] = np.stack(out_s)[:, valid]
            dh[:, m, i] = np.stack(out_h)[:, valid]
            du[:, m, i] = np.stack(out_u)[:, valid]
    return ds, dh, du.reshape(3, 2, ny2, nx, k), ddt, written


@pytest.mark.parametrize("shape, tile", [
    ((16, 16, 5), (4, 8)),    # the planner's tile at 100 f32 levels
    ((16, 16, 20), (3, 5)),   # ragged tiles in both directions; chunks of 4 levels
    ((12, 20, 5), (4, 16)),   # ragged columns
    ((8, 8, 5), (4, 8)),      # one tile; its 6 x 12 window wraps over the 4 x 8 lattice
])
def test_adjoint_step_tile_walk_matches_plain(shape, tile):
    """adjoint_step's tile scheme and source map, walked in numpy over 3
    reverse steps: every site written exactly once per step, <= 1e-12 of
    each field's magnitude and of d(dt) against the plain adjoint step."""
    sm, st = jax_lattice(*shape, seed=5)
    state = struct_state_from_numpy(jax_struct_state_dict(st))
    mesh = struct_mesh_from_numpy(jax_struct_mesh_dict(sm.struct_mesh))
    rng = np.random.default_rng(6)
    g = StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(state, f).shape)))
                      for f in STATE_FIELDS))
    states = [state]
    for _ in range(2):
        states.append(structured_run_loop(states[-1], mesh, DT, 1))
    cot, ddt = g, 0.0
    for s in reversed(states):
        ds, dh, du, dd, written = _walk_adjoint_step(s, cot, mesh, DT, tile)
        assert (written == 1).all()
        cot, ddt = StructState(*(torch.from_numpy(x) for x in (ds, dh, du))), ddt + dd
    ref, ref_dt = structured_adjoint_run_loop(state, mesh, DT, 3, g)
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(cot, f).numpy(), getattr(ref, f).numpy()) <= 1e-12, f
    assert abs(ddt - float(ref_dt)) <= 1e-12 * abs(float(ref_dt))


def _cu_constant(path: Path, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", path.read_text()).group(1))


def test_window_bytes_mirror_the_kernels():
    """The wrappers' shared-memory reckoning uses the sources' constants
    (the card's own reckoning is held against it by the GPU tests), and at
    q = 1 the two reverse kernels hold the same window."""
    threads = _cu_constant(CSRC / "step_window.cuh", "kStepThreads")
    assert "kRedDoubles = kStepThreads / 32" in (CSRC / "adjoint_window.cuh").read_text()
    assert adjoint_step._RED_BYTES == tiled_adjoint._RED_BYTES == 8 * (threads // 32)
    assert adjoint_step._PLANES == _cu_constant(CSRC / "adjoint_step.cu", "kPlanes")
    for tile, k, itemsize in (((4, 8), 100, 4), ((3, 5), 33, 8), ((8, 16), 4, 8)):
        sites = tiled_adjoint.window_sites(*tile, 1, adjoint_step.REACH)
        assert (adjoint_step.smem_bytes(tile, k, itemsize)
                == tiled_adjoint.smem_bytes(sites, tile[0] * tile[1], k, 1, itemsize))
    # (4, 8) at 100 f32 levels: 72 sites of 16 planes x 16 levels and 10
    # planes, 7 ranks' partial sums of 32 sites, the sites and their live
    # bits, the warps' sums
    assert adjoint_step.smem_bytes((4, 8), 100, 4) == (
        128 + 4 * (72 * (16 * 16 + 10) + 7 * 2 * 32) + 8 * 72)


@pytest.mark.parametrize("shape", [(128, 256, 100), (32, 64, 100), (8, 16, 4), (4, 8, 300)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_reverse_planners_fit(shape, itemsize):
    """adjoint_step's tile and the tiled adjoint's plan leave room for two
    blocks per SM where any tile does, else fit one; the tiled plan's tile
    divides the lattice, adjoint_step's need not. At 100 f32 levels the
    tiled plan takes (4, 8); adjoint_step takes (4, 8) where a larger tile
    would make fewer than MIN_WAVES waves of clusters (64x64) and (4, 12)
    where it makes more (256x256)."""
    ny2, nx, k = shape
    halo = tiled_diff.reverse_halo(_lattice(6, 6, 1).struct_mesh.coriolis_terms)
    tile = adjoint_step.adjoint_tile(ny2, nx, k, itemsize)
    need = adjoint_step.smem_bytes(tile, k, itemsize)
    assert tile[0] <= ny2 and tile[1] <= nx and need <= fe_step.SMEM_BYTES
    if adjoint_step.smem_bytes((1, 1), k, itemsize) <= fe_step.TWO_BLOCK_BYTES:
        assert need <= fe_step.TWO_BLOCK_BYTES
    rt, ct, q, _ = tiled_adjoint_plan(ny2, nx, k, itemsize, 10, halo=halo)
    window = tiled_diff.adjoint_window_bytes(rt, ct, q, halo, k, itemsize)
    assert q == 1 and ny2 % rt == 0 and nx % ct == 0 and window <= fe_step.SMEM_BYTES
    if tiled_diff.adjoint_window_bytes(1, 1, 1, halo, k, itemsize) <= fe_step.TWO_BLOCK_BYTES:
        assert window <= fe_step.TWO_BLOCK_BYTES
    if k == 100 and itemsize == 4:
        assert (rt, ct) == (4, 8)
        assert tile == {(32, 64): (4, 8), (128, 256): (4, 12)}[(ny2, nx)]
        clusters = -(-ny2 // tile[0]) * -(-nx // tile[1])
        waves = clusters * fe_step.level_split(k)[0] / (2 * adjoint_step.SMS)
        assert (waves >= adjoint_step.MIN_WAVES) == (tile != (4, 8))


def test_tiled_adjoint_level_split():
    """Power-of-two chunks at q = 1 (the 16-byte staging), the fewest levels
    per block at q > 1; never more than a cluster's 8 blocks."""
    assert tiled_adjoint.level_split(100, 1) == (7, 16)
    assert tiled_adjoint.level_split(100, 2) == (8, 13)
    assert tiled_adjoint.level_split(33, 2) == (7, 5)
    assert tiled_adjoint.level_split(4, 3) == (4, 1)
    for k in (1, 7, 33, 100, 300):
        for q in (1, 2):
            ranks, kc = tiled_adjoint.level_split(k, q)
            assert ranks <= fe_step.MAX_CLUSTER and (ranks - 1) * kc < k <= ranks * kc


@pytest.mark.parametrize("sites", [64 * 64, 128 * 128, 256 * 256, 2048 * 2048])
@pytest.mark.parametrize("threshold", [None, 128 * 128])
def test_auto_rollout_diff_routes_by_the_size_rule(monkeypatch, sites, threshold):
    """On the card, auto_rollout_diff takes the tiled reverse on lattices of
    at least TILED_REVERSE_SITES sites (2 ny2 nx) and the fused one below
    (its measured value routes none of these sizes to the tiled reverse; a
    finite threshold splits them); a CPU state takes the fused route at
    every size."""
    taken = []
    monkeypatch.setattr(diff_model, "fused_rollout_diff",
                        lambda *a, **kw: taken.append("fused"))
    monkeypatch.setattr(tiled_diff, "tiled_rollout_diff",
                        lambda *a, **kw: taken.append("tiled"))
    if threshold is not None:
        monkeypatch.setattr(diff_model, "TILED_REVERSE_SITES", threshold)
    mesh = SimpleNamespace(ny2=1, nx=sites // 2)
    for device in ("cuda", "cpu"):
        h = SimpleNamespace(device=SimpleNamespace(type=device))
        diff_model.auto_rollout_diff(StructState(None, h, None), mesh, DT, 4)
    big = threshold is not None and sites >= threshold
    assert taken == ["tiled" if big else "fused", "fused"]


def _f32_d_ssh_gaps(n_steps):
    """max |d_ssh(f32) - d_ssh(f64)| / max |d_ssh(f64)| of the grad of
    sum(ssh_final^2) over n_steps steps of 30 s on a 16x16x8 lattice (100 km
    cells, 1000 m deep: the IGW's scales) from a smooth wave that varies
    over the levels: the port's plain reverse (structured_adjoint_step back
    through its own forward) and jax.vjp of the JAX package's roll model,
    each in f32 against its own f64 run."""
    n, k = 16, 8
    mj, _ = both_meshes(n, n, k, dc=1e5, thickness=125.0)
    x = np.asarray(mj.horz.cells.x)
    h = 125.0 + np.cos(2 * np.pi * x / (n * 1e5))[:, None] * np.linspace(1.0, 0.5, k)
    ssh = h.sum(1) - np.asarray(mj.vert.resting_thickness_sum)
    sm = JaxStructuredModel(mj, n, n)
    st = sm.to_struct(jax_prog(ssh, h, np.zeros((mj.n_edges, k))))
    gaps = {}
    for name in ("port", "jax"):
        d_ssh = {}
        for dtype in (np.float64, np.float32):
            if name == "jax":
                to = lambda a: a.astype(dtype) if hasattr(a, "astype") else a
                mesh, state = jax.tree.map(to, sm.struct_mesh), jax.tree.map(to, st)
                out, vjp = jax.vjp(lambda s: jax_run_loop(s, mesh, DT_IGW, n_steps), state)
                g = dataclasses.replace(jax.tree.map(jnp.zeros_like, out), ssh=2 * out.ssh)
                d_ssh[dtype] = np.asarray(vjp(g)[0].ssh)
            else:
                md = {f: (v.astype(dtype) if isinstance(v, np.ndarray) else v)
                      for f, v in jax_struct_mesh_dict(sm.struct_mesh).items()}
                mesh = struct_mesh_from_numpy(md)
                state = struct_state_from_numpy(
                    {f: v.astype(dtype) for f, v in jax_struct_state_dict(st).items()})
                fin = structured_run_loop(state, mesh, DT_IGW, n_steps)
                g = StructState(2 * fin.ssh, torch.zeros_like(fin.layer_thickness),
                                torch.zeros_like(fin.normal_velocity))
                d, _ = structured_adjoint_run_loop(state, mesh, DT_IGW, n_steps, g)
                d_ssh[dtype] = d.ssh.numpy()
            assert np.isfinite(d_ssh[dtype]).all()
        gaps[name] = max_rel_err(d_ssh[np.float32], d_ssh[np.float64])
    return gaps


def test_f32_reverse_d_ssh_stays_within_twice_the_jax_packages_gap():
    """The f32 d_ssh of the port's plain reverse, against f64, over 100
    steps, is no more than twice as far off as the JAX package's own f32
    reverse (jax.vjp of its step) is from its f64 one: the port's f32
    rounding of S_e (the level sums of gu) is no worse than the
    reference's."""
    gaps = _f32_d_ssh_gaps(100)
    assert 0 < gaps["port"] <= 2 * gaps["jax"], gaps
