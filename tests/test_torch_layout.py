"""The port's HexLayout and StructuredModel constants against the JAX
package's: Coriolis stencil, edge maps and sign flips, field round trips."""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu.structured.hex_layout import HexLayout as JaxHexLayout
from mpas_ocean_tpu.structured.model import StructuredModel as JaxStructuredModel
from mpas_ocean_tpu_torch.kernels.fe_step import pack_stencil
from mpas_ocean_tpu_torch.structured import HexLayout, StructuredModel
from mpas_ocean_tpu_torch.structured.stencils import INCOMING, NEIGHBOR

from torch_port_cases import (
    both_meshes,
    jax_prog,
    port_prog,
    random_state,
)


@pytest.fixture(scope="module", params=[(8, 8), (10, 12)])
def layouts(request):
    nx, ny = request.param
    mj, mp = both_meshes(nx, ny, 2)
    return nx, ny, mj, mp, JaxHexLayout(mj.horz, nx, ny), HexLayout(mp.horz, nx, ny)


def test_coriolis_stencil_matches_jax(layouts):
    *_, ref, port = layouts
    assert [vars(t) for t in port.coriolis_terms] == [
        vars(t) for t in ref.coriolis_terms
    ]
    # 10 taps per edge class less the two zero-weight cell-opposite taps
    assert len(port.coriolis_terms) == 48


def test_edge_maps_match_jax(layouts):
    *_, ref, port = layouts
    for name in ("edge_of", "edge_flip", "edge_owner", "edge_family"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))


def test_struct_round_trips_match_jax(layouts):
    nx, ny, mj, mp, ref, port = layouts
    rng = np.random.default_rng(11)
    cells = rng.normal(size=(nx * ny, 3))
    edges = rng.normal(size=(3 * nx * ny, 3))
    np.testing.assert_array_equal(port.cells_to_struct(cells), ref.cells_to_struct(cells))
    for sign in (False, True):
        s = port.edges_to_struct(edges, sign=sign)
        np.testing.assert_array_equal(s, ref.edges_to_struct(edges, sign=sign))
        np.testing.assert_array_equal(port.edges_from_struct(s, sign=sign), edges)
    np.testing.assert_array_equal(
        port.cells_from_struct(port.cells_to_struct(cells)), cells
    )


def test_structured_model_matches_jax(layouts):
    nx, ny, mj, mp, *_ = layouts
    ref = JaxStructuredModel(mj, nx, ny)
    port = StructuredModel(mp, nx, ny, device="cpu")
    sm = port.struct_mesh
    assert sm.coriolis_terms == ref.struct_mesh.coriolis_terms
    for name in ("dc", "dv", "area_cell", "f_edge", "resting_thickness_sum"):
        got = getattr(sm, name).numpy()
        want = np.asarray(getattr(ref.struct_mesh, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    ssh, h, u = random_state(mj, seed=2)
    st_p = port.to_struct(port_prog(ssh, h, u))
    st_j = ref.to_struct(jax_prog(ssh, h, u))
    for name in ("ssh", "layer_thickness", "normal_velocity"):
        np.testing.assert_array_equal(
            getattr(st_p, name).numpy(), np.asarray(getattr(st_j, name))
        )
    back = port.from_struct(st_p)
    np.testing.assert_array_equal(back.normal_velocity.numpy(), u)
    np.testing.assert_array_equal(back.layer_thickness.numpy(), h)
    # buffers follow the module: .to(dtype) casts the float ones
    assert port.to(torch.float32).struct_mesh.f_edge.dtype == torch.float32
    assert port.stencil_table.dtype == torch.int32


def test_pack_stencil_layout():
    """The kernel's table (layout in csrc/fe_step.cu): header, neighbour and
    incoming taps, per-channel offsets, and terms grouped by output channel
    in their original order."""
    terms = [
        (1, 0, 2, 1, -1, 0, 0.5),
        (0, 1, 1, 0, 0, 1, -0.25),
        (1, 0, 0, 0, 1, -1, 0.125),
        (0, 0, 2, 0, 0, 0, 2.0),
    ]
    table, w = pack_stencil(terms)
    assert table.dtype == np.int32 and table.size == 44 + 3 * 4
    assert table[0] == 4
    assert table[1:19].reshape(6, 3).tolist() == [
        list(NEIGHBOR[(c // 2, c % 2)]) for c in range(6)
    ]
    assert table[19:37].reshape(6, 3).tolist() == [
        list(t) for p in (0, 1) for t in INCOMING[p]
    ]
    # channels 0 (E,0), 1 (E,1), 2 (NE,0) x2, then none
    assert table[37:44].tolist() == [0, 1, 2, 4, 4, 4, 4]
    assert table[44:].reshape(4, 3).tolist() == [
        [4, 0, 0], [2, 0, 1], [5, -1, 0], [0, 1, -1]
    ]
    assert w.tolist() == [2.0, -0.25, 0.5, 0.125]
    with pytest.raises(ValueError, match="Coriolis terms"):
        pack_stencil(terms * 40)
