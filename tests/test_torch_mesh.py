"""The port's numpy mesh builders against the JAX package's: integer arrays
equal, floats within 1 ulp, same dtypes and static sizes."""

import numpy as np
import pytest

import mpas_ocean_tpu as mo
import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.mesh.vert_mesh import make_vertical_mesh as jax_make_vertical_mesh

from torch_port_cases import dataclass_arrays


def _assert_same(port, ref):
    a, b = dataclass_arrays(port), dataclass_arrays(ref)
    assert a.keys() == b.keys()
    for name in a:
        x, y = a[name], b[name]
        if not isinstance(y, np.ndarray):
            assert x == y, name
            continue
        assert isinstance(x, np.ndarray) and x.dtype == y.dtype, name
        assert x.shape == y.shape, name
        if np.issubdtype(y.dtype, np.integer):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_array_max_ulp(x, y, maxulp=1)


@pytest.mark.parametrize(
    "n, dtype", [(16, np.float64), (64, np.float64), (64, np.float32)]
)
def test_planar_hex_mesh_matches_jax(n, dtype):
    dc = 1.0e7 / n
    port = mt.planar_hex_mesh(n, n, dc, f0=1e-4, beta=1e-11, dtype=dtype)
    ref = mo.planar_hex_mesh(n, n, dc, f0=1e-4, beta=1e-11, dtype=dtype)
    _assert_same(port, ref)
    assert (port.lx, port.ly) == (ref.lx, ref.ly)


@pytest.mark.parametrize("n, k", [(16, 3), (64, 100)])
def test_vertical_mesh_matches_jax(n, k):
    port_h = mt.planar_hex_mesh(n, n, 1000.0)
    ref_h = mo.planar_hex_mesh(n, n, 1000.0)
    rng = np.random.default_rng(3)
    rt = rng.uniform(5.0, 15.0, size=(n * n, k))
    max_lc = rng.integers(1, k + 1, size=n * n).astype(np.int32)
    port = mt.make_vertical_mesh(port_h, k, resting_thickness=rt,
                                 max_level_cell=max_lc)
    ref = jax_make_vertical_mesh(ref_h, k, resting_thickness=rt,
                                 max_level_cell=max_lc)
    _assert_same(port, ref)


def test_jittered_voronoi_mesh_matches_jax():
    """A non-uniform generator set exercises the general Voronoi path
    (mixed cell degrees, signed kites)."""
    pts, lx, ly = mo.mesh.planar_hex.hex_lattice_points(12, 12, 1000.0)
    pts = pts + np.random.default_rng(5).uniform(-150.0, 150.0, size=pts.shape)
    pts = np.mod(pts, [lx, ly])
    port = mt.mesh.build_planar_trisk_mesh(pts, lx, ly, f0=1e-4)
    ref = mo.mesh.build_planar_trisk_mesh(pts, lx, ly, f0=1e-4)
    _assert_same(port, ref)


def test_builders_reject_bad_input():
    with pytest.raises(ValueError, match="9 generator points"):
        mt.mesh.build_planar_trisk_mesh(np.zeros((4, 2)), 1.0, 1.0)
    with pytest.raises(ValueError, match="ny must be even"):
        mt.planar_hex_mesh(8, 7, 1.0)
