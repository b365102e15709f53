"""mpas_ocean_tpu_torch — the PyTorch and CUDA port of mpas_ocean_tpu.

The TRiSK shallow-water core on uniform periodic hex lattices, run on an
NVIDIA H100 through hand-written CUDA kernels (``csrc/``, built with nvcc at
first use by ``kernels/build.py``), with plain PyTorch versions of every
kernel for the CPU. The JAX package ``mpas_ocean_tpu`` is the reference the
port is tested against; this package never imports JAX.

Main path: ``planar_hex_mesh`` + ``make_vertical_mesh`` +
``InertialGravityWave.initial_state`` -> ``StructuredModel(mesh, nx, ny)``
-> ``to_struct`` -> ``structured_auto_run_loop`` -> ``from_struct``.
Device and dtype are explicit: the state's device picks the kernel (CUDA)
or the plain version (CPU).
"""

from .constants import GRAVITY
from .mesh import (
    DualCells,
    Edges,
    HorzMesh,
    Mesh,
    PrimaryCells,
    VerticalMesh,
    make_vertical_mesh,
    planar_hex_mesh,
)
from .models import PrognosticVars
from .structured import (
    StructuredModel,
    fused_run_loop,
    structured_auto_run_loop,
    structured_run_loop,
)
from .utils import error_measures
from .verification import InertialGravityWave

__all__ = [
    "GRAVITY",
    "DualCells",
    "Edges",
    "HorzMesh",
    "InertialGravityWave",
    "Mesh",
    "PrimaryCells",
    "PrognosticVars",
    "StructuredModel",
    "VerticalMesh",
    "error_measures",
    "fused_run_loop",
    "make_vertical_mesh",
    "planar_hex_mesh",
    "structured_auto_run_loop",
    "structured_run_loop",
]
