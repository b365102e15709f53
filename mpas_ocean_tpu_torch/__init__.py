"""mpas_ocean_tpu_torch — the PyTorch and CUDA port of mpas_ocean_tpu.

The TRiSK shallow-water core on uniform hex lattices, periodic or coastal
channels culled from them (``cull_cells``, ``KelvinWave``), run on an
NVIDIA H100 through hand-written CUDA kernels (``csrc/``, built with nvcc at
first use by ``kernels/build.py``), with plain PyTorch versions of every
kernel for the CPU. The JAX package ``mpas_ocean_tpu`` is the reference the
port is tested against; this package never imports JAX.

Main path: ``planar_hex_mesh`` + ``make_vertical_mesh`` +
``InertialGravityWave.initial_state`` -> ``StructuredModel(mesh, nx, ny)``
-> ``to_struct`` -> ``structured_auto_run_loop`` (forward Euler, or
forward-backward with ``fb=True``; the tiled q-step kernel behind
``tiled_run_loop`` or the one-step kernel, by size) -> ``from_struct``; and
its gradient under ``torch.autograd``, ``auto_rollout_diff`` (the
``fe_step`` forward, and the reverse through the one-step adjoint kernel
behind ``fused_rollout_diff`` or the tiled adjoint kernel behind
``tiled_rollout_diff``, by size). The model
builds on the card unless given ``device="cpu"``; the state's device picks
the kernels (CUDA) or the plain versions (CPU). A coastal channel runs
the same entry points from ``StructuredModel(mesh, nx, ny,
parent_horz=parent, keep_cells=keep)``, through the kernels' masked arms.
Momentum forcing (``make_forcing``, ``StructuredModel.to_struct_forcing``)
rides every entry point as ``forcing=``, through the kernels' forced arms.
Tracers (``make_tracers``, a state's ``tracers``) ride every entry point,
the gradients among them (which return the tracers' cotangent), with
``tracer_kappa=`` and ``tracer_upwind=``, through the kernels' tracer arms.
Layered stratification (``make_stratification``) rides the forward entry
points as ``strat=``, through the forward kernels' stratified arms.
"""

from .constants import GRAVITY
from .mesh import (
    DualCells,
    Edges,
    HorzMesh,
    Mesh,
    PrimaryCells,
    VerticalMesh,
    cull_cells,
    make_vertical_mesh,
    planar_hex_mesh,
)
from .models import (
    Forcing,
    PrognosticVars,
    Stratification,
    make_forcing,
    make_stratification,
    make_tracers,
    montgomery_potential,
    total_tracer_content,
)
from .structured import (
    StructuredModel,
    auto_rollout_diff,
    fused_adjoint_rollout,
    fused_rollout_diff,
    fused_run_loop,
    fused_step,
    structured_auto_run_loop,
    structured_fb_step,
    structured_run_loop,
    tiled_rollout_diff,
    tiled_run_loop,
    window_steps,
)
from .utils import error_measures
from .verification import InertialGravityWave, InternalWave, KelvinWave

__all__ = [
    "GRAVITY",
    "DualCells",
    "Edges",
    "Forcing",
    "HorzMesh",
    "InertialGravityWave",
    "InternalWave",
    "KelvinWave",
    "Mesh",
    "PrimaryCells",
    "PrognosticVars",
    "Stratification",
    "StructuredModel",
    "VerticalMesh",
    "auto_rollout_diff",
    "cull_cells",
    "error_measures",
    "fused_adjoint_rollout",
    "fused_rollout_diff",
    "fused_run_loop",
    "fused_step",
    "make_forcing",
    "make_stratification",
    "make_tracers",
    "make_vertical_mesh",
    "montgomery_potential",
    "planar_hex_mesh",
    "structured_auto_run_loop",
    "structured_fb_step",
    "structured_run_loop",
    "tiled_rollout_diff",
    "tiled_run_loop",
    "total_tracer_content",
    "window_steps",
]
