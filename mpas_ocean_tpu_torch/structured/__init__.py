from .adjoint import structured_adjoint_run_loop, structured_adjoint_step
from .diff_model import (
    FusedRolloutDiff,
    FusedStep,
    adjoint_from_ckpts,
    adjoint_plan,
    adjoint_segment,
    forward_ckpts,
    fused_adjoint_rollout,
    fused_rollout_diff,
    fused_step,
)
from .fused_model import fused_run_loop, structured_auto_run_loop
from .hex_layout import HexLayout
from .model import (
    StructMesh,
    StructState,
    StructuredModel,
    struct_mesh_from_numpy,
    struct_mesh_to_numpy,
    struct_state_from_numpy,
    struct_state_to_numpy,
    structured_fb_step,
    structured_run_loop,
    structured_step,
)
from .slab import window_steps
from .tiled_model import tile_plan, tiled_run_loop

__all__ = [
    "FusedRolloutDiff",
    "FusedStep",
    "HexLayout",
    "StructMesh",
    "StructState",
    "StructuredModel",
    "adjoint_from_ckpts",
    "adjoint_plan",
    "adjoint_segment",
    "forward_ckpts",
    "fused_adjoint_rollout",
    "fused_rollout_diff",
    "fused_run_loop",
    "fused_step",
    "struct_mesh_from_numpy",
    "struct_mesh_to_numpy",
    "struct_state_from_numpy",
    "struct_state_to_numpy",
    "structured_adjoint_run_loop",
    "structured_adjoint_step",
    "structured_auto_run_loop",
    "structured_fb_step",
    "structured_run_loop",
    "structured_step",
    "tile_plan",
    "tiled_run_loop",
    "window_steps",
]
