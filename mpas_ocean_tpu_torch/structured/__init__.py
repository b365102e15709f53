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
    structured_run_loop,
    structured_step,
)

__all__ = [
    "HexLayout",
    "StructMesh",
    "StructState",
    "StructuredModel",
    "fused_run_loop",
    "struct_mesh_from_numpy",
    "struct_mesh_to_numpy",
    "struct_state_from_numpy",
    "struct_state_to_numpy",
    "structured_auto_run_loop",
    "structured_run_loop",
    "structured_step",
]
