"""The sharded superstep's received-halo arm run two ways: through the card's
kernels (``ShardedStructuredModel.run_pallas`` with the slabs on a CUDA
device) and through its plain version (the same model with the slabs on the
CPU, where ``run_pallas`` runs ``slab.window_steps`` on each slab's extended
window), with the fields' errors on their scales; and the run counts of
launches and exchanges. chip_smoke.py's phase 22 and
tests/test_torch_sharded_kernel.py use them.
"""

from __future__ import annotations

import torch

__all__ = ["FIELDS4", "field_errors", "kernel_launches", "pair_runs", "run_sharded",
           "zero_counts"]

FIELDS4 = ("ssh", "layer_thickness", "normal_velocity", "tracers")


def field_errors(a, b) -> dict:
    """{field: (max |a - b|, over its scale)} of two StructStates, over the
    fields b has (the tracers where it has them), on b's device: ssh's scale
    the column sum_k h (ssh is a small difference of large sums), the other
    fields' their max |b|."""
    out = {}
    for f in FIELDS4:
        y = getattr(b, f)
        if y is None:
            continue
        x = getattr(a, f).to(y.device)
        e = float((x - y).abs().max())
        scale = b.layer_thickness.sum(-1) if f == "ssh" else y
        out[f] = (e, e / max(float(scale.abs().max()), 1e-300))
    return out


def run_sharded(mesh, st, devices, dt, n_steps, **kw):
    """``run_pallas`` of ``st`` over slabs on ``devices`` (one per slab),
    gathered to a StructState, and the model."""
    from ..structured.sharded import ShardedStructuredModel

    model = ShardedStructuredModel(mesh, devices)
    return model.gather(model.run_pallas(model.scatter(st), dt, n_steps, **kw)), model


def pair_runs(mesh, st, n_parts: int, dt, n_steps, **kw):
    """(the card's run, the plain run, the card run's ``kernel_launches``)
    of ``run_pallas`` over n_parts slabs, on ``st``'s CUDA device and on the
    CPU; the counters are set to 0 before the card's run."""
    zero_counts()
    card, _ = run_sharded(mesh, st, [st.layer_thickness.device] * n_parts, dt, n_steps, **kw)
    counts = kernel_launches()
    plain, _ = run_sharded(mesh, st, [torch.device("cpu")] * n_parts, dt, n_steps, **kw)
    return card, plain, counts


def zero_counts() -> None:
    """Set the forward kernels' launch counters and the exchange counter to 0."""
    from ..kernels import fe_step, tiled_step
    from ..structured import sharded

    fe_step.launches = tiled_step.launches = sharded.exchanges = 0
    tiled_step.window_launches = 0


def kernel_launches() -> dict:
    """The counters ``zero_counts`` sets: fe_step's and tiled_step's
    launches (the superstep's arm is one of them), tiled_step's q-step
    kernel's, and the field exchanges."""
    from ..kernels import fe_step, tiled_step
    from ..structured import sharded

    return {"fe_step": fe_step.launches, "tiled_step": tiled_step.launches,
            "window": tiled_step.window_launches, "exchanges": sharded.exchanges}
