"""The composed reverse run two ways on one stack of primal states: through
the card's kernels (the gradient's steps, ``diff_model._Steps`` or
``tiled_diff._TiledSteps``, with the combination's arms; at q > 1 through
the supersteps' starts, ``superstep_stack``) and
through the plain reverse (``structured_nl_adjoint_step`` or
``structured_adjoint_step`` with forcing, tracers and strat), with the
cotangents' errors on their scales: the fields' max |b|, the scalars'
Cauchy-Schwarz bounds (d(dt)'s by the tangent of the plain rollout, a
central difference, the drag and Rayleigh coefficients' the sums of their
terms' magnitudes, |dt gu| bot |u|,
|dt gu| bot u^2 / h_e and |dt gu u|), d(W)'s sum over the steps and cells
of |h| |dPhi|. A combination is a string of N (the nonlinear core), F
(forcing), T (tracers) and S (stratification). chip_smoke.py's phase 20 and
tests/test_torch_composed_adjoint_kernel.py hold the kernels' composed arms
against the plain reverse with them; they run on any device, the kernels
on a CUDA one.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["COMPOSED_COMBOS", "COMPOSED_KAPPA", "COMPOSED_UPWIND", "FIELDS4", "composed_ddt_scale",
           "composed_errors", "composed_reverse", "composed_stack", "composed_state",
           "composed_steps", "plain_composed_reverse", "plain_superstep_reverse",
           "superstep_stack"]

# The 11 combinations of two or more of the nonlinear core (N), forcing (F),
# tracers (T) and stratification (S)
COMPOSED_COMBOS = ("NF", "NT", "NS", "FT", "FS", "TS", "NFT", "NFS", "NTS", "FTS", "NFTS")
# The tracers' options the runs take
COMPOSED_KAPPA, COMPOSED_UPWIND = 5.0, 0.5
FIELDS = ("ssh", "layer_thickness", "normal_velocity")
FIELDS4 = FIELDS + ("tracers",)


def composed_steps(mesh, dt, like, opts, forcing, strat, plan=None, kappa=COMPOSED_KAPPA,
                   upwind=COMPOSED_UPWIND):
    """The gradient's card steps of the combination ``opts``: diff_model's
    (the fused route; plan None) or tiled_diff's over ``plan`` =
    (row_tile, col_tile), at q = 1, or (row_tile, col_tile, q), with the
    options ``opts`` leaves on (forcing and strat given for the full
    combination) and the tracers' ``kappa`` and ``upwind``."""
    from ..structured import diff_model, tiled_diff

    kw = dict(nonlinear="N" in opts, forcing=forcing if "F" in opts else None,
              strat=strat if "S" in opts else None, tracers="T" in opts,
              tracer_kappa=kappa, tracer_upwind=upwind)
    if plan is None:
        return diff_model._Steps(mesh, dt, like, **kw)
    return tiled_diff._TiledSteps(mesh, dt, like, (*plan[:2], plan[2] if len(plan) > 2 else 1, 1),
                                  **kw)


def composed_state(st, opts):
    """``st`` with its tracers where ``opts`` has T, without them else."""
    from ..structured import StructState

    return st if "T" in opts else StructState(*(getattr(st, f) for f in FIELDS))


def composed_stack(steps, st, n):
    """n + 1 states from ``st`` by the steps' rebuild (fe_fill_stack or
    fe_nl_fill_stack with the combination's arms), slot j after j steps, as
    a StructState of stacks with the tracers as planes."""
    from ..structured import diff_model

    state = diff_model._planes_state(st)
    stack = diff_model._empty(state, n + 1)
    for dst, x in zip(diff_model._fields(diff_model._slot(stack, 0)), diff_model._fields(state)):
        dst.copy_(x)
    steps.fill(stack, n)
    return stack


def superstep_stack(stack, q):
    """The slots 0, q, 2q, .. of a stack of states (``composed_stack``'s,
    slot j after j steps), contiguous: the starts of supersteps of q steps,
    the stack tiled_diff's steps reverse at q."""
    from ..structured import StructState

    return StructState(*(None if x is None else x[::q].contiguous() for x in (
        stack.ssh, stack.layer_thickness, stack.normal_velocity, stack.tracers)))


def composed_reverse(steps, stack, g, n):
    """n reverse steps of the kernels through the stack's slots n - 1 .. 0
    from the cotangent ``g`` (lattice layout, its tracers where the steps
    carry them), the state after them slot n: (cotangent, d(dt), d(wind)
    (6, ny2, nx) or None, d(r_lin, Cd, lambda) or None, d(W) or None), all
    f64, the cotangent's tracers in the lattice layout."""
    from ..structured import StructState, diff_model

    like = diff_model._slot(stack, 0)
    ddt = torch.zeros(1, dtype=torch.float64, device=stack.ssh.device)
    out, scratch = diff_model._empty(like), diff_model._empty(like)
    gp = diff_model._cotangent(diff_model._planes_state(g), like)
    steps.reverse(stack, gp, n, ddt, out, scratch, end=diff_model._slot(stack, n))
    d = diff_model._lattice_state(out)
    d = StructState(*(None if x is None else x.double() for x in
                      (d.ssh, d.layer_thickness, d.normal_velocity, d.tracers)))
    f = steps.dforc
    return (d, ddt[0], None if f is None else f.wind.double(), None if f is None else f.coefs,
            None if steps.dstrat is None else steps.dstrat.clone())


def plain_composed_reverse(stack, g, mesh, dt, n, opts, forcing, strat, dtype=None, store=None):
    """The plain reverse of the combination ``opts``
    (``structured_nl_adjoint_step`` with N, ``structured_adjoint_step``
    without; forcing, tracers with kappa 5 and upwind 0.5, strat) back
    through the stack's slots n - 1 .. 0 from g, h' and T' read from the
    next slot as the kernels read them, in ``dtype`` (the stack's by
    default; the forcing and W cast to it), each step's cotangent passed
    through ``store`` (the bf16 control): (the tuple ``composed_reverse``
    returns, the scales of its sums: "d_w" the max over (l, k) of the sum
    over the steps and cells of |h[c, l]| |dPhi[c, k]| with S, and with F
    "d_r_lin", "d_cd", "d_lambda" the sums over the steps and edge-levels
    of |a| bot |u|, |a| bot u^2 inv_h and |a u|, a = dt gu)."""
    from ..models import Stratification
    from ..models.forcing import Forcing
    from ..structured import (
        StructState,
        diff_model,
        pressure_transpose,
        structured_adjoint_step,
        structured_nl_adjoint_step,
    )
    from ..structured.model import interp_cell_to_edge

    dtype = dtype or stack.layer_thickness.dtype
    device, k = stack.ssh.device, stack.layer_thickness.shape[-1]
    step = structured_nl_adjoint_step if "N" in opts else structured_adjoint_step
    if "F" in opts:
        forcing = Forcing(*(getattr(forcing, f.name).to(dtype)
                            for f in dataclasses.fields(forcing)))
    else:
        forcing = None
    if "S" in opts:
        strat = Stratification(strat.phi_weights.to(dtype), strat.densities.to(dtype))
        eye = Stratification(torch.eye(k, dtype=torch.float64, device=device),
                             strat.densities.double())
    else:
        strat = None
    slot = lambda j: diff_model._lattice_state(StructState(*(  # noqa: E731
        None if x is None else x[j].to(dtype) for x in (
            stack.ssh, stack.layer_thickness, stack.normal_velocity, stack.tracers))))
    g = StructState(*(None if x is None else x.to(dtype) for x in (
        g.ssh, g.layer_thickness, g.normal_velocity, g.tracers if "T" in opts else None)))
    ddt = torch.zeros((), dtype=torch.float64, device=device)
    dwind = dcoef = dw = None
    w_scale = torch.zeros((k, k), dtype=torch.float64, device=device)
    c_scale = torch.zeros(3, dtype=torch.float64, device=device)
    for j in reversed(range(n)):
        s = slot(j)
        gu = g.normal_velocity.double()
        if mesh.edge_mask is not None:
            gu = gu * mesh.edge_mask[..., None].double()
        if strat is not None:
            d_phi, _ = pressure_transpose(s.layer_thickness.double(), gu, dt, mesh, eye)
            w_scale += s.layer_thickness.double().abs().reshape(-1, k).T @ d_phi.abs().reshape(
                -1, k)
        if forcing is not None:
            a, u = (dt * gu).abs(), s.normal_velocity.double()
            he = interp_cell_to_edge(s.layer_thickness.double(), mesh)
            inv_h = 1.0 / torch.where(he > 0, he, torch.ones_like(he))
            bot = forcing.bottom_mask.double()
            c_scale += torch.stack([(a * bot * u.abs()).sum(), (a * bot * u * u * inv_h).sum(),
                                    (a * u.abs()).sum()])
        res = step(s, g, mesh, dt, forcing, tracer_kappa=COMPOSED_KAPPA,
                   tracer_upwind=COMPOSED_UPWIND, next_state=slot(j + 1), strat=strat)
        g = res[0]
        if store is not None:
            g = StructState(*(None if x is None else store(x) for x in (
                g.ssh, g.layer_thickness, g.normal_velocity, g.tracers)))
        ddt = ddt + res[1].double()
        if forcing is not None:
            dw_f, dc_f = res[2].wind.double().reshape(6, mesh.ny2, mesh.nx), res[2].coefs.double()
            dwind = dw_f if dwind is None else dwind + dw_f
            dcoef = dc_f if dcoef is None else dcoef + dc_f
        if strat is not None:
            dw = res[-1].double() if dw is None else dw + res[-1].double()
    d = StructState(*(None if x is None else x.double() for x in (
        g.ssh, g.layer_thickness, g.normal_velocity, g.tracers)))
    scales = {}
    if strat is not None:
        scales["d_w"] = float(w_scale.max())
    if forcing is not None:
        scales.update(zip(("d_r_lin", "d_cd", "d_lambda"), (float(x) for x in c_scale)))
    return (d, ddt, dwind, dcoef, dw), scales


def plain_superstep_reverse(stack, g, mesh, dt, n, q, opts, forcing, strat, dtype=None,
                            store=None):
    """The plain version of the tiled reverse at q > 1 (the VJP of
    ``slab.window_steps``' q steps): back through n supersteps whose starts
    are the stack's slots n - 1 .. 0 (``superstep_stack``'s; slot n the
    state after the last), each superstep's states 1 .. q - 1 recomputed
    from its start by the plain steps of the combination in ``dtype`` (the
    stack's by default), as the kernel recomputes them, then its q steps
    reversed by ``plain_composed_reverse`` (h' and T' of its last step from
    the next start). Returns that function's tuple over all the steps, and
    its scales summed over the supersteps (at least the single sum's)."""
    from ..models import Stratification
    from ..models.forcing import Forcing
    from ..structured import StructState, diff_model, structured_run_loop

    dtype = dtype or stack.layer_thickness.dtype
    kw = dict(nonlinear="N" in opts, tracer_kappa=COMPOSED_KAPPA, tracer_upwind=COMPOSED_UPWIND)
    if "F" in opts:
        kw["forcing"] = Forcing(*(getattr(forcing, f.name).to(dtype)
                                  for f in dataclasses.fields(forcing)))
    if "S" in opts:
        kw["strat"] = Stratification(strat.phi_weights.to(dtype), strat.densities.to(dtype))
    fields = lambda s: (s.ssh, s.layer_thickness, s.normal_velocity, s.tracers)  # noqa: E731
    total, scales = None, {}
    for j in reversed(range(n)):
        start = diff_model._lattice_state(StructState(*(
            None if x is None else x[j].to(dtype) for x in fields(stack))))
        states = [start]
        for _ in range(q - 1):
            states.append(structured_run_loop(states[-1], mesh, dt, 1, **kw))
        planes = [diff_model._planes_state(s) for s in states]
        mini = StructState(*(None if x[0] is None else torch.stack(x)
                             for x in zip(*(fields(p) for p in planes))))
        mini = StructState(*(None if x is None else torch.cat([x, y[j + 1:j + 2].to(dtype)])
                             for x, y in zip(fields(mini), fields(stack))))
        res, sc = plain_composed_reverse(mini, g, mesh, dt, q, opts, forcing, strat, dtype,
                                         store)
        g = res[0]
        total = res if total is None else (res[0], *(
            None if a is None else a + b for a, b in zip(total[1:], res[1:])))
        for key, v in sc.items():
            scales[key] = scales.get(key, 0.0) + v
    return (g, *total[1:]), scales


def composed_ddt_scale(st, mesh, dt, n, g, opts, forcing, strat) -> float:
    """The Cauchy-Schwarz scale of d(dt) = <g, d(state_n)/d(dt)> after n
    plain steps of the combination from ``st``: sum over the fields of |g|
    |d(state_n)/d(dt)| (with tracers d(dt) is a sum whose terms cancel to
    some 1e-2 of them). The tangent is a central difference of the plain
    rollout, dt +- 1e-4 dt: at f64 its error is ~1e-8 of it, nothing to a
    scale, and forward-mode AD through the nonlinear composed step took
    seconds a call."""
    from ..structured import structured_run_loop

    st = composed_state(st, opts)
    fields = FIELDS + (("tracers",) if "T" in opts else ())
    kw = dict(nonlinear="N" in opts, forcing=forcing if "F" in opts else None,
              strat=strat if "S" in opts else None, tracer_kappa=COMPOSED_KAPPA,
              tracer_upwind=COMPOSED_UPWIND)
    eps = 1e-4 * dt
    plus, minus = (structured_run_loop(st, mesh, d, n, **kw) for d in (dt + eps, dt - eps))
    return sum(float(torch.linalg.vector_norm(getattr(g, f).double()) * torch.linalg.vector_norm(
        (getattr(plus, f).double() - getattr(minus, f).double()) / (2 * eps))) for f in fields)


def composed_errors(a, b, scales: dict) -> dict:
    """{cotangent: (max |a - b|, over its scale)} of two composed reverses:
    the fields' (the tracers' among them) and d(wind)'s over max |b|, d(dt),
    the coefficients' and d(W)'s over ``scales`` (``composed_ddt_scale``'s
    "d_dt" and the others of ``plain_composed_reverse``); the parts b
    has."""
    out = {}
    for f in FIELDS4:
        x, y = getattr(a[0], f), getattr(b[0], f)
        if y is not None:
            e = float((x - y).abs().max())
            out[f] = (e, e / float(y.abs().max()))
    e = abs(float(a[1]) - float(b[1]))
    out["d_dt"] = (e, e / scales["d_dt"])
    if b[2] is not None:
        e = float((a[2] - b[2]).abs().max())
        out["d_wind"] = (e, e / float(b[2].abs().max()))
        for i, name in enumerate(("d_r_lin", "d_cd", "d_lambda")):
            e = abs(float(a[3][i]) - float(b[3][i]))
            out[name] = (e, e / scales[name])
    if b[4] is not None:
        e = float((a[4] - b[4]).abs().max())
        out["d_w"] = (e, e / scales["d_w"])
    return out
