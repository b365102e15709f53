"""Row-sharded structured model: the lattice cut into row slabs, one per
device, each stepped on its own with halo rows received from its two
neighbours.

Counterpart of mpas_ocean_tpu/structured/sharded.py's
``ShardedStructuredModel`` (:677-1909), single-controller as it is: one
process drives P slabs, slab p on ``devices[p]``. Its halo exchange, there a
``lax.ppermute`` pair per field, is here a device copy of each slab's first
and last rows into its neighbours' halo rows (``torch.Tensor.copy_`` or, on
the differentiable paths, ``torch.cat``, whose backward sends the halo
cotangents back to the slab that sent the rows: the exchange's transpose).
A ring of one takes its halos from its own opposite rows, as ``ppermute``
on one device does.

Three paths, as in JAX:

- ``run`` / ``objective``: one step and one exchange round per step (the
  nonlinear core a second round of its derived fields, the nonlinear FB a
  third of the fresh thickness), plain PyTorch on the slabs' devices, the
  counterpart of the JAX package's XLA path. ``objective`` is
  differentiable under ``torch.autograd`` with two-level sqrt checkpointing.
- ``run_pallas``: the communication-avoiding superstep. Each slab holds its
  state in a buffer of R + 2 hq rows (hq = reach * q halo rows per side);
  one exchange per field fills the halo rows in place, and one launch of
  the tiled kernel's received-halo arm (kernels/tiled_step.py, kernels/
  fe_step.py; csrc/step_window.cuh, ``buffer_plane``) advances the slab q
  steps into the other buffer. On CPU slabs the same route runs the kernel's
  plain version, ``slab.window_steps`` on each slab's extended window.
- ``objective_pallas``: Sum ssh^2 of ``run_pallas``'s rollout,
  differentiable: a ``torch.autograd.Function`` per superstep whose forward
  is the kernel and whose backward replays the plain superstep under
  autograd, with two-level sqrt checkpointing over supersteps.

Slab layout (JAX's, one tensor per slab): ``local`` = {"ssh": [(2, R + 2,
nx, 1)], "h": [(2, R + 2, nx, K)], "u": [(6, R + 2, nx, K)], "t":
[(2 nT, R + 2, nx, K)]}, one halo row per side, edge channel family * 2 +
parity, tracer plane t * 2 + parity.

Multi-process and multi-host stepping (JAX's ``device_mesh=``) is not
ported: the slabs' devices belong to one process.
"""

from __future__ import annotations

import math
import warnings

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import fe_step, tiled_step
from ..models.forcing import Forcing
from ..models.stratification import Stratification
from . import fused_model, tiled_model
from .model import StructMesh, StructState, check_nl_mesh
from .slab import (
    derived_ring,
    derived_slab,
    nl_continuity,
    nl_momentum,
    pressure,
    reach,
    stencil_reach,
    step_slab,
    tracer_update,
    window_steps,
)

__all__ = ["AUTO_Q", "ShardedStructuredModel", "exchanges", "objective_supersteps"]

# the superstep's q when run_pallas is given none (JAX: min(8, R // reach)),
# reduced as an explicit q is. On an H100 at bench.py's superstep cell
# (64x64x100 f32, P = 1, 8000 steps; PERF.md section 5) q = 2 took 97.2 us a
# step, q = 1 208.8 and q = 4 144.2: each superstep costs ~190 us of host
# work (the wrapper's checks, the exchange's copies), which q = 2 halves,
# while q = 4 fits only 2 x 4 tiles
AUTO_Q = 2

# field exchanges run_pallas made: one per field (ssh, h, u, tracers) per
# superstep, each a copy of hq rows per side into every slab's halo rows
exchanges = 0
# slab supersteps objective_pallas ran forward, its checkpoints' recomputes
# among them (each one launch of the kernel on a CUDA slab)
objective_supersteps = 0


def _wrap_cols(x, c: int):
    """(..., rows, nx, tr) -> (..., rows, nx + 2c, tr): c columns wrapped
    periodically onto each side (JAX's slabs roll the whole nx axis; the
    port's windows carry a column halo instead)."""
    if c == 0 or x is None:
        return x
    nx = x.shape[-2]
    return x.index_select(-2, torch.arange(-c, nx + c, device=x.device) % nx)


def _with_halo(interiors, hq: int, devices):
    """Slabs' own rows [(planes, R, nx, tr)] -> [(planes, R + 2 hq, nx,
    tr)]: slab p's top halo the last hq rows of slab p - 1, its bottom halo
    the first hq rows of slab p + 1, on a ring (sharded._with_halo). By
    ``torch.cat``: differentiable, the halo cotangents go back to the slab
    that sent the rows."""
    n = len(interiors)
    return [torch.cat([interiors[(p - 1) % n][:, -hq:].to(devices[p]), interiors[p],
                       interiors[(p + 1) % n][:, :hq].to(devices[p])], 1) for p in range(n)]


def _fill_halos(bufs, hq: int, rows: int) -> None:
    """Fill the halo rows of the slabs' buffers [(planes, rows + 2 hq, ...)]
    in place from their neighbours' own rows, which lie at [hq, hq + rows):
    the superstep's exchange (sharded.py:1696-1704), with no concatenation."""
    n = len(bufs)
    for p in range(n):
        bufs[p][:, :hq].copy_(bufs[(p - 1) % n][:, rows:rows + hq])
        bufs[p][:, rows + hq:].copy_(bufs[(p + 1) % n][:, hq:2 * hq])


def _checkpointed(step, carry: tuple, n: int) -> tuple:
    """n applications of ``step`` (a tuple of tensors to a tuple of tensors)
    under two-level sqrt checkpointing (sharded.py:1362-1381): sqrt(n)
    chunks of sqrt(n) steps, each chunk and each step recomputed in the
    backward pass, so the memory is O(sqrt(n)) states."""
    b = max(1, math.isqrt(n))
    a, rem = divmod(n, b)

    def chunk(*c):
        for _ in range(b):
            c = checkpoint(step, *c, use_reentrant=False)
        return c

    for _ in range(a):
        carry = checkpoint(chunk, *carry, use_reentrant=False)
    for _ in range(rem):
        carry = checkpoint(step, *carry, use_reentrant=False)
    return carry


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


class ShardedStructuredModel:
    """Drive the structured core over row slabs, one per device.

    ``devices``: one ``torch.device`` per slab, which may repeat (P slabs on
    one card, or on the CPU); by default one slab on each visible CUDA
    device, and with none a RuntimeError: CPU slabs must be asked for.
    ``overlap`` steps each slab's two boundary rows before its exchange and
    the rest after it (sharded.py:1162-1218); the values are the same
    either way."""

    def __init__(self, struct_mesh: StructMesh, devices=None, overlap: bool = True):
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError("no CUDA device: pass devices=[torch.device('cpu')] * P "
                                   "for P slabs on the CPU")
            devices = [torch.device("cuda", i) for i in range(n)]
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("ShardedStructuredModel needs at least one device")
        self.n_parts = len(self.devices)
        self.smesh = struct_mesh
        self.overlap = bool(overlap)
        ny2 = struct_mesh.ny2
        if ny2 % self.n_parts:
            raise ValueError(f"ny2={ny2} rows not divisible by {self.n_parts} devices")
        self.rows = ny2 // self.n_parts
        self._cache = {}

    # ---- the slab layout (sharded.py:742-816, 915-933, 1410-1477) ----

    def _slab(self, x, halo: int = 1, axis: int | None = None) -> list:
        """(planes..., ny2, nx, trailing) -> one (planes..., R + 2 halo, nx,
        trailing) slab per device, with periodic halo rows; ``axis`` the row
        axis (by default the third from last)."""
        ny2, R = self.smesh.ny2, self.rows
        axis = x.dim() - 3 if axis is None else axis
        out = []
        for p, dev in enumerate(self.devices):
            rows = torch.arange(p * R - halo, (p + 1) * R + halo, device=x.device) % ny2
            out.append(x.index_select(axis, rows).to(dev).contiguous())
        return out

    def scatter(self, state: StructState) -> dict:
        """Global structured state -> halo-padded slabs on their devices."""
        ny2, nx = self.smesh.ny2, self.smesh.nx
        k = state.layer_thickness.shape[-1]
        out = {
            "ssh": self._slab(state.ssh[..., None]),
            "h": self._slab(state.layer_thickness),
            "u": self._slab(state.normal_velocity.reshape(6, ny2, nx, k)),
        }
        if state.tracers is not None:
            out["t"] = self._slab(fused_model.tracer_planes(state.tracers))
        return out

    def _unslab(self, slabs, halo: int = 1):
        dev = self.devices[0]
        return torch.cat([x[:, halo:x.shape[1] - halo].to(dev) for x in slabs], 1)

    def gather(self, local: dict) -> StructState:
        """Slabs -> global structured state (their own rows), on the first
        slab's device."""
        ny2, nx = self.smesh.ny2, self.smesh.nx
        h = self._unslab(local["h"])
        k = h.shape[-1]
        return StructState(
            ssh=self._unslab(local["ssh"])[..., 0],
            layer_thickness=h,
            normal_velocity=self._unslab(local["u"]).reshape(3, 2, ny2, nx, k),
            tracers=(fused_model.tracer_unplanes(self._unslab(local["t"]))
                     if "t" in local else None),
        )

    def checksum(self, local: dict):
        """Sum of every slab's own state values (sharded.py:915), a 0-d
        tensor on the first slab's device: slab by slab, in slab order."""
        dev = self.devices[0]
        total = None
        for p in range(self.n_parts):
            s = sum(local[key][p][:, 1:-1].sum() for key in ("ssh", "h", "u", "t")
                    if key in local).to(dev)
            total = s if total is None else total + s
        return total

    def _nl_validate(self):
        sm = self.smesh
        check_nl_mesh(sm)
        # the derived-field exchange and the local recompute are exact on
        # their halos only because the vertex taps stay within these rows
        if not all(t[3] in (0, 1) for t in sm.vertex_cell_terms):
            raise ValueError("vertex-cell stencil reaches outside rows {0, +1}")
        if not all(t[4] in (-1, 0) for t in sm.edge_vertex_terms):
            raise ValueError("edge-vertex stencil reaches outside rows {-1, 0}")

    def _fb_validate(self, fb: bool, nonlinear: bool):
        if fb and not nonlinear and self.rows < 2:
            raise ValueError("forward-backward needs >= 2 rows per device for the 2-row halo "
                             f"exchange; got rows/device={self.rows}")

    def _const_slabs(self, hq: int, dtype, nonlinear: bool) -> dict:
        """The constant slabs with ``hq`` halo rows per side in ``dtype``,
        cached per (hq, dtype, nonlinear): slab layout for the plain steps
        (f (6, R + 2 hq, nx, 1), rts, the wall mask, the cell mask, the vertex
        constants) and, for the kernels, the wall mask's live bits."""
        key = ("const", hq, dtype, nonlinear)
        if key in self._cache:
            return self._cache[key]
        sm = self.smesh
        ny2, nx = sm.ny2, sm.nx
        out = {
            "f": self._slab(sm.f_edge.to(dtype).reshape(6, ny2, nx, 1), hq),
            "rts": self._slab(sm.resting_thickness_sum.to(dtype)[..., None], hq),
            "mask": None, "cmask": None, "fv": None, "live": None,
        }
        if sm.edge_mask is not None:
            out["mask"] = self._slab(sm.edge_mask.to(dtype).reshape(6, ny2, nx, 1), hq)
            out["live"] = self._slab(fused_model.kernel_live(sm), hq, axis=0)
        if sm.cell_mask is not None:
            out["cmask"] = self._slab(sm.cell_mask.to(dtype)[..., None], hq)
        if nonlinear:
            # f_vertex's 4 planes, or on a channel with the vertex mask's 4
            # and the kite weights' 12 (sharded._fv_planes)
            out["fv"] = self._slab(fused_model.nl_setup(sm, dtype)[..., None], hq)
        self._cache[key] = out
        return out

    # ---- forcing on slabs (sharded.py:935-1018) ----

    def scatter_forcing(self, struct_forcing: Forcing | None):
        """Lattice Forcing (``StructuredModel.to_struct_forcing``) -> slabs:
        wind (6, R + 2, nx, 1), the dense level masks top and bot (6, R + 2,
        nx, K), and the three coefficients, one 0-d tensor per slab."""
        if struct_forcing is None:
            return None
        f = struct_forcing
        ny2, nx = self.smesh.ny2, self.smesh.nx
        return {
            "wind": self._slab(f.wind_edge.reshape(6, ny2, nx, 1)),
            "top": self._slab(f.top_mask.reshape(6, ny2, nx, -1)),
            "bot": self._slab(f.bottom_mask.reshape(6, ny2, nx, -1)),
            **{name: [getattr(f, attr).detach().clone().to(dev) for dev in self.devices]
               for name, attr in (("dlin", "drag_linear"), ("dquad", "drag_quadratic"),
                                  ("rayl", "rayleigh"))},
        }

    def gather_forcing_grad(self, d_forcel: dict, struct_forcing: Forcing) -> Forcing:
        """Slab-layout forcing cotangent (the gradient of ``objective`` with
        respect to a ``scatter_forcing`` dict) -> lattice Forcing cotangent
        shaped as ``struct_forcing``: the slabs' own rows of the wind and the
        level masks (their halo rows carry none, ``objective`` rebuilds
        them from the slabs' own rows), the per-slab coefficients' summed."""
        f = struct_forcing

        def total(name):
            return sum(x.to(self.devices[0]) for x in d_forcel[name])

        return Forcing(
            wind_edge=self._unslab(d_forcel["wind"]).reshape(f.wind_edge.shape).to(
                f.wind_edge.dtype),
            top_mask=self._unslab(d_forcel["top"]).reshape(f.top_mask.shape).to(
                f.top_mask.dtype),
            bottom_mask=self._unslab(d_forcel["bot"]).reshape(f.bottom_mask.shape).to(
                f.bottom_mask.dtype),
            drag_linear=total("dlin").to(f.drag_linear.dtype),
            drag_quadratic=total("dquad").to(f.drag_quadratic.dtype),
            rayleigh=total("rayl").to(f.rayleigh.dtype),
        )

    # ---- structural statistics (sharded.py:818-913) ----

    def step_stats(self, n_vert_levels: int, itemsize: int = 4, *, path: str = "run",
                   q: int = 1, row_tile: int | None = None, nonlinear: bool = False,
                   fb: bool = False, n_tracers: int = 0) -> dict:
        """The deterministic communication and compute profile of one step
        on this decomposition (sharded.py:818): exchange pairs, payload
        bytes per exchange and per step, the redundant-compute fraction of
        the superstep's shrinking windows. ``path`` "pallas" is the
        superstep's, its row tile ``row_tile`` or the port's plan's
        (``superstep_plan``)."""
        R, nx, k = self.rows, self.smesh.nx, n_vert_levels
        rch = reach(fb, nonlinear)
        n_tr = n_tracers
        state_vals = (2 * 1 + (8 + 2 * n_tr) * k) * nx
        if path == "pallas":
            q = max(1, int(q))
            hq = rch * q
            rt = row_tile
            if rt is None:
                rt = self._tile(q, k, itemsize, nonlinear, fb, n_tr, False, False)
                if rt is None:
                    raise ValueError("no slab tile fits the kernel's shared memory "
                                     f"(rows/device={R}, nx={nx}, K={k}, q={q})")
                rt = rt[0]
            n_fields = 3 + (1 if n_tr else 0)
            pairs_per_step = n_fields / q
            bytes_per_collective = state_vals * hq * itemsize / n_fields
            bytes_per_step = 2 * state_vals * hq * itemsize / q
            redundant = rch * (q - 1) / rt
            rounds_per_step = 1.0 / q
            detail = {"q": q, "row_tile": rt, "halo_rows": hq}
        else:
            rounds = 3 if (nonlinear and fb) else (2 if nonlinear else 1)
            hq = 2 if (fb and not nonlinear) else 1
            n_fields = 3 + (1 if n_tr else 0)
            if nonlinear:
                extra_vals = 14 * k * nx + ((2 + 2 * k) * nx if fb else 0)
                pairs_per_step = float(n_fields + (3 if fb else 1))
            else:
                extra_vals = 0
                pairs_per_step = float(n_fields)
            total_vals = state_vals * hq + extra_vals
            bytes_per_collective = total_vals * itemsize / max(pairs_per_step, 1)
            bytes_per_step = 2 * total_vals * itemsize
            redundant = 0.0
            rounds_per_step = float(rounds)
            detail = {"halo_rows": hq}
        return {
            "path": path,
            "rows_per_device": R,
            "collective_pairs_per_step": float(pairs_per_step),
            "exchange_rounds_per_step": float(rounds_per_step),
            "bytes_per_collective_per_device": float(bytes_per_collective),
            "exchange_bytes_per_step_per_device": float(bytes_per_step),
            "redundant_compute_frac": float(redundant),
            **detail,
        }

    def overlap_stats(self, n_vert_levels: int, itemsize: int = 4) -> dict:
        """The overlap profile of one step of ``run`` (sharded.py:899): the
        rows stepped while the exchange is in flight."""
        r, nx = self.rows, self.smesh.nx
        k = n_vert_levels
        elems_one_way = (2 * 1 + 2 * k + 6 * k) * nx
        active = self.overlap and r >= 3
        return {
            "rows_per_device": r,
            "interior_rows_overlapped": (r - 2) if active else 0,
            "overlappable_compute_frac": (r - 2) / r if active else 0.0,
            "halo_bytes_per_step_per_device": 2 * elems_one_way * itemsize,
        }

    # ---- the per-step path (sharded.py:1020-1408) ----

    def run(self, local: dict, dt, n_steps: int, nonlinear: bool = False, forcing=None,
            tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
            strat: Stratification | None = None, fb: bool = False) -> dict:
        """n_steps steps, one exchange round per step (the nonlinear core
        two, the nonlinear FB three), plain PyTorch on the slabs' devices.
        ``forcing`` a lattice Forcing or a ``scatter_forcing`` dict; ``fb``
        the forward-backward stepper (the linear FB exchanges two rows per
        side). Returns the slab dict."""
        self._fb_validate(fb, nonlinear)
        if n_steps < 0:
            raise ValueError("n_steps must be >= 0")
        with torch.no_grad():
            out = self._steps(local, dt, n_steps, nonlinear, forcing, tracer_kappa,
                              tracer_upwind, strat, fb, False)
        return out

    def objective(self, local: dict, dt, n_steps: int, nonlinear: bool = False, forcing=None,
                  tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                  strat: Stratification | None = None, fb: bool = False):
        """Sum(ssh_final^2) of ``run``'s rollout, a 0-d tensor on the first
        slab's device, differentiable under ``torch.autograd`` through the
        whole loop with two-level sqrt checkpointing (sharded.py:1041). The
        input halo rows (and a forcing dict's) are rebuilt from the slabs'
        own rows, so the gradient lands on those rows and ``gather`` of the
        gradient dict is the global gradient."""
        self._fb_validate(fb, nonlinear)
        if n_steps < 0:
            raise ValueError("n_steps must be >= 0")
        return self._steps(local, dt, n_steps, nonlinear, forcing, tracer_kappa, tracer_upwind,
                           strat, fb, True)

    def _steps(self, local, dt, n_steps, nonlinear, forcing, kappa, upwind, strat, fb,
               objective):
        sm, R, nx = self.smesh, self.rows, self.smesh.nx
        devs = self.devices
        if nonlinear:
            self._nl_validate()
        dtype = local["h"][0].dtype
        keys = [key for key in ("ssh", "h", "u", "t") if key in local]
        terms = sm.coriolis_terms
        dt_, inv_dc, s_div = fused_model._scal(sm, dt, dtype)
        s_ke, s_curl = fused_model.nl_scal(sm, dtype) if nonlinear else (None, None)
        tropts = fused_model.tracer_opts(kappa, upwind, dtype)
        strat_w = [None if strat is None else strat.phi_weights.to(dtype=dtype, device=d)
                   for d in devs]
        nl_terms = (sm.vertex_cell_terms, sm.edge_vertex_terms) if nonlinear else None
        # halo rows the carry holds (the linear FB's two), and the columns
        # each slab's windows wrap onto each side
        pad = 2 if (fb and not nonlinear) else 1
        cols = stencil_reach(terms, fb and not nonlinear, nl_terms)[1]
        cs = self._const_slabs(pad, dtype, nonlinear)
        consts = {name: None if v is None else [_wrap_cols(x, cols) for x in v]
                  for name, v in cs.items() if name != "live"}

        forc = [None] * self.n_parts
        if forcing is not None:
            fl = forcing if isinstance(forcing, dict) else self.scatter_forcing(forcing)
            if objective or pad != 1:
                # rebuild the halo rows from the slabs' own rows, so that a
                # gradient with respect to the forcing slabs lands on them
                fl = dict(fl, **{name: _with_halo([x[:, 1:-1] for x in fl[name]], pad, devs)
                                 for name in ("wind", "top", "bot")})
            forc = [(_wrap_cols(fl["wind"][p].to(dtype), cols),
                     _wrap_cols(torch.cat([fl["top"][p], fl["bot"][p]]).to(dtype), cols),
                     *(fl[c][p].to(dtype) for c in ("dlin", "dquad", "rayl")))
                    for p in range(self.n_parts)]

        def const(name, p, lo=0, n=None):
            x = consts[name]
            if x is None:
                return None
            x = x[p]
            return x if n is None else x[:, lo:lo + n]

        def lin_rows(p, car, lo, n):
            """n new rows of slab p from its padded rows [lo, lo + n + 2 pad)."""
            sub = lambda x: x[:, lo:lo + n + 2 * pad]  # noqa: E731
            win = lambda key: _wrap_cols(sub(car[key][p]), cols)  # noqa: E731
            fp = None if forc[p] is None else (sub(forc[p][0]), sub(forc[p][1]), *forc[p][2:])
            return step_slab(
                win("ssh"), win("h"), win("u"), const("f", p, lo, n + 2 * pad),
                const("rts", p, lo, n + 2 * pad), dt_, inv_dc, s_div, terms, n, nx,
                (pad, cols), fb, const("mask", p, lo, n + 2 * pad), fp,
                win("t") if "t" in car else None, tropts, const("cmask", p, lo, n + 2 * pad),
                strat_w[p])

        def body_lin(car):
            new = [lin_rows(p, car, 0, R) for p in range(self.n_parts)]
            return {key: _with_halo([x[i] for x in new], pad, devs) for i, key in enumerate(keys)}

        def body_overlap(car):
            """Boundary rows first, then the exchange, then the rest
            (sharded.py:1162-1218): the same values as ``body_lin``."""
            top = [lin_rows(p, car, 0, 1) for p in range(self.n_parts)]
            bot = [lin_rows(p, car, R - 1, 1) for p in range(self.n_parts)]
            n = self.n_parts
            recv_top = [[bot[(p - 1) % n][i].to(devs[p]) for i in range(len(keys))]
                        for p in range(n)]
            recv_bot = [[top[(p + 1) % n][i].to(devs[p]) for i in range(len(keys))]
                        for p in range(n)]
            mid = [lin_rows(p, car, 1, R - 2) for p in range(n)]
            return {key: [torch.cat([recv_top[p][i], top[p][i], mid[p][i], bot[p][i],
                                     recv_bot[p][i]], 1) for p in range(n)]
                    for i, key in enumerate(keys)}

        ring = derived_ring(terms, False)[1]  # the derived planes' columns per side

        def body_nl(car):
            """Two exchange rounds (sharded.py:1220-1252), and with FB a third
            of the fresh thickness and ssh (:1306-1345)."""
            n = self.n_parts
            win = {key: [_wrap_cols(car[key][p], cols) for p in range(n)] for key in keys}
            inner = (1, 1 + R, cols, cols + nx)
            derived = [torch.stack([*f, *k2, *q2]) for f, k2, q2 in (
                derived_slab(win["h"][p], win["u"][p], const("fv", p), s_ke, s_curl,
                             *nl_terms, inner) for p in range(n))]
            derived = [_wrap_cols(x, ring) for x in _with_halo(derived, 1, devs)]
            dreg = (0, R + 2, cols - ring, cols + nx + ring)
            local_reg = (1, 1 + R, ring, ring + nx)
            fresh = [nl_continuity(win["h"][p], list(derived[p][:6]), const("rts", p), dt_,
                                   s_div, inner, dreg) for p in range(n)]
            if fb:
                sshn = _with_halo([torch.stack(f[1]) for f in fresh], 1, devs)
                hn = _with_halo([torch.stack(f[0]) for f in fresh], 1, devs)
            new = []
            for p in range(n):
                h_new, ssh_new = fresh[p]
                if fb:
                    s1, h1 = _wrap_cols(sshn[p], 1), _wrap_cols(hn[p], 1)
                    pg, pg_scale = pressure([s1[0], s1[1]], [h1[0], h1[1]], dt_, strat_w[p])
                    pg_reg = (1, 1 + R, 1, 1 + nx)
                else:
                    s, h = win["ssh"][p], win["h"][p]
                    pg, pg_scale = pressure([s[0], s[1]], [h[0], h[1]], dt_, strat_w[p])
                    pg_reg = inner
                d = derived[p]
                u_new = nl_momentum(win["u"][p], win["h"][p], list(d[:6]), list(d[6:8]),
                                    list(d[8:14]), dt_, inv_dc, terms, inner, local_reg, pg,
                                    pg_scale, pg_reg, const("mask", p), forc[p])
                out = [torch.stack(ssh_new), torch.stack(h_new), torch.stack(u_new)]
                if "t" in car:
                    out.append(torch.stack(tracer_update(
                        win["h"][p], win["u"][p], win["t"][p], h_new, dt_, inv_dc, s_div,
                        *tropts, inner, const("mask", p), const("cmask", p))))
                new.append(out)
            return {key: _with_halo([x[i] for x in new], 1, devs) for i, key in enumerate(keys)}

        if nonlinear:
            body = body_nl
        elif self.overlap and R >= 3 and not fb:
            body = body_overlap
        else:
            body = body_lin

        if objective or pad != 1:
            carry = {key: _with_halo([x[:, 1:-1] for x in local[key]], pad, devs)
                     for key in keys}
        else:
            carry = {key: list(local[key]) for key in keys}
        if objective:
            n = self.n_parts

            def step(*flat):
                car = {key: list(flat[i * n:(i + 1) * n]) for i, key in enumerate(keys)}
                out = body(car)
                return tuple(x for key in keys for x in out[key])

            flat = _checkpointed(step, tuple(x for key in keys for x in carry[key]), n_steps)
            return sum((flat[p][:, pad:-pad] ** 2).sum().to(devs[0]) for p in range(n))
        for _ in range(n_steps):
            carry = body(carry)
        if pad != 1:
            carry = {key: [x[:, pad - 1:x.shape[1] - pad + 1] for x in v]
                     for key, v in carry.items()}
        return carry

    # ---- the superstep path (sharded.py:1479-1909) ----

    def _tile(self, q, k, itemsize, nonlinear, fb, n_tr, forced, strat, row_tile=None,
              col_tile=None):
        """The superstep kernel's plan at q over tiles that divide the slab
        (rows) and the lattice (columns; at q > 1 the nonlinear kernel's
        grown tile, q - 1 halos of ``stencil_reach`` columns per side, fits
        them, csrc/nl_tiled.cuh): (row_tile, col_tile, ks) by the port's
        shared-memory formulas (the
        linear core: ``tiled_model.window_bytes`` over
        ``tiled_model.FORWARD_BUDGETS`` as ``tiled_run_loop`` sizes it, ks
        None; the nonlinear core: ``fe_step.nl_plan``), or None where no
        tile fits."""
        R, nx, sm = self.rows, self.smesh.nx, self.smesh
        nl_terms = (sm.vertex_cell_terms, sm.edge_vertex_terms) if nonlinear else None
        hm, hi = stencil_reach(sm.coriolis_terms, fb, nl_terms)
        rows = [row_tile] if row_tile is not None else _divisors(R)
        cols = [col_tile] if col_tile is not None else _divisors(nx)
        tiles = [(r, c) for r in rows for c in cols
                 if not nonlinear or q == 1 or c + 2 * hi * (q - 1) <= nx]
        if nonlinear:
            arms = dict(forced=forced, n_tracers=n_tr, strat=strat, q=q)
            ok = [t for t in tiles if fe_step.nl_smem_bytes(t, k, itemsize, fb, 1, **arms)
                  <= fe_step.SMEM_BYTES]
            return tuple(fe_step.nl_plan(R, nx, k, itemsize, fb, ok, **arms)) if ok else None
        if n_tr or strat:
            def window(rt, ct, q_, halo, k_, size):
                return tiled_model.window_bytes(rt, ct, q_, halo, k_, size, forced, n_tr, strat,
                                                fb)
        else:
            window = tiled_model.forced_window_bytes
        for budget in tiled_model.FORWARD_BUDGETS:
            fit = [(rt * ct, -(rt + 2 * hm * q) * (ct + 2 * hi * q), ct, rt) for rt, ct in tiles
                   if window(rt, ct, q, (hm, hi), k, itemsize) <= budget]
            if fit:
                *_, ct, rt = max(fit)
                return rt, ct, None
        return None

    def superstep_plan(self, n_steps: int, k: int, dtype=torch.float32, *, q=None,
                       row_tile=None, col_tile=None, nonlinear=False, fb=False, n_tracers=0,
                       forced=False, strat=False) -> dict:
        """``run_pallas``'s plan (sharded.py:1521-1566): q is the caller's or
        ``AUTO_Q``, reduced only to divide n_steps, to keep reach * q <= R
        (the halo comes from one neighbour) or to fit the kernel's shared
        memory (``_tile``), with JAX's warning where an explicit q was
        reduced; reach > R, a row tile that does not divide R and a plan
        that fits no tile raise ValueError. Returns {"q", "row_tile",
        "col_tile", "ks", "reach", "halo", "hq"}."""
        R, nx = self.rows, self.smesh.nx
        rch = reach(fb, nonlinear)
        if rch > R:
            raise ValueError(
                f"reach-{rch} dynamics (nonlinear/fb) need at least {rch} rows per device for "
                f"the one-neighbor halo exchange; got rows/device={R} — use run() or fewer "
                "devices")
        itemsize = torch.empty((), dtype=dtype).element_size()
        q_req = q
        q = AUTO_Q if q is None else q
        q = max(1, min(int(q), R // rch, n_steps))
        while True:
            while n_steps % q:
                q -= 1
            tile = self._tile(q, k, itemsize, nonlinear, fb, n_tracers, forced, strat,
                              row_tile, col_tile)
            if tile is not None or q == 1:
                break
            q -= 1
        if q_req is not None and q != int(q_req):
            warnings.warn(
                f"run_pallas reduced the requested superstep q={q_req} to q={q} (divisibility "
                f"of n_steps={n_steps}, halo limit reach*q<={R}, or VMEM fit)",
                stacklevel=4)
        if row_tile is not None and R % row_tile:
            raise ValueError(f"row_tile {row_tile} must divide local rows {R}")
        if tile is None:
            raise ValueError("no slab tile fits the kernel's shared memory "
                             f"(rows/device={R}, nx={nx}, K={k}); use run() instead")
        sm = self.smesh
        nl_terms = (sm.vertex_cell_terms, sm.edge_vertex_terms) if nonlinear else None
        halo = stencil_reach(sm.coriolis_terms, fb, nl_terms)
        return {"q": q, "row_tile": tile[0], "col_tile": tile[1], "ks": tile[2], "reach": rch,
                "halo": halo, "hq": halo[0] * q}

    def _superstep_setup(self, local, dt, n_steps, q, row_tile, col_tile, forcing, kappa,
                         upwind, strat, nonlinear, fb):
        """Everything a superstep of the slabs needs: the plan, the
        constants with hq halo rows (slab layout, and the kernels' operands
        on CUDA slabs), the scalars."""
        if nonlinear:
            self._nl_validate()
        if n_steps < 0:
            raise ValueError("n_steps must be >= 0")
        sm = self.smesh
        h0 = local["h"][0]
        dtype, k = h0.dtype, h0.shape[-1]
        n_tr = local["t"][0].shape[0] // 2 if "t" in local else 0
        plan = self.superstep_plan(n_steps, k, dtype, q=q, row_tile=row_tile,
                                   col_tile=col_tile, nonlinear=nonlinear, fb=fb,
                                   n_tracers=n_tr, forced=forcing is not None,
                                   strat=strat is not None)
        hq = plan["hq"]
        cs = self._const_slabs(hq, dtype, nonlinear)
        su = dict(plan, dtype=dtype, k=k, n_tr=n_tr, cs=cs, fb=fb, nonlinear=nonlinear,
                  n_ss=n_steps // plan["q"] if n_steps else 0,
                  scal=fused_model._scal(sm, dt, dtype),
                  nl=None, forc=None, kforc=None, tropts=None, strat_w=None)
        if nonlinear:
            su["nl"] = (*fused_model.nl_scal(sm, dtype), sm.vertex_cell_terms,
                        sm.edge_vertex_terms)
        if n_tr:
            su["tropts"] = fused_model.tracer_opts(kappa, upwind, dtype)
        if strat is not None:
            su["strat_w"] = [fused_model.kernel_strat(strat, dtype, d) for d in self.devices]
        if forcing is not None:
            if isinstance(forcing, dict):
                raise TypeError("run_pallas takes a lattice Forcing, not slabs")
            fkey = ("forcing", hq, dtype, id(forcing))
            ent = self._cache.get(fkey)
            if ent is None or ent[0] is not forcing:
                wind, idx = fused_model.forcing_setup(forcing, sm.ny2, sm.nx, dtype)
                kf = fused_model.kernel_forcing(forcing, sm, dtype, wind.device)
                ent = (forcing, self._slab(wind[..., None], hq), self._slab(idx[..., None], hq),
                       [kf._replace(wind=w[..., 0], levels=lv) for w, lv in zip(
                           self._slab(kf.wind[..., None], hq),
                           self._slab(kf.levels, hq, axis=1))])
                self._cache[fkey] = ent
                # at most 4 forcings kept (sharded.py:1586-1606): a loop that
                # makes a new Forcing each call cannot grow the cache
                held = [key for key in self._cache if key[0] == "forcing"]
                for key in held[:-4]:
                    del self._cache[key]
            coefs = fused_model.forcing_scal(forcing, dtype)
            su["forc"] = [(w, i, *coefs) for w, i in zip(ent[1], ent[2])]
            su["kforc"] = ent[3]
        return su

    def _plain_superstep(self, su, p, ext):
        """The kernel's plain version on slab p: q steps of
        ``slab.window_steps`` on the slab's extended window (``ext``, the
        state's (ssh, h, u[, t]) with hq halo rows), whose columns wrap
        periodically; returns the slab's new own rows."""
        hm, hi = su["halo"]
        c = hi * su["q"]
        cs = su["cs"]
        w = lambda x: None if x is None else _wrap_cols(x, c)  # noqa: E731
        pick = lambda name: None if cs[name] is None else w(cs[name][p])  # noqa: E731
        forc = su["forc"]
        out = window_steps(
            w(ext[0]), w(ext[1]), w(ext[2]), pick("f"), pick("rts"), *su["scal"],
            self.smesh.coriolis_terms, rows=self.rows, cols=self.smesh.nx, q=su["q"],
            halo=su["halo"], fb=su["fb"], mask_full=pick("mask"), fv_full=pick("fv"),
            nl=su["nl"],
            forc_full=None if forc is None else (w(forc[p][0]), w(forc[p][1]), *forc[p][2:]),
            tr=w(ext[3]) if len(ext) > 3 else None, tropts=su["tropts"] or (0.0, 1.0),
            cmask_full=pick("cmask") if len(ext) > 3 else None,
            strat_w=None if su["strat_w"] is None else su["strat_w"][p])
        return out

    def _launch(self, su, p, src, dst):
        """One launch of the kernel's received-halo arm on slab p: from the
        extended buffers ``src`` (ssh, h, u[, t] in slab layout) into the
        slab's rows of ``dst``, q steps."""
        cs, sm, k = su["cs"], self.smesh, su["k"]
        rx, nx = self.rows + 2 * su["hq"], sm.nx
        view = lambda b: (b[0].view(2, rx, nx), b[1], b[2].view(3, 2, rx, nx, k))  # noqa: E731
        ssh, h, u = view(src)
        out = view(dst)
        live = None if cs["live"] is None else cs["live"][p]
        tracers = None
        if su["n_tr"]:
            cm = cs["cmask"]
            tracers = fused_model.KernelTracers(
                src[3], None if cm is None or live is None else cm[p].view(2, rx, nx),
                *su["tropts"])
        forcing = None if su["kforc"] is None else su["kforc"][p]
        strat_w = None if su["strat_w"] is None else su["strat_w"][p]
        dt, inv_dc, s_div = su["scal"]
        q, hq = su["q"], su["hq"]
        tr_out = dst[3] if su["n_tr"] else None
        if su["nonlinear"]:
            fv = cs["fv"][p].view(-1, rx, nx)
            args = (ssh, h, u, cs["rts"][p].view(2, rx, nx), *sm.host_stencil, fv,
                    sm.vertex_cell_terms, sm.edge_vertex_terms, dt, inv_dc, s_div,
                    *su["nl"][:2], q)
            tile = (su["row_tile"], su["col_tile"])
            if q == 1 and not su["fb"]:
                fe_step.fe_nl_rollout(*args, live=live, tile=tile, ks=su["ks"], out=out,
                                      forcing=forcing, tracers=tracers, strat_w=strat_w,
                                      tr_out=tr_out, halo_rows=hq)
            else:
                tiled_step.tiled_nl_rollout(*args, live=live, tile=tile, ks=su["ks"],
                                            forcing=forcing, tracers=tracers, strat_w=strat_w,
                                            q=q, fb=su["fb"], halo_rows=hq, out=out,
                                            tr_out=tr_out)
        else:
            tiled_step.tiled_rollout(
                ssh, h, u, cs["f"][p].view(3, 2, rx, nx), cs["rts"][p].view(2, rx, nx),
                *sm.host_stencil, dt, inv_dc, s_div, q, row_tile=su["row_tile"],
                col_tile=su["col_tile"], q=q, halo=su["halo"], fb=su["fb"], live=live,
                forcing=forcing, tracers=tracers, strat_w=strat_w, halo_rows=hq, out=out,
                tr_out=tr_out)

    def run_pallas(self, local: dict, dt, n_steps: int, *, q: int | None = None,
                   row_tile: int | None = None, col_tile: int | None = None, forcing=None,
                   tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                   strat: Stratification | None = None, nonlinear: bool = False,
                   fb: bool = False, exchange: bool = True) -> dict:
        """The communication-avoiding rollout (sharded.py:1479): per
        superstep, one exchange of hq = reach * q halo rows per side per
        field, then q steps of each slab in one launch of the tiled kernel's
        received-halo arm (the linear core at any q: csrc/tiled_step.cu; the
        nonlinear at q = 1: csrc/nl_step.cuh, FE through fe_step's arm and FB
        through tiled_step's; at q > 1: csrc/nl_tiled.cuh), or on CPU slabs
        the kernel's plain version (``_plain_superstep``). The plan is
        ``superstep_plan``'s; ``forcing`` a lattice Forcing; the rest as for
        ``run``, whose slab dict it takes and returns. ``exchange=False``
        skips the exchanges after the first, so that the halo rows keep the
        first superstep's values: a stale-halo control for the tests, not a
        mode to run."""
        global exchanges
        su = self._superstep_setup(local, dt, n_steps, q, row_tile, col_tile, forcing,
                                   tracer_kappa, tracer_upwind, strat, nonlinear, fb)
        keys = [key for key in ("ssh", "h", "u", "t") if key in local]
        hq, R, n = su["hq"], self.rows, self.n_parts
        if su["n_ss"] == 0:
            return {key: _with_halo([x[:, 1:-1].detach().clone() for x in local[key]], 1,
                                    self.devices) for key in keys}
        with torch.no_grad():
            # the state in buffers of R + 2 hq rows, the slab's own at
            # [hq, hq + R), two sets, the halos filled in place
            cur = {}
            for key in keys:
                cur[key] = []
                for x in local[key]:
                    b = x.new_empty((x.shape[0], R + 2 * hq, *x.shape[2:]))
                    b[:, hq:hq + R] = x[:, 1:-1]
                    cur[key].append(b)
                _fill_halos(cur[key], hq, R)
                exchanges += 1
            nxt = {key: [x.clone() for x in v] for key, v in cur.items()}
            cuda = [d.type == "cuda" for d in self.devices]
            for s in range(su["n_ss"]):
                if exchange and s > 0:
                    for key in keys:
                        _fill_halos(cur[key], hq, R)
                        exchanges += 1
                for p in range(n):
                    src = [cur[key][p] for key in keys]
                    if cuda[p]:
                        self._launch(su, p, src, [nxt[key][p] for key in keys])
                    else:
                        for key, x in zip(keys, self._plain_superstep(su, p, src)):
                            nxt[key][p][:, hq:hq + R] = x
                cur, nxt = nxt, cur
            return {key: _with_halo([x[:, hq:hq + R] for x in v], 1, self.devices)
                    for key, v in cur.items()}

    def objective_pallas(self, local: dict, dt, n_steps: int, *, q: int | None = None,
                         row_tile: int | None = None, col_tile: int | None = None,
                         forcing=None, tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                         strat: Stratification | None = None, nonlinear: bool = False,
                         fb: bool = False):
        """Sum(ssh_final^2) of ``run_pallas``'s rollout, differentiable
        (sharded.py:1888): a ``torch.autograd.Function`` per slab and
        superstep whose forward is the kernel (on CPU slabs its plain
        version) and whose backward replays the plain superstep under
        autograd from the saved extended inputs; the exchange is a
        ``torch.cat`` whose backward returns the halo cotangents to the
        slabs that sent the rows; two-level sqrt checkpointing over
        supersteps. The input halo rows are unused, so the gradient lands on
        the slabs' own rows and ``gather`` reassembles it."""
        su = self._superstep_setup(local, dt, n_steps, q, row_tile, col_tile, forcing,
                                   tracer_kappa, tracer_upwind, strat, nonlinear, fb)
        keys = [key for key in ("ssh", "h", "u", "t") if key in local]
        hq, R, n, devs = su["hq"], self.rows, self.n_parts, self.devices

        def step(*flat):
            own = {key: list(flat[i * n:(i + 1) * n]) for i, key in enumerate(keys)}
            ext = {key: _with_halo(v, hq, devs) for key, v in own.items()}
            new = [_Superstep.apply(self, su, p, *(ext[key][p] for key in keys))
                   for p in range(n)]
            return tuple(new[p][i] for i in range(len(keys)) for p in range(n))

        flat = tuple(x[:, 1:-1] for key in keys for x in local[key])
        flat = _checkpointed(step, flat, su["n_ss"])
        return sum((flat[p] ** 2).sum().to(devs[0]) for p in range(n))


class _Superstep(torch.autograd.Function):
    """One superstep of one slab: forward the kernel's received-halo arm
    (CPU slabs: its plain version), backward the plain superstep's vector-
    Jacobian product, replayed from the saved extended inputs (sharded.py:
    1757-1838's custom VJP)."""

    @staticmethod
    def forward(ctx, model, su, p, *ext):
        global objective_supersteps
        objective_supersteps += 1
        ctx.model, ctx.su, ctx.p = model, su, p
        ctx.save_for_backward(*ext)
        hq, R = su["hq"], model.rows
        if ext[0].device.type == "cuda":
            src = [x.contiguous() for x in ext]
            dst = [torch.empty_like(x) for x in src]
            model._launch(su, p, src, dst)
            return tuple(x[:, hq:hq + R].contiguous() for x in dst)
        return tuple(model._plain_superstep(su, p, ext))

    @staticmethod
    def backward(ctx, *grads):
        ext = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.model._plain_superstep(ctx.su, ctx.p, ext)
        d = torch.autograd.grad(out, ext, grads, allow_unused=True)
        return (None, None, None, *d)
