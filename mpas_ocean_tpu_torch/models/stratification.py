"""Layered (isopycnal) stratification: multi-layer baroclinic dynamics.

Counterpart of mpas_ocean_tpu/models/stratification.py (``Stratification``,
``make_stratification``, ``montgomery_potential``,
``baroclinic_wave_speeds``), as torch tensors and numpy. Each layer k
carries a density rho_k, and its pressure gradient is the gradient of the
layer's Montgomery potential

    Phi_k = g eta - sum_{l<k} g'_{lk} h_l,      g'_{lk} = g (rho_k - rho_l) / rho0,

written Phi = g eta + h @ W with W a (K, K) strictly lower triangular
matrix. With equal densities W = 0 and Phi_k = g eta for every k: the
barotropic stack of the unstratified model. The kernels' stratified arms
(csrc/fe_step.cu, csrc/tiled_step.cu, ``kStrat``) take any dense W, not
only this form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import GRAVITY
from .forcing import RHO0

__all__ = ["Stratification", "baroclinic_wave_speeds", "make_stratification",
           "montgomery_potential", "stratification_from_numpy", "stratification_to_numpy"]

_FIELDS = ("phi_weights", "densities")


@dataclass(frozen=True)
class Stratification:
    """Static column coupling for layered baroclinic dynamics:
    ``phi_weights`` is the (K, K) matrix W with W[l, k] =
    -g (rho_k - rho_l) / rho0 for l < k and 0 otherwise, so that the
    Montgomery potential is Phi = g * eta[..., None] + h @ W; ``densities``
    (K,) is kept for diagnostics."""

    phi_weights: torch.Tensor
    densities: torch.Tensor

    def to(self, device) -> "Stratification":
        return Stratification(self.phi_weights.to(device), self.densities.to(device))


def _np_dtype(dtype):
    """A numpy dtype from a numpy or torch one (None: float64)."""
    if dtype is None:
        return np.float64
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return dtype


def make_stratification(densities, rho0: float = RHO0, g: float = GRAVITY,
                        dtype=None) -> Stratification:
    """A :class:`Stratification` from per-layer densities, top first (JAX
    models/stratification.py:60-86, bit for bit): W built in float64 and
    rounded once to ``dtype`` (numpy or torch; float64 by default).
    Densities must be 1-D and non-decreasing downward (a statically stable
    column); equal densities are allowed (those layer pairs decouple)."""
    rho = np.asarray(densities, dtype=np.float64)
    if rho.ndim != 1:
        raise ValueError(f"densities must be 1-D (K,), got shape {rho.shape}")
    if np.any(np.diff(rho) < 0):
        raise ValueError(
            "densities must be non-decreasing downward (stable column); "
            f"got {rho.tolist()}"
        )
    k = rho.shape[0]
    dtype = _np_dtype(dtype)
    w = np.zeros((k, k), dtype=np.float64)
    for kk in range(k):
        for ll in range(kk):
            w[ll, kk] = -g * (rho[kk] - rho[ll]) / rho0
    return Stratification(phi_weights=torch.from_numpy(w.astype(dtype)),
                          densities=torch.from_numpy(rho.astype(dtype)))


def montgomery_potential(ssh, layer_thickness, strat: Stratification):
    """Phi = g * ssh[..., None] + h @ W on any layout whose level axis is last
    (unstructured (nCells, K) or lattice (2, ny2, nx, K)), W cast to h's
    dtype and device, in the JAX order (models/stratification.py:89-99)."""
    h = layer_thickness
    g = torch.tensor(GRAVITY, dtype=h.dtype, device=h.device)
    w = strat.phi_weights.to(dtype=h.dtype, device=h.device)
    return g * ssh[..., None] + torch.matmul(h, w)


def baroclinic_wave_speeds(densities, layer_depths, rho0: float = RHO0,
                           g: float = GRAVITY) -> np.ndarray:
    """Linear gravity-wave mode speeds of the stratified column at rest
    (flat bottom, no rotation), fastest first: the square roots of the
    eigenvalues of A[k, l] = H_k dPhi_k/dh_l (JAX models/stratification.py:
    102-122). Mode 0 is the barotropic ~sqrt(g H_total); the others are the
    internal waves (two layers: c1^2 ~ g' H1 H2 / (H1 + H2))."""
    rho = np.asarray(densities, dtype=np.float64)
    h = np.asarray(layer_depths, dtype=np.float64)
    k = rho.shape[0]
    dphi = np.full((k, k), g)
    for kk in range(k):
        for ll in range(kk):
            dphi[kk, ll] -= g * (rho[kk] - rho[ll]) / rho0
    a = h[:, None] * dphi
    eig = np.linalg.eigvals(a)
    return np.sort(np.sqrt(np.abs(eig.real)))[::-1]


def stratification_from_numpy(d: dict) -> Stratification:
    """A Stratification from a dict of the JAX Stratification's fields as
    numpy arrays, bit for bit."""
    return Stratification(**{f: torch.from_numpy(np.array(d[f])) for f in _FIELDS})


def stratification_to_numpy(strat: Stratification) -> dict:
    return {f: getattr(strat, f).detach().cpu().numpy() for f in _FIELDS}
