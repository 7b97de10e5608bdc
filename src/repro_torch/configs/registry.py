"""DLRM config registry (port of ``repro.configs.registry``, DLRM part)."""

from __future__ import annotations

from repro_torch import TT_NEXT
from repro_torch.configs import dlrm_qr

DLRM_CONFIGS = {
    "dlrm-qr": dlrm_qr.CONFIG,
    "dlrm-qr-smoke": dlrm_qr.SMOKE,
    "dlrm-dense": dlrm_qr.DENSE_BASELINE,
    "dlrm-dense-smoke": dlrm_qr.DENSE_SMOKE,
}


def get_dlrm(name: str):
    """Resolve a DLRM config id."""
    if name in ("dlrm-tt", "dlrm-tt-smoke"):
        raise NotImplementedError(TT_NEXT)
    if name not in DLRM_CONFIGS:
        raise KeyError(f"unknown dlrm config {name!r}; choose from {sorted(DLRM_CONFIGS)}")
    return DLRM_CONFIGS[name]
