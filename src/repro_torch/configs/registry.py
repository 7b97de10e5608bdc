"""DLRM config registry (port of ``repro.configs.registry``, DLRM part)."""

from __future__ import annotations

from repro_torch.configs import dlrm_qr, dlrm_tt

DLRM_CONFIGS = {
    "dlrm-qr": dlrm_qr.CONFIG,
    "dlrm-qr-smoke": dlrm_qr.SMOKE,
    "dlrm-dense": dlrm_qr.DENSE_BASELINE,
    "dlrm-dense-smoke": dlrm_qr.DENSE_SMOKE,
    "dlrm-tt": dlrm_tt.CONFIG,
    "dlrm-tt-smoke": dlrm_tt.SMOKE,
}


def get_dlrm(name: str):
    """Resolve a DLRM config id."""
    if name not in DLRM_CONFIGS:
        raise KeyError(f"unknown dlrm config {name!r}; choose from {sorted(DLRM_CONFIGS)}")
    return DLRM_CONFIGS[name]
