"""Carry parameters from ``repro`` to the port.

``params_from_numpy(tree, device)`` turns the params pytree of
``repro.models.dlrm.init_dlrm`` — its leaves as numpy arrays, or anything
``numpy.asarray`` takes — into the port's params:
``{"bottom": [...], "top": [...], "tables": [{"q","r"} | {"table"}]}``.
Both packages then compute on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod


def _tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":          # numpy has no bf16 torch can read
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_numpy(tree: dict, device=None) -> dict:
    dev = device_mod.resolve(device)
    mlp = lambda layers: [{k: _tensor(v, dev) for k, v in p.items()} for p in layers]
    return {
        "bottom": mlp(tree["bottom"]),
        "top": mlp(tree["top"]),
        "tables": [{k: _tensor(v, dev) for k, v in t.items()} for t in tree["tables"]],
    }
