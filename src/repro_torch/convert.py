"""Carry parameters from ``repro`` to the port.

``params_from_numpy(tree, device)`` turns the params pytree of
``repro.models.dlrm.init_dlrm`` — its leaves as numpy arrays, or anything
``numpy.asarray`` takes — into the port's params:
``{"bottom": [...], "top": [...], "tables": [{"q","r"} | {"table"} |
{"g1","g2","g3"}]}``; ``tables_from_numpy(tables, device)`` does the same
for a list of single tables (``embedding_bag.init_tables``'s output), and
``opt_state_from_numpy(state, device)`` for ``repro.train.optimizer``'s
state (``mu`` and ``nu`` shaped like the params, ``step``), and
``hot_tiers_from_numpy(tiers, device)`` for ``repro``'s hot-tier dicts
(``{"hot_table", "hot_slot"}`` per table, the slot maps int32), and
``lm_params_from_numpy(tree, device)`` for an LM's tree
(``repro.models.transformer``'s ``init_lm``: ``embed``, the stacked
``layers``, ``final_norm``, optional ``head``; ``zamba2``'s and ``xlstm``'s,
whose ``blocks`` is a list; and a cache or a list of recurrent states:
dicts, lists and tuples kept as they are).  Both packages then
compute on the same weights and resume from the same optimizer state.
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


def tables_from_numpy(tables, device=None) -> list[dict]:
    dev = device_mod.resolve(device)
    return [{k: _tensor(v, dev) for k, v in t.items()} for t in tables]


def params_from_numpy(tree: dict, device=None) -> dict:
    return {key: tables_from_numpy(tree[key], device)
            for key in ("bottom", "top", "tables")}


def opt_state_from_numpy(state: dict, device=None) -> dict:
    dev = device_mod.resolve(device)
    return {"mu": params_from_numpy(state["mu"], device),
            "nu": params_from_numpy(state["nu"], device),
            "step": _tensor(state["step"], dev)}


def hot_tiers_from_numpy(tiers, device=None) -> list[dict]:
    dev = device_mod.resolve(device)
    return [{"hot_table": _tensor(t["hot_table"], dev),
             "hot_slot": _tensor(t["hot_slot"], dev).to(torch.int32)} for t in tiers]


def lm_params_from_numpy(tree, device=None):
    """``repro``'s LM params, caches or states (dicts, lists and tuples of
    numpy leaves, bf16 included) as the port's: the same nesting, tensors
    on ``device``."""
    dev = device_mod.resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _tensor(node, dev)

    return walk(tree)
