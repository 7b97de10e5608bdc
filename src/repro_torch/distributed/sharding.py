"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

Models annotate tensors with *logical* axis names ("batch", "qrow", ...); a
rules table maps logical names to mesh axes.  ``repro`` runs SPMD inside one
process: ``jit`` places each array by its ``NamedSharding`` and
``constrain`` pins an intermediate's layout.  The port runs one process per
mesh rank (``launch.mesh.make_mesh`` / ``spawn``): every tensor a rank holds
already is its local shard, so a spec says which slice of the global tensor
that is (``local_shard``) and ``constrain`` only checks its arguments.

``P`` stands in for ``jax.sharding.PartitionSpec``: one entry per tensor dim,
each None (replicated), a mesh axis name, or a tuple of names.

A tree of params lies on a mesh by its logical axes (``tree_specs``, one
spec per leaf in flatten order): ``shard_tree`` takes this rank's block of
every leaf from the full logical tree (``repro``'s ``shardings_for_tree``
plus ``device_put``), ``gather`` rebuilds one full leaf from the ranks'
blocks (a checkpoint's logical array), ``full_shape`` gives its shape.

An LM trains with FSDP over ``data`` (``lm_param_rules``, ``repro``'s
``PARAM_RULES``): every leaf's ``embed`` dim is stored split over ``data``
where ``data`` divides it, and the model gathers a leaf whole at its use
(``use_fsdp`` while the loss runs, ``fsdp_take`` for the leaves outside the
layers, ``fsdp_layers`` inside each layer's recompute), its gradient coming
back reduce-scattered (``collectives.fsdp_gather``).  Serving keeps
``embed`` whole, as ``repro``'s ``serve_params`` does.

A fused tensor, whose dim concatenates parts that split differently (the
Mamba2 ``in_proj``: z, x, B, C and dt), takes a ``Parts`` entry in its spec:
the rank's columns are the concatenation of its block of each split part and
the whole of each part every head shares.  The sub-quadratic models lay
their fused tensors out so themselves (``models.mamba2.layout``,
``models.xlstm.block_layout``), and ``configs.registry.lm_axes`` puts their
specs in place of those leaves' axes, each dim a layout leaves whole and
whose logical axis is ``embed`` left to the rules (a ``Logical`` entry,
``given``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Mapping, Sequence

import torch

from repro_torch import tree as tree_mod

_state = threading.local()


class P(tuple):
    """Partition spec: ``P("model", None)`` shards dim 0 over ``model`` and
    replicates dim 1."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Logical:
    """A spec entry given outright that is left to the rules: the dim
    resolves as a dim of logical axis ``name`` would (``tree_specs``)."""

    name: str


@dataclasses.dataclass(frozen=True)
class Parts:
    """A spec entry for a fused dim: ``parts`` are its consecutive pieces,
    each ``(width, split)`` in the logical tensor; a split piece is split
    over the mesh ``axis`` in equal contiguous blocks, a whole one is held
    whole by every rank.  The rank's block of the dim is its block of each
    split piece and each whole piece, concatenated in order."""

    axis: str
    parts: tuple

    @property
    def width(self) -> int:
        return sum(w for w, _ in self.parts)

    def local_widths(self, n: int) -> list[int]:
        """Each piece's width on a rank of an axis of ``n``."""
        return [w // n if split else w for w, split in self.parts]


# Default production rules (single-pod).  "pod" is prepended to batch for the
# multi-pod mesh.  None = replicated along that logical axis.
DEFAULT_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("data",),
    "seq": None,
    "kvseq": ("model",),
    "embed": None,
    "heads": ("model",),
    "kv_heads": None,
    "head_dim": None,
    "ffn": ("model",),
    "vocab": ("model",),
    "qrow": ("model",),     # Q-table rows = the "bank group" axis
    "rrow": None,            # R table = replicated LUT tier
    "experts": ("model",),
    "expert_ffn": None,
    "layers": None,
    "state": None,
    "mlp": None,
    "table": None,           # DLRM table index axis
}


def multi_pod_rules(rules: Mapping[str, tuple[str, ...] | None] | None = None) -> dict:
    """Extend batch-like axes over the 'pod' axis for the 2-pod mesh."""
    base = dict(DEFAULT_RULES if rules is None else rules)
    for k in ("batch",):
        v = base.get(k) or ()
        if "pod" not in v:
            base[k] = ("pod",) + tuple(v)
    return base


# Parameter (at-rest) rules: TP over `model`, FSDP over `data`.
PARAM_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": None,
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "ffn": ("model",),
    "vocab": ("model",),
    "qrow": ("model",),
    "rrow": None,
    "experts": ("model",),
    "expert_ffn": ("model",),
    "layers": None,
    "state": None,
    "mlp": ("model",),
    "table": None,
}


# A rules entry of the port's: logical-axes suffixes whose tensors stay
# whole whatever their dims' rules say (``lm_param_rules``: the MoE router).
WHOLE = "whole"


# The port's at-rest layout of a training run: ``PARAM_RULES`` with ``embed``
# and ``mlp`` kept whole.  ``repro`` stores those dims split (FSDP over
# ``data``, the MLPs over ``model``) and XLA gathers them before every use;
# the two-level GnR reads its tables as ``P(model, None)`` / ``P()`` (its
# ``shard_map`` in_specs) and the head reads whole MLPs, so the port keeps
# them in the layout that is computed on: the same result, no gather a step.
TRAIN_PARAM_RULES: dict[str, tuple[str, ...] | None] = {**PARAM_RULES, "embed": None,
                                                        "mlp": None}

# The LM's at-rest layout in training, ``repro``'s ``PARAM_RULES``: tensor
# parallelism over ``model`` for ``heads``, ``kv_heads``, ``ffn``, ``vocab``
# and ``qrow`` (the Q shard a rank's token partial reads), ``rrow``
# replicated, and FSDP over ``data`` on ``embed``.  Serving keeps ``embed``
# whole (``repro``'s ``serve_params``).  ``lm_param_rules`` narrows both to
# whole heads for one config and mesh.
LM_TRAIN_PARAM_RULES: dict[str, tuple[str, ...] | None] = dict(PARAM_RULES)
LM_SERVE_PARAM_RULES: dict[str, tuple[str, ...] | None] = {**PARAM_RULES, "embed": None}

# the axis over which an LM's training layout stores ``embed`` split
FSDP_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """This rank's share of an attention block under tensor parallelism:
    q heads ``[q0, q0 + q)``, and the kv heads ``[kv0, kv0 + kv)`` they
    read.  ``kv_local`` says the kv projections are split over the axis
    (this rank holds exactly its kv heads); otherwise they are whole on
    every rank and the rank slices its heads out of them."""

    q0: int
    q: int
    kv0: int
    kv: int
    kv_local: bool


def head_split(cfg, mesh, axis: str = "model") -> HeadSplit | None:
    """This rank's ``HeadSplit`` of ``cfg``'s attention over ``axis``, or
    None where the block runs replicated (no such axis, or the q heads do
    not divide it: ``repro``'s first-fit resolution keeps them whole).
    Splits only at head granularity: the kv projections split where
    ``kv_heads`` divides the axis, and stay whole where it does not, each
    rank then reading the one kv head its q heads share.  Raises where a
    rank's q heads would straddle two kv groups."""
    if mesh is None or axis not in mesh.shape:
        return None
    m = mesh.shape[axis]
    h, kh = cfg.num_heads, cfg.kv_heads
    if h % m:
        return None
    hl, group, s = h // m, h // kh, mesh.axis_index(axis)
    if kh % m == 0:
        return HeadSplit(q0=s * hl, q=hl, kv0=s * (kh // m), kv=kh // m, kv_local=True)
    if group % hl:
        raise ValueError(
            f"{cfg.name}: {h} q heads in {kh} kv groups of {group} over a {axis} axis of {m}: "
            f"a rank's {hl} q heads would straddle two kv groups")
    return HeadSplit(q0=s * hl, q=hl, kv0=s * hl // group, kv=1, kv_local=False)


def cache_block(cfg, mesh, batch: int, max_len: int) -> tuple:
    """The shape of this rank's block of the LM's KV cache of ``batch``
    sequences (the global batch) and ``max_len`` positions on ``mesh``
    (None: the whole cache), ``(L, B_local, max_len, kv_local, D)``:
    ``B_local`` the rank's block of ``batch`` over ``batch_axes``,
    ``kv_local`` the kv heads its q heads read (``head_split``: its block of
    them, its one kv head where the kv projections stay whole, all of them
    where the block runs replicated).  The positions stay whole on every
    rank, where ``repro``'s at-rest layout splits ``kvseq`` over ``model``
    (the same values, another placement)."""
    return cfg.num_layers, batch_rows(batch, mesh), max_len, cache_heads(cfg, mesh), cfg.head_dim_


def data_ranks(mesh) -> int:
    """The ranks over which ``mesh`` splits the batch (``batch_axes``); 1
    without a mesh."""
    return math.prod(mesh.shape[ax] for ax in batch_axes(mesh)) if mesh is not None else 1


def batch_split(batch: int, mesh) -> tuple[str, ...]:
    """The batch axes of ``mesh`` (``batch_axes``) that split a global
    ``batch``: taken first-fit while their product divides it, as
    ``resolve_spec`` resolves a dim, so that a batch the data ranks do not
    divide (``long_500k``'s one sequence) stays whole on every rank of the
    axes left out."""
    axes, n = [], 1
    for ax in batch_axes(mesh) if mesh is not None else ():
        if batch % (n * mesh.shape[ax]) == 0:
            axes.append(ax)
            n *= mesh.shape[ax]
    return tuple(axes)


def batch_rows(batch: int, mesh) -> int:
    """This rank's rows of a global ``batch`` on ``mesh``: its block over
    the axes that split it (``batch_split``)."""
    return batch // math.prod(mesh.shape[ax] for ax in batch_split(batch, mesh))


def cache_heads(cfg, mesh) -> int:
    """The kv heads of this rank's cache block (``cache_block``): those
    ``head_split`` gives it, or all of them where the block runs
    replicated (no mesh, or heads the ``model`` axis does not split)."""
    split = head_split(cfg, mesh)
    return cfg.kv_heads if split is None else split.kv


def expert_split(cfg, mesh, axis: str = "model") -> bool:
    """Whether ``cfg``'s expert stacks split over ``axis`` (``lm_param_rules``
    places ``experts`` there where the axis divides ``num_experts``; else
    the stacks are whole on every rank and each takes its block of the
    padded stack in the call, ``moe.apply_moe``)."""
    return (mesh is not None and axis in mesh.shape
            and cfg.num_experts % mesh.shape[axis] == 0)


def ffn_split(cfg, mesh, axis: str = "model") -> bool:
    """Whether ``cfg``'s MLP splits its ``d_ff`` over ``axis`` (else it runs
    replicated, as ``resolve_spec`` leaves a dim the axis does not divide)."""
    return mesh is not None and axis in mesh.shape and cfg.d_ff % mesh.shape[axis] == 0


@dataclasses.dataclass(frozen=True)
class BlockSplit:
    """This rank's block ``[lo, lo + n)`` of a block's units (heads, or the
    hidden units of an MLP) split over an axis in equal contiguous
    blocks."""

    lo: int
    n: int


def block_split(size: int, mesh, axis: str = "model") -> BlockSplit | None:
    """This rank's ``BlockSplit`` of ``size`` units over ``axis``, or None
    where the block runs replicated: no mesh or no such axis, an axis of one
    rank (the whole block is the rank's: the single card's code path), or a
    ``size`` the axis does not divide (``repro``'s first-fit resolution
    keeps such a dim whole)."""
    if mesh is None or axis not in mesh.shape or mesh.shape[axis] == 1:
        return None
    m = mesh.shape[axis]
    if size % m:
        return None
    n = size // m
    return BlockSplit(lo=mesh.axis_index(axis) * n, n=n)


def lm_param_rules(cfg, mesh, *, serve: bool = False) -> dict:
    """``LM_TRAIN_PARAM_RULES`` (``serve``: ``LM_SERVE_PARAM_RULES``, the
    same with ``embed`` whole) for ``cfg`` on ``mesh``: ``heads`` and
    ``kv_heads`` replicated where ``head_split`` keeps them whole (the
    flattened ``heads * head_dim`` dim may divide an axis the heads do not);
    an MoE's stacks split over ``model`` by ``experts`` only (never by
    ``expert_ffn``: whole where the axis does not divide the experts,
    ``expert_split``), and its router whole on every rank (``WHOLE``: each
    rank routes its tokens over all experts; ``repro`` stores it split and
    XLA gathers it before use)."""
    rules = dict(LM_SERVE_PARAM_RULES if serve else LM_TRAIN_PARAM_RULES, expert_ffn=None)
    rules[WHOLE] = (("embed", "experts"),)
    split = head_split(cfg, mesh)
    if split is None:
        rules["heads"] = None
    if split is None or not split.kv_local:
        rules["kv_heads"] = None
    return rules


def multi_pod_param_rules(rules: Mapping | None = None) -> dict:
    """FSDP additionally over 'pod' for the 2-pod mesh."""
    base = dict(PARAM_RULES if rules is None else rules)
    v = base.get("embed") or ()
    if "pod" not in v:
        base["embed"] = ("pod",) + tuple(v)
    return base


def resolve_spec(
    mesh,
    shape: Sequence[int],
    logical_axes: Sequence[str | None],
    rules: Mapping[str, tuple[str, ...] | None],
) -> P:
    """First-fit spec resolution with divisibility + duplicate-axis dropping.

    For each tensor dim, the rule's mesh axes are applied only if (a) the axis
    is not already used by an earlier dim of the same tensor and (b) the dim
    size is divisible by the product of the accepted axes.  ``mesh`` is
    anything with a ``shape`` mapping of axis name -> size.  A tensor whose
    logical axes end with one of the ``rules[WHOLE]`` tuples is replicated.
    """
    if any(len(w) <= len(logical_axes) and tuple(logical_axes[len(logical_axes) - len(w):])
           == tuple(w) for w in rules.get(WHOLE, ())):
        return P(*([None] * len(shape)))
    used: set[str] = set()
    parts: list = []
    for dim, ax in zip(shape, logical_axes):
        ent = rules.get(ax) if ax else None
        if not ent:
            parts.append(None)
            continue
        accepted: list[str] = []
        prod = 1
        for mesh_ax in ent:
            if mesh_ax in used or mesh_ax not in mesh.shape:
                continue
            size = mesh.shape[mesh_ax]
            if dim % (prod * size) == 0:
                accepted.append(mesh_ax)
                prod *= size
        used.update(accepted)
        if not accepted:
            parts.append(None)
        elif len(accepted) == 1:
            parts.append(accepted[0])
        else:
            parts.append(tuple(accepted))
    return P(*parts)


@contextlib.contextmanager
def use_rules(mesh, rules: Mapping[str, tuple[str, ...] | None] | None):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, dict(rules) if rules else None)
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def model_mesh(mesh=None):
    """``mesh`` (default the active one) where it has a ``model`` axis, the
    LM's tensor-parallel axis; else None."""
    mesh = current_mesh() if mesh is None else mesh
    return mesh if mesh is not None and "model" in mesh.shape else None


def current_rules() -> dict | None:
    ctx = getattr(_state, "ctx", None)
    return ctx[1] if ctx else None


def spec_for(logical_axes: Sequence[str | None]) -> P:
    """PartitionSpec for a tuple of logical axis names under current rules.

    Mesh axes are assigned first-come-first-served across the tensor's dims
    (a mesh axis may appear at most once in a spec)."""
    rules = current_rules()
    if rules is None:
        return P()
    used: set[str] = set()
    parts = []
    for ax in logical_axes:
        ent = rules.get(ax) if ax else None
        ent = tuple(a for a in (ent or ()) if a not in used)
        used.update(ent)
        if not ent:
            parts.append(None)
        elif len(ent) == 1:
            parts.append(ent[0])
        else:
            parts.append(tuple(ent))
    return P(*parts)


def constrain(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """``repro``'s ``with_sharding_constraint`` by logical axes, as a checked
    identity.  In the port's SPMD processes ``x`` already is this rank's
    local shard, so there is no layout to pin: the call checks that one
    logical axis is named per dim (as ``repro`` does under a mesh) and
    returns ``x``.  No-op without rules or mesh."""
    if current_mesh() is None or current_rules() is None:
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"{len(logical_axes)} axes for rank-{x.dim()} tensor")
    return x


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shard(t: torch.Tensor, mesh, spec: Sequence) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec`` (one entry
    per leading dim; missing entries replicate), as ``jit`` would hand it to
    the rank's device: each sharded dim is split into equal contiguous
    blocks, ordered by the rank's coordinates along the named mesh axes
    (major to minor, as ``NamedSharding`` orders a tuple of axes).  A
    sharded block comes back as this rank's own copy, so the caller may free
    the global tensor; a replicated tensor comes back as it is."""
    out = t
    for d, entry in enumerate(spec):
        if isinstance(entry, Parts):
            out = _parts_block(out, d, entry, mesh)
            continue
        axes = _axes(entry)
        if not axes:
            continue
        n, pos = 1, 0
        for ax in axes:
            n *= mesh.shape[ax]
            pos = pos * mesh.shape[ax] + mesh.axis_index(ax)
        size = t.shape[d]
        if n == 1:
            continue
        if size % n:
            raise ValueError(f"dim {d} of size {size} does not split over "
                             f"{axes} ({n} blocks)")
        block = size // n
        out = out.narrow(d, pos * block, block)
    return out if out is t else out.clone()


def _parts_block(t: torch.Tensor, d: int, entry: Parts, mesh) -> torch.Tensor:
    """This rank's block of dim ``d`` of ``t`` under the ``Parts`` entry."""
    n = mesh.shape[entry.axis]
    if t.shape[d] != entry.width:
        raise ValueError(f"dim {d} of size {t.shape[d]} is not the {entry.width} of {entry}")
    if n == 1:
        return t
    pos, at, pieces = mesh.axis_index(entry.axis), 0, []
    for w, split in entry.parts:
        if split and w % n:
            raise ValueError(f"a part of {w} does not split over {entry.axis} ({n} blocks)")
        pieces.append(t.narrow(d, at + pos * (w // n), w // n) if split else t.narrow(d, at, w))
        at += w
    return torch.cat(pieces, dim=d)


def spec_pieces(local: torch.Tensor, spec: Sequence, mesh) -> list:
    """``local`` (this rank's block under ``spec``) as ``(piece, axes)``
    pairs: the mesh axes of size > 1 that split each piece, so that a sum
    over the pieces' entries counts every logical entry once when each
    piece's sum is psummed over its axes (the optimizer's global norm).  A
    ``Parts`` dim gives one piece a part (its whole parts are not split by
    its axis); any other leaf is one piece."""
    named = [ax for e in spec if not isinstance(e, Parts) for ax in _axes(e)]
    fused = [(d, e) for d, e in enumerate(spec) if isinstance(e, Parts)]
    base = tuple(ax for ax in mesh.shape if ax in named and mesh.shape[ax] > 1)
    if not fused:
        return [(local, base)]
    [(d, entry)] = fused
    n = mesh.shape[entry.axis]
    out = []
    for piece, (_, split) in zip(torch.split(local, entry.local_widths(n), dim=d), entry.parts):
        axes = set(base) | ({entry.axis} if split and n > 1 else set())
        out.append((piece, tuple(ax for ax in mesh.shape if ax in axes)))
    return out


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes of size > 1 that split the batch under ``DEFAULT_RULES``
    (``data``; an axis the rule does not name, such as ``pod``, replicates
    it)."""
    return tuple(ax for ax in (DEFAULT_RULES["batch"] or ())
                 if ax in mesh.shape and mesh.shape[ax] > 1)


def _is_axes(a) -> bool:
    return isinstance(a, tuple) and all(isinstance(x, (str, type(None))) for x in a)


def tree_specs(tree, axes_tree, mesh, rules: Mapping) -> list[P]:
    """One spec per leaf of ``tree`` (flatten order): ``resolve_spec`` of
    the leaf's shape and its logical axes in ``axes_tree`` (a tree of the
    same nesting whose leaves are tuples of axis names, or a ``P``: that
    spec outright).  A leaf without
    axes (``None``, an empty tuple, or a subtree ``axes_tree`` does not
    describe) is replicated."""
    out: list[P] = []

    def walk(t, a):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], a.get(k) if isinstance(a, dict) else None)
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, a[i] if isinstance(a, (list, tuple)) and not _is_axes(a)
                     and i < len(a) else None)
        elif t is not None:
            if isinstance(a, P):            # a spec given outright (``registry.lm_axes``)
                out.append(_resolve_given(a, t.shape, mesh, rules))
            elif _is_axes(a) and len(a) == t.dim():
                out.append(resolve_spec(mesh, t.shape, a, rules))
            else:
                out.append(P())

    walk(tree, axes_tree)
    return out


def given(spec: P, logical: Sequence, names: Sequence[str] = ("embed",)) -> P:
    """``spec`` given outright for a leaf of ``logical`` axes (one entry a
    dim, missing entries whole), with each dim it leaves whole whose logical
    axis is in ``names`` left to the rules (``Logical``): a layout that
    places a fused leaf's columns by head leaves its ``embed`` dim to the
    training rules' FSDP."""
    ents = list(spec) + [None] * (len(logical) - len(spec))
    return P(*(Logical(ax) if e is None and ax in names else e
               for e, ax in zip(ents, logical)))


def _resolve_given(spec: P, shape, mesh, rules: Mapping) -> P:
    """``spec`` with each ``Logical`` entry resolved by ``rules`` as
    ``resolve_spec`` resolves a dim (first fit, divisibility), past the mesh
    axes its other entries name; None where nothing fits."""
    if not any(isinstance(e, Logical) for e in spec):
        return spec
    used = {ax for e in spec if not isinstance(e, Logical)
            for ax in ((e.axis,) if isinstance(e, Parts) else _axes(e))}
    out = []
    for dim, e in zip(shape, spec):
        if not isinstance(e, Logical):
            out.append(e)
            continue
        got = resolve_spec(mesh, (dim,), (e.name,),
                           {e.name: tuple(a for a in (rules.get(e.name) or ()) if a not in used)})
        used.update(_axes(got[0]))
        out.append(got[0])
    return P(*out)


def fsdp_dim(spec: Sequence, mesh) -> int | None:
    """The dim of a leaf's ``spec`` that is split over ``FSDP_AXIS`` alone,
    or None where none is or the axis has one rank (the leaf is whole there).
    A dim split over ``FSDP_AXIS`` and another axis together raises."""
    if FSDP_AXIS not in mesh.shape or mesh.shape[FSDP_AXIS] == 1:
        return None
    for d, e in enumerate(spec):
        if isinstance(e, Parts) or FSDP_AXIS not in _axes(e):
            continue
        if _axes(e) != (FSDP_AXIS,):
            raise ValueError(f"dim {d} of {spec} splits over {FSDP_AXIS} with another axis")
        return d
    return None


def _fsdp_leaf(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    from repro_torch.distributed import collectives

    d = fsdp_dim(spec, mesh)
    return x if d is None else collectives.fsdp_gather(x, mesh, FSDP_AXIS, d)


def fsdp_gather_tree(sub, specs, mesh, *, drop: int = 0):
    """``sub`` (a subtree of this rank's params; ``specs`` the same
    nesting of their specs) with every leaf that ``specs`` split over
    ``FSDP_AXIS`` gathered whole along that dim (``collectives.fsdp_gather``),
    each spec's first ``drop`` entries dropped first (a layer's leaves, taken
    from a stack whose specs lead with the ``layers`` entry); the other
    leaves as they are."""
    return tree_mod.tree_map(lambda x, s: _fsdp_leaf(x, tuple(s)[drop:], mesh), sub, specs)


@dataclasses.dataclass(frozen=True)
class _Fsdp:
    mesh: object
    specs: object           # the params' nesting, a spec a leaf


@contextlib.contextmanager
def use_fsdp(mesh, params, specs: Sequence | None):
    """While open, ``fsdp_take`` and ``fsdp_layers`` gather the leaves of
    ``params`` (this rank's blocks; one spec a leaf in ``specs``, flatten
    order) that the specs split over ``FSDP_AXIS``.  Without ``specs``, or
    on a mesh whose ``FSDP_AXIS`` has one rank, nothing is gathered."""
    prev = getattr(_state, "fsdp", None)
    live = (specs is not None and FSDP_AXIS in mesh.shape and mesh.shape[FSDP_AXIS] > 1)
    _state.fsdp = _Fsdp(mesh, tree_mod.unflatten(params, list(specs))) if live else None
    try:
        yield
    finally:
        _state.fsdp = prev


def fsdp_take(params: dict, key: str):
    """``params[key]`` (None where absent) whole at its use: under
    ``use_fsdp`` its leaves that the layout splits over ``FSDP_AXIS``
    gathered (``fsdp_gather_tree``); as it is otherwise.  ``params`` is the
    tree the loss was given (the root of ``use_fsdp``'s specs)."""
    f = getattr(_state, "fsdp", None)
    if key not in params or f is None:
        return params.get(key)
    return fsdp_gather_tree(params[key], f.specs[key], f.mesh)


def fsdp_layers(*path):
    """The gather of one layer's params from the stack at ``path`` of the
    root params (``"layers"``; whisper's ``"enc"`` / ``"dec"``, xlstm's
    ``"blocks", i``) under ``use_fsdp``, as a function of the layer's
    params: its leaves whole, the stack's specs without their ``layers``
    entry (``drop=1``; a path that ends at one block, none dropped).  It
    keeps the mesh and specs, so that a layer's recompute in the backward,
    after ``use_fsdp`` has closed, gathers again.  None without
    ``use_fsdp``."""
    f = getattr(_state, "fsdp", None)
    if f is None:
        return None
    specs = f.specs
    for k in path:
        specs = specs[k]
    drop = 0 if isinstance(path[-1], int) else 1
    return lambda p: fsdp_gather_tree(p, specs, f.mesh, drop=drop)


def shard_tree(tree, specs: Sequence, mesh):
    """This rank's block of every leaf of the full logical ``tree`` under
    ``specs`` (``tree_specs``), as ``device_put`` with those shardings would
    hand them to the rank's device."""
    leaves = tree_mod.leaves(tree)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    return tree_mod.unflatten(tree, [local_shard(x, mesh, s) for x, s in zip(leaves, specs)])


def full_shape(local: torch.Tensor, spec: Sequence, mesh) -> tuple[int, ...]:
    """The logical shape of the leaf whose block on this rank is ``local``."""
    shape = list(local.shape)
    for d, entry in enumerate(spec):
        if isinstance(entry, Parts):
            shape[d] = entry.width
            continue
        for ax in _axes(entry):
            shape[d] *= mesh.shape[ax]
    return tuple(shape)


def gather(local: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The full logical leaf from the ranks' blocks under ``spec`` (the
    inverse of ``local_shard``), on every rank: one ``all_gather`` a
    sharded dim and mesh axis, the minor axis first (a ``Parts`` dim:
    each split part's blocks in order, each whole part rank 0's copy)."""
    from repro_torch.distributed import collectives

    out = local
    for d, entry in enumerate(spec):
        if isinstance(entry, Parts):
            n = mesh.shape[entry.axis]
            if n > 1:
                got = collectives.all_gather(out, mesh, entry.axis, dim=d)
                ranks = [torch.split(r, entry.local_widths(n), dim=d)
                         for r in torch.split(got, out.shape[d], dim=d)]
                out = torch.cat([torch.cat([r[i] for r in ranks], dim=d) if split
                                 else ranks[0][i] for i, (_, split) in enumerate(entry.parts)],
                                dim=d)
            continue
        for ax in reversed(_axes(entry)):
            if mesh.shape[ax] > 1:
                out = collectives.all_gather(out, mesh, ax, dim=d)
    return out
