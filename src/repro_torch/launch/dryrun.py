"""The dry run on the ``meta`` device: trace every (arch x shape x mesh)
cell's step and count its bytes, flops and collectives without a card
(port of ``repro.launch.dryrun``).

``repro`` lowers and compiles each cell's jitted step with
``ShapeDtypeStruct`` inputs on a host mesh of placeholder devices and reads
XLA's memory and cost analyses.  The port runs eagerly, one process a rank,
so its dry run runs the real step once on meta tensors (shapes and dtypes,
no data, nothing allocated), on the ranks it names, and counts as it goes:

* bytes — ``StepCounter``, a ``TorchDispatchMode`` that keeps the live
  bytes of the storages the step allocates (one count a storage, so views
  do not count twice; autograd's saved tensors are live storages too) and
  their peak.  The step's peak on a rank is its arguments (params,
  optimizer state, batch, cache) plus that transient peak, beside one
  H100's 80 GB (``launch.mesh.HBM_PER_CHIP``).  It is the allocated bytes
  the caching allocator would count (``torch.cuda.max_memory_allocated``),
  not the blocks it reserves around them;
* flops — ``torch.utils.flop_counter.FlopCounterMode``'s formulas for
  PyTorch's own products (``StepCounter``), plus the kernels' work: on
  meta tensors each kernel wrapper returns the kernel's outputs as empty
  meta tensors and counts the call, its flops and bytes by the bound
  column's formulas
  (``kernels.bounds.META``; K9 attention is not a PyTorch product);
* collectives — ``distributed.collectives.SITES`` by site and axis: on the
  mesh's ``abstract_mesh`` (no process group) every collective counts its
  call on meta tensors and returns the right shape;
* 6·N·D — ``param_counts`` / ``model_flops``, ``repro``'s.

Meshes: ``card`` is world 1, the one H100 every entry point of the port
runs on by default; ``pod1`` / ``pod2`` are ``repro``'s (16, 16) and
(2, 16, 16) production meshes, on which the rank at ``model`` coordinate 0
and the last one (where the uneven vocabulary slices end) are traced and
the larger peak is the cell's.  Every kind runs its train, prefill and
decode cells there.  A rank holds its blocks of the params
(``registry.lm_specs``: a train cell's FSDP over ``data``, its leaves
gathered at their use and their gradients reduce-scattered, counted as
``fsdp_gather`` / ``fsdp_scatter``; a serve cell's ``embed`` whole and
cast for serving), its ``data``
block of the batch and its block of the cache (``sharding.cache_block``:
the port's layout, whose positions stay whole where ``repro``'s split
``kvseq`` over ``model``; zamba2's SSM states and xlstm's mLSTM states by
the heads the rank runs; whisper's self and cross k / v by the kv heads
of its q heads).  A serve cell whose batch the data ranks do not
divide (``long_500k``'s one sequence) holds it whole on every rank
(``sharding.batch_split``), as ``repro``'s ``resolve_spec`` leaves it.

``fit`` sizes a batch, a microbatch or a depth against a byte budget from
these traces (``chip_smoke.py`` sizes its LM cells with it).

Out of scope: ``repro``'s ``reanalyze`` and the record's ``hlo`` block
read post-SPMD HLO text, which an eager PyTorch step does not have.

Usage (the CPU; no card is used):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \
        --mesh card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod1
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time
import traceback
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.configs.base import LM_SHAPES, ModelConfig, ShapeConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import bounds
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.serve_step import serve_family
from repro_torch.train.train_step import make_train_step

SHAPES = {s.name: s for s in LM_SHAPES}
MESHES = {"card": ((1, 1), ("data", "model")), "pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def param_counts(params, cfg: ModelConfig) -> dict:
    """Total + MoE-active parameter counts from the (meta) tree."""
    total = moe_total = 0
    for path, leaf in tree.leaves_with_paths(params):
        total += leaf.numel()
        if "moe" in path and "router" not in path:
            moe_total += leaf.numel()
    active = total
    if cfg.num_experts and cfg.top_k:
        active = total - moe_total + moe_total * cfg.top_k / cfg.num_experts
    return {"total": int(total), "active": int(active)}


def model_flops(counts: dict, shape: ShapeConfig) -> float:
    """6·N·D with D = tokens processed by the step (2·N·D forward only)."""
    if shape.kind == "train":
        return 6 * counts["active"] * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2 * counts["active"] * shape.global_batch * shape.seq_len
    return 2 * counts["active"] * shape.global_batch   # decode: one token a sequence


# ---------------------------------------------------------------------------
# counting a traced step
# ---------------------------------------------------------------------------

def _tensors(obj):
    """The tensors of an operation's arguments or results (nested in
    tuples, lists and dicts)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _signature(args) -> tuple:
    """A hashable key of an operation's arguments (a tuple, list or dict's
    items): a tensor by its shape, strides and dtype, a container by its
    items, the rest as it is (``hash`` raises ``TypeError`` for what cannot
    be a key)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append((a.shape, a.stride(), a.dtype))
        elif isinstance(a, (tuple, list)):
            out.append(_signature(a))
        else:
            hash(a)
            out.append(a)
    return tuple(out)


class _Ref(weakref.ref):
    """A weak reference to a storage that knows the storage's key."""

    __slots__ = ("key",)


class StepCounter(TorchDispatchMode):
    """The live bytes of the storages allocated while the mode is on (meta
    tensors hold storages with sizes and no data), their peak, and the
    flops of PyTorch's products.

    A storage counts once, when an operation first gives it out and not as
    one of its inputs' (a view, an in-place result), and stops counting
    when it is freed; storages that existed before the mode (the step's
    arguments) never count.  It counts the bytes the card's caching
    allocator would (``block_bytes``).  Flops are ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``: matrix products,
    convolutions, attention) applied to each operation as it runs, without
    its module tracking and decompositions, which cost several times the
    trace itself on meta.

    A functional operation with one fresh tensor out runs once per
    signature of its arguments (the tensors' shapes, strides and dtypes,
    the other arguments' values); later calls make its output from the
    remembered shape, strides and dtype.  PyTorch's meta kernels of
    elementwise operations run in Python, at ~0.2 ms a call, and a step
    repeats each signature over its layers, chunks and microbatches."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, _Ref] = {}
        self.sizes: dict[int, int] = {}
        self.current = 0
        self.peak = 0
        self.flops = 0
        self.kind: dict = {}           # op -> (composite, fresh, flop formula)
        self.outputs: dict = {}

    def _free(self, ref: _Ref) -> None:
        if self.live.get(ref.key) is ref:
            del self.live[ref.key]
            self.current -= self.sizes.pop(ref.key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        ref = _Ref(st, self._free)
        ref.key = key
        self.live[key] = ref
        n = block_bytes(st.nbytes())
        self.sizes[key] = n
        self.current += n
        if self.current > self.peak:
            self.peak = self.current

    def _kind(self, func) -> tuple:
        schema = func._schema
        fresh = (not schema.is_mutable and len(schema.returns) == 1
                 and schema.returns[0].alias_info is None
                 and str(schema.returns[0].type) == "Tensor")
        composite = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
        got = self.kind[func] = (composite, fresh, flop_registry.get(func._overloadpacket))
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        composite, fresh, formula = self.kind.get(func) or self._kind(func)
        kwargs = kwargs or {}
        if composite:
            # a composite (matmul, reshape) that reaches the mode whole under
            # inference_mode: run its parts, whose products and copies count
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = None
        if fresh:
            try:
                key = (func, _signature(args), _signature(kwargs.values()) if kwargs else ())
            except TypeError:           # an argument that cannot be a key
                key = None
            got = None if key is None else self.outputs.get(key)
            if got is not None:
                out = torch.empty_strided(got[0], got[1], dtype=got[2], device="meta")
            else:
                out = func(*args, **kwargs)
                if key is not None and isinstance(out, torch.Tensor) and out.is_meta:
                    self.outputs[key] = (out.shape, out.stride(), out.dtype)
        else:
            out = func(*args, **kwargs)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if fresh and isinstance(out, torch.Tensor):
            self._track(out)                 # a fresh output is never an input's storage
            return out
        inputs = None
        for t in _tensors(out):
            if t.untyped_storage()._cdata in self.live:
                continue
            if inputs is None:
                inputs = {x.untyped_storage()._cdata for x in _tensors((args, kwargs))}
            if t.untyped_storage()._cdata not in inputs:
                self._track(t)
        return out


def block_bytes(nbytes: int) -> int:
    """The bytes the CUDA caching allocator counts for an allocation of
    ``nbytes`` (``torch.cuda.memory_allocated``): rounded up to a multiple
    of 512, none for an empty one."""
    return -(-nbytes // 512) * 512


def storage_bytes(*objs) -> int:
    """The allocator's bytes (``block_bytes``) of the distinct storages
    under ``objs`` (trees of tensors)."""
    seen, total = set(), 0
    for t in tree_flatten(objs)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += block_bytes(st.nbytes())
    return total


def to_meta(obj):
    """A tree of tensors as meta tensors of the same shapes and dtypes."""
    return tree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
                         if isinstance(t, torch.Tensor) else t, obj)


def measure(fn: Callable, *, inference: bool = False) -> dict:
    """Run ``fn()`` once (on meta tensors) under the counters: the transient
    peak and the bytes still live at its end, PyTorch's flops
    (``StepCounter``), the kernels' calls, flops and bytes
    (``bounds.META``), the collectives by site and axis, and the seconds.
    ``inference`` runs it without gradients, as the serving entry points
    do (``no_grad``: it allocates what ``inference_mode`` does).  Returns
    ``{"transient_peak", "transient_end", "torch_flops", "kernels",
    "kernel_flops", "sites", "seconds", "out"}``."""
    bounds.reset_meta()
    collectives.reset_counts()
    counter = StepCounter()
    # no_grad allocates what inference_mode does, and lets the autograd key
    # decompose composites (matmul, reshape) in C++ before they reach the mode
    mode = torch.no_grad() if inference else contextlib.nullcontext()
    t0 = time.perf_counter()
    with mode, counter:
        out = fn()
    secs = time.perf_counter() - t0
    kernels = {k: {"calls": v[0], "flops": v[1], "bytes": v[2]} for k, v in bounds.META.items()}
    rec = {"transient_peak": counter.peak, "transient_end": counter.current,
           "torch_flops": counter.flops, "kernels": kernels,
           "kernel_flops": sum(v["flops"] for v in kernels.values()),
           "sites": {f"{site}/{axis}": list(v) for (site, axis), v in
                     sorted(collectives.SITES.items(), key=str)},
           "seconds": secs, "out": out}
    bounds.reset_meta()
    return rec


def fit(predict: Callable[[int], int], budget: int, sizes: tuple[int, int] = (1, 2), *,
        cap: int | None = None) -> dict:
    """The largest size (a batch, microbatches' batch or a depth) whose
    predicted peak ``predict(size)`` (bytes, from a trace) fits ``budget``.

    The peak is piecewise linear in the size: the traces at the two
    ``sizes`` give a line, the line gives the size (at most ``cap``, at
    least 1), and a third trace confirms it.  Where the confirmed peak is
    over the budget, the sizes between the largest traced one that fits and
    the smallest that does not are searched along the line through the two
    (a trace each) until they are adjacent.  Returns ``{"size",
    "predicted", "fixed", "slope", "traced"}``, ``traced`` every traced
    size's predicted peak."""
    lo, hi = sizes
    traced = {lo: int(predict(lo)), hi: int(predict(hi))}
    slope = max((traced[hi] - traced[lo]) / (hi - lo), 1.0)
    fixed = traced[lo] - lo * slope
    size = int((budget - fixed) // slope)
    size = max(1, size if cap is None else min(size, cap))
    if size not in traced:
        traced[size] = int(predict(size))
    while True:
        good = max((s for s in traced if traced[s] <= budget and (cap is None or s <= cap)),
                   default=None)
        if good is None:                   # nothing traced fits: try 1, the smallest
            if 1 not in traced:
                traced[1] = int(predict(1))
                continue
            size = 1
            break
        bad = min((s for s in traced if s > good and traced[s] > budget), default=None)
        if bad is None or bad - good <= 1:
            size = good
            break
        step = (traced[bad] - traced[good]) / (bad - good)
        guess = min(max(good + int((budget - traced[good]) // step), good + 1), bad - 1)
        traced[guess] = int(predict(guess))
    return {"size": size, "predicted": traced[size], "fixed": int(fixed),
            "slope": int(slope), "traced": dict(sorted(traced.items()))}


# ---------------------------------------------------------------------------
# per-cell tracing
# ---------------------------------------------------------------------------

def cell_config(binding, *, embedding_kind=None, qr_collision=None, serve_params=False,
                extra_cfg=None) -> ModelConfig:
    cfg = binding.config
    if embedding_kind:
        cfg = cfg.replace(embedding_kind=embedding_kind)
    if qr_collision:
        cfg = cfg.replace(qr_collision=qr_collision)
    if extra_cfg:
        cfg = cfg.replace(**extra_cfg)
    if serve_params:
        cfg = cfg.replace(param_dtype="bfloat16")
    return cfg


def _microbatches(global_batch: int, dp: int, microbatches: int) -> int:
    """``repro``'s: halve until the batch splits into whole microbatches
    that split over the data ranks."""
    mb = microbatches
    while global_batch % max(mb, 1) or (global_batch // max(mb, 1)) % dp:
        mb //= 2
        if mb <= 1:
            return 1
    return mb


def trace_train(binding, cfg: ModelConfig, batch: int, seq: int, *, microbatches: int = 1,
                mesh=None) -> dict:
    """One training step (``make_train_step``, ``OptConfig()``) of ``batch``
    sequences of ``seq`` tokens on meta, on one card or on this rank of an
    abstract ``mesh`` (its blocks of the params, its block of the batch).
    Returns ``measure``'s record with the argument bytes."""
    params, axes = registry.abstract_params(binding, cfg)
    specs = None
    if mesh is not None:
        from repro_torch.launch.train import place

        params, specs, _ = place(params, registry.lm_axes(cfg, axes, mesh), mesh,
                                 SH.lm_param_rules(cfg, mesh))
        batch = SH.batch_rows(batch, mesh)
    opt_state = opt_mod.init(params)
    data = registry.batch_specs(binding, cfg, batch, seq)
    step = make_train_step(registry.train_loss_fn(binding, cfg), opt_mod.OptConfig(),
                           microbatches=microbatches, mesh=mesh, specs=specs)
    rec = measure(lambda: step(params, opt_state, data))
    rec["arguments"] = {"params": storage_bytes(params), "opt": storage_bytes(opt_state),
                        "batch": storage_bytes(data), "cache": 0}
    return rec


def serve_inputs(binding, cfg: ModelConfig, kind: str, batch: int, seq: int, *,
                 mesh=None) -> tuple:
    """A serve cell's arguments on meta, ``(params, data, cache)``: the
    params cast once for serving (``ServeFamily.prepare``, as
    ``launch.serve``), the prefill's ``batch`` x ``seq`` tokens (cache
    None) or the decode step's token and its cache ``seq`` deep; on an
    abstract ``mesh`` this rank's blocks of them (``lm_param_rules``, its
    ``data`` block, ``sharding.cache_block``)."""
    fam = serve_family(binding.kind)
    params = fam.prepare(registry.abstract_params(binding, cfg, mesh=mesh)[0], cfg)
    local = SH.batch_rows(batch, mesh)                         # the rank's batch block
    if kind == "prefill":
        return params, registry.batch_specs(binding, cfg, local, seq), None
    return (params, {"tokens": torch.empty((local, 1), dtype=torch.int32, device="meta")},
            registry.cache_specs(binding, cfg, batch, seq, mesh=mesh))


def trace_serve(binding, cfg: ModelConfig, kind: str, batch: int, seq: int, *,
                mesh=None) -> dict:
    """One prefill of ``batch`` x ``seq`` tokens (a cache of ``seq``
    positions) or one decode step against a cache ``seq`` deep, without
    gradients, on meta (``serve_inputs``), on one card or on this rank of
    an abstract ``mesh``."""
    fam = serve_family(binding.kind)
    params, data, cache = serve_inputs(binding, cfg, kind, batch, seq, mesh=mesh)
    if kind == "prefill":
        rec = measure(lambda: fam.prefill(params, data, cfg, seq, mesh=mesh), inference=True)
    else:
        rec = measure(lambda: fam.decode(params, cache, data["tokens"], seq - 1, cfg, mesh=mesh),
                      inference=True)
    rec["arguments"] = {"params": storage_bytes(params), "opt": 0,
                        "batch": storage_bytes(data), "cache": storage_bytes(cache)}
    return rec


def lower_cell(arch_id: str, shape_name: str, *, mesh: str = "card",
               embedding_kind: str | None = None, qr_collision: int | None = None,
               microbatches: int = 8, seq_parallel: bool = False, serve_params: bool = False,
               extra_cfg: dict | None = None, fit_card: bool = False) -> dict:
    """One cell's record: the step the entry points run (``make_train_step``,
    ``ServeFamily.prefill`` / ``decode``, on the card or the mesh's rank),
    traced once on meta on each rank ``lower_cell`` names (the module's
    docstring).  With ``fit_card`` a ``card`` cell's record also holds
    ``fit_cell``'s largest batch or depth that fits one H100."""
    binding = registry.get(arch_id)
    cfg = cell_config(binding, embedding_kind=embedding_kind, qr_collision=qr_collision,
                      serve_params=serve_params, extra_cfg=extra_cfg)
    shape = SHAPES[shape_name]
    shape_axes, axis_names = MESHES[mesh]
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh, "kind": shape.kind,
           "embedding": cfg.embedding_kind,
           "variant": dict(extra_cfg or {}, serve_params=serve_params),
           "status": registry.shape_status(binding, shape)}
    if rec["status"] == "run" and seq_parallel and mesh != "card":
        rec["status"] = ("refused: --seq-parallel: the port's meshed layers split no "
                         "sequence over model")
    if rec["status"] != "run":
        return rec

    t0 = time.perf_counter()
    params, _ = registry.abstract_params(binding, cfg)
    counts = param_counts(params, cfg)
    del params
    rec["params_total"] = counts["total"]
    rec["params_active"] = counts["active"]
    rec["model_flops"] = model_flops(counts, shape)
    rec["abstract_s"] = time.perf_counter() - t0
    chips = math.prod(shape_axes)
    dp = math.prod(n for n, ax in zip(shape_axes, axis_names) if ax == "data")
    mb = _microbatches(shape.global_batch, dp, microbatches) if shape.kind == "train" else 1
    rec["microbatches"] = mb
    rec["chips"] = chips

    ranks = []
    if mesh == "card":
        coords = [None]
    else:
        model = shape_axes[axis_names.index("model")]
        coords = [tuple(0 for _ in shape_axes),
                  tuple(model - 1 if ax == "model" else 0 for ax in axis_names)]
    try:
        for at in coords:
            t0 = time.perf_counter()
            m = None if at is None else mesh_mod.abstract_mesh(shape_axes, axis_names, at)
            if m is not None:
                # a batch the data ranks do not divide (long_500k's one
                # sequence) stays whole on every rank (sharding.batch_split)
                rec["batch_split_over"] = list(SH.batch_split(shape.global_batch, m))
            if shape.kind == "train":
                got = trace_train(binding, cfg, shape.global_batch, shape.seq_len,
                                  microbatches=mb, mesh=m)
            else:
                got = trace_serve(binding, cfg, shape.kind, shape.global_batch, shape.seq_len,
                                  mesh=m)
            got.pop("out")
            got["coords"] = None if at is None else dict(zip(axis_names, at))
            got["wall_s"] = time.perf_counter() - t0
            ranks.append(got)
    except NotImplementedError as e:
        rec["status"] = f"refused: {e}"
        return rec
    worst = max(ranks, key=lambda r: sum(r["arguments"].values()) + r["transient_peak"])
    args = worst["arguments"]
    peak = sum(args.values()) + worst["transient_peak"]
    rec["memory"] = {
        "argument_bytes": sum(args.values()),
        **{f"{k}_bytes": v for k, v in args.items()},
        "transient_peak_bytes": worst["transient_peak"],
        "peak_bytes": peak,
        "hbm_bytes": int(mesh_mod.HBM_PER_CHIP),
        "fits": peak <= mesh_mod.HBM_PER_CHIP,
        "coords": worst["coords"],
    }
    rec["flops"] = {
        "counted": worst["torch_flops"] + worst["kernel_flops"],
        "torch": worst["torch_flops"],
        "kernels": worst["kernel_flops"],
        "model_flops_per_chip": rec["model_flops"] / chips,
    }
    rec["kernels"] = worst["kernels"]
    rec["collectives"] = worst["sites"]
    rec["ranks"] = [{k: r[k] for k in ("coords", "arguments", "transient_peak",
                                       "torch_flops", "kernel_flops", "sites", "seconds",
                                       "wall_s")} for r in ranks]
    rec["trace_s"] = sum(r["seconds"] for r in ranks)
    if fit_card and mesh == "card":
        rec["fit"] = fit_cell(binding, cfg, shape, mb)
    return rec


def fit_cell(binding, cfg: ModelConfig, shape: ShapeConfig, microbatches: int = 1,
             budget: float = mesh_mod.HBM_PER_CHIP) -> dict:
    """What of a cell fits one card's ``budget`` bytes (``fit``, peaks with
    the arguments): the largest batch at full depth (a train cell's
    sequences a microbatch, in its ``microbatches``; its batch that many
    microbatches, at most the cell's), or where one sequence does not fit,
    the largest depth at batch 1 (a layer count; whisper's encoder and
    decoder layers each)."""
    def depth_cfg(layers: int) -> ModelConfig:
        if cfg.is_encoder_decoder:
            return cfg.replace(enc_layers=layers, dec_layers=layers, num_layers=2 * layers)
        return cfg.replace(num_layers=layers)

    @functools.lru_cache(maxsize=None)
    def peak(c: ModelConfig, batch: int) -> int:
        if shape.kind == "train":                 # two microbatches hold a step's peak
            r = trace_train(binding, c, 2 * batch if microbatches > 1 else batch,
                            shape.seq_len, microbatches=min(microbatches, 2))
        else:
            r = trace_serve(binding, c, shape.kind, batch, shape.seq_len)
        return sum(r["arguments"].values()) + r["transient_peak"]

    full = cfg.enc_layers if cfg.is_encoder_decoder else cfg.num_layers
    per = microbatches if shape.kind == "train" else 1
    if peak(cfg, 1) <= budget:
        got = fit(lambda b: peak(cfg, b), int(budget), (1, 2),
                  cap=max(1, shape.global_batch // per))
        return {"batch": got["size"] * per, "layers": full, "per_batch": got["slope"],
                "predicted": got["predicted"]}
    got = fit(lambda d: peak(depth_cfg(d), 1), int(budget), (1, 2), cap=full)
    fits = got["predicted"] <= budget
    return {"batch": per if fits else 0, "layers": got["size"] if fits else 0,
            "per_layer": got["slope"], "predicted": got["predicted"]}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_cells(cells, out_dir: str, *, force: bool = False, tag: str | None = None,
              **kw) -> list[dict]:
    """``lower_cell`` of each ``(arch, shape, mesh)``, one JSON each under
    ``out_dir/<mesh>/``; a record already there is read back unless
    ``force``.  An error is the cell's status, with its traceback."""
    results = []
    for arch_id, shape_name, mesh in cells:
        base = tag or kw.get("embedding_kind") or "config"
        sp = "-sp" if kw.get("seq_parallel") else ""
        path = os.path.join(out_dir, mesh, f"{arch_id}__{shape_name}__{base}{sp}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path) and not force:
            with open(path) as f:
                results.append(json.load(f))
            print(f"[skip] {path}")
            continue
        print(f"[dryrun] {arch_id} x {shape_name} x {mesh} ({base}{sp}) ...", flush=True)
        t0 = time.perf_counter()
        try:
            rec = lower_cell(arch_id, shape_name, mesh=mesh, **kw)
        except Exception as e:  # recorded: a fault of the dry run or of the port
            rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh,
                   "status": f"error: {type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        rec["wall_s"] = time.perf_counter() - t0
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"   -> {summary(rec)}", flush=True)
        results.append(rec)
    return results


def wire_bytes(rec: dict) -> dict:
    """A meshed record's collective bytes a rank a step by kind and axis
    (``"all_reduce/model"``, ``"fsdp_gather/data"``, ``"fsdp_scatter/data"``:
    the bytes each rank puts in, ``collectives.BYTES``' measure), from its
    ``collectives`` by site; every site but the two FSDP ones and the
    gathers (``all_gather``, ``logits``) is an all-reduce."""
    out: dict = {}
    for key, (_calls, nbytes) in rec.get("collectives", {}).items():
        site, axis = key.rsplit("/", 1)
        kind = (site if site in ("fsdp_gather", "fsdp_scatter")
                else "all_gather" if site in ("all_gather", "logits") else "all_reduce")
        out[f"{kind}/{axis}"] = out.get(f"{kind}/{axis}", 0) + nbytes
    return out


def summary(rec: dict) -> str:
    """One line of a record: status, and for a run cell its peak a rank
    against 80 GB, the counted flops beside 6·N·D, on a mesh the bytes
    a rank a step by collective and axis (``wire_bytes``), and the
    seconds."""
    if rec.get("status") != "run":
        return f"{rec.get('status')} ({rec.get('wall_s', 0):.1f} s)"
    m, f = rec["memory"], rec["flops"]
    wire = "".join(f"; {k} {v / 1e9:.3g} GB" for k, v in sorted(wire_bytes(rec).items()))
    return (f"run: peak {m['peak_bytes'] / 2**30:.2f} GiB a rank "
            f"({m['argument_bytes'] / 2**30:.2f} arguments + "
            f"{m['transient_peak_bytes'] / 2**30:.2f} transient) of "
            f"{m['hbm_bytes'] / 1e9:.0f} GB: {'fits' if m['fits'] else 'does not fit'}; "
            f"flops {f['counted']:.4g} counted a rank, 6ND {rec['model_flops']:.4g}"
            + (f"; one card fits batch {rec['fit']['batch']} at {rec['fit']['layers']} layers"
               if "fit" in rec else "") + wire + f" ({rec.get('wall_s', 0):.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card", choices=["card", "pod1", "pod2", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--embedding", default=None,
                    choices=[None, "dense", "hashed", "qr", "tt"])
    ap.add_argument("--collision", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--qr-head", default=None, choices=[None, "factorized", "materialize"])
    ap.add_argument("--embedding-exec", default=None, choices=[None, "gspmd", "twolevel"])
    ap.add_argument("--moe-dispatch", default=None, choices=[None, "scatter", "gather"])
    ap.add_argument("--remat-policy", default=None, choices=[None, "full", "dots"])
    ap.add_argument("--flash-block-dtype", default=None, choices=[None, "f32", "bf16"])
    ap.add_argument("--serve-params", action="store_true",
                    help="bf16 params (repro's inference placement)")
    ap.add_argument("--fit", action="store_true",
                    help="card cells: the largest batch (or depth) that fits one H100")
    ap.add_argument("--tag", default=None, help="output filename variant tag")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.list:
        for b, s, status in registry.cells(include_skipped=True):
            print(f"{b.arch_id:24s} {s.name:12s} {status}")
        return 0

    meshes = {"both": ["pod1", "pod2"]}.get(args.mesh, [args.mesh])
    if args.all:
        cells = [(b.arch_id, s.name, m) for m in meshes for b, s, _ in registry.cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    extra_cfg = {k: v for k, v in (("qr_head", args.qr_head),
                                   ("embedding_exec", args.embedding_exec),
                                   ("moe_dispatch", args.moe_dispatch),
                                   ("remat_policy", args.remat_policy),
                                   ("flash_block_dtype", args.flash_block_dtype)) if v}
    results = run_cells(cells, args.out, force=args.force, tag=args.tag,
                        embedding_kind=args.embedding, qr_collision=args.collision,
                        microbatches=args.microbatches, seq_parallel=args.seq_parallel,
                        extra_cfg=extra_cfg or None, serve_params=args.serve_params,
                        fit_card=args.fit)
    ok = sum(1 for r in results if r.get("status") == "run")
    print(f"\n{ok}/{len(results)} cells traced")
    bad = [r for r in results if str(r.get("status", "")).startswith("error")]
    for r in bad:
        print(f"FAILED: {r['arch']} x {r['shape']} x {r['mesh']}: {r['status']}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
