"""Batched LM serving entry point (port of ``repro.launch.serve``): prefill a
prompt batch, decode greedily, print the generated shape, tokens/s and the
first sequence.

Usage (CPU smoke; without ``--device cpu`` it needs a CUDA card):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
        --device cpu --batch 4 --prompt-len 32 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --smoke \
        --device cpu --batch 2 --prompt-len 8 --max-new 4

Every arch of the registry serves; the prefix models' batches carry
whisper's frames or pixtral's patches (``registry.make_batch_fn``).

``--mesh-shape`` serves on a mesh of ranks, ``launch.train``'s axis names
(``2,2`` for ``(data, model)``): one process a rank (``launch.mesh.spawn``;
nccl where every rank has a card, gloo where ranks share one or run on the
CPU).  Each rank draws the params from the seed, casts them once
(``ServeFamily.prepare``) and keeps its blocks (``registry.lm_specs``:
whole heads, ``d_ff``, the vocabulary and an MoE's experts split over
``model``; zamba2's mamba layers by SSM head, xlstm's blocks by head or
FFN unit; whisper's encoder and decoder layers by head and ``d_ff``),
takes its ``data`` block of the batch (whisper's frames, pixtral's patches
with it) and runs ``greedy_generate`` on it; the rank at coordinates 0
prints the tokens of every ``data`` block, gathered.  Every arch serves on
a mesh.  ``--compute-dtype float32`` serves in fp32 compute, where a mesh
gives the one card's tokens:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
        --device cpu --mesh-shape 1,2 --batch 2 --prompt-len 32 --max-new 8 \
        --compute-dtype float32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --smoke \
        --device cpu --mesh-shape 1,2 --batch 2 --prompt-len 32 --max-new 8 \
        --compute-dtype float32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --smoke \
        --device cpu --mesh-shape 1,2 --batch 2 --prompt-len 16 --max-new 8 \
        --compute-dtype float32 --embedding qr

``repro``'s tokens/s includes its compile time.  The port has no compile
step: its time is the host clock from the prefill's start to the last
token on the device (synchronised), the kernels' one-time build included
on a card that has not built them yet.  The weights are cast once to the
compute dtype before serving (``ServeFamily.prepare``), which gives the
same tokens as casting them on every call.
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
import time
from pathlib import Path

import torch

from repro_torch import device as device_mod
from repro_torch.configs import registry
from repro_torch.train.serve_step import greedy_generate, serve_family


# seconds a meshed run and each of its collectives may take
RANK_TIMEOUT_S = 3600.0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--embedding", default=None, choices=[None, "dense", "hashed", "qr"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compute-dtype", default=None, choices=[None, "float32", "bfloat16"],
                    help="the config's (bfloat16) unless given")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 1,2 for (data, model); 2,1,2 for (pod, data, model)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a card; cpu runs the "
                         "kernels' plain versions")
    return ap


def config(args):
    binding = registry.get(args.arch)
    cfg = binding.smoke if args.smoke else binding.config
    if args.embedding:
        cfg = cfg.replace(embedding_kind=args.embedding)
    if args.compute_dtype:
        cfg = cfg.replace(compute_dtype=args.compute_dtype)
    return binding, cfg


def serve(args, dev, mesh=None) -> None:
    """Draw the params, cast them once, prefill and decode; on a ``mesh``
    this rank's blocks and ``data`` block.  The writer prints."""
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding as SH

    binding, cfg = config(args)
    fam = serve_family(binding.kind)
    params, axes = registry.init_fn(binding)(cfg, seed=args.seed, device=dev)
    params = fam.prepare(params, cfg)
    make_batch = registry.make_batch_fn(binding, cfg)
    batch = make_batch(args.batch, args.prompt_len, seed=args.seed, step=0, device=dev)
    if mesh is not None:
        params = SH.shard_tree(params, registry.lm_specs(cfg, params, axes, mesh, serve=True), mesh)
        batch = synthetic.data_block(batch, mesh)
    max_len = args.prompt_len + args.max_new

    t0 = time.perf_counter()
    out = greedy_generate(fam, params, batch, cfg, max_new=args.max_new, max_len=max_len,
                          mesh=mesh)
    device_mod.synchronize(dev)
    dt = time.perf_counter() - t0
    where = dev.type
    if mesh is not None:
        data = SH.batch_split(args.batch, mesh)
        out = SH.gather(out, SH.P(data if len(data) > 1 else data[0]) if data else SH.P(), mesh)
        where = f"{mesh.size} {dev.type} ranks, mesh {tuple(mesh.shape.values())}"
        if any(mesh.coords.values()):
            return
    toks = args.batch * args.max_new
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({toks / dt:.1f} tok/s on {where}: "
          f"prefill of {args.batch} x {args.prompt_len} + {args.max_new} decode steps, "
          f"host clock to the last token)", flush=True)
    print("first sequence:", out[0].tolist(), flush=True)


def _rank(mesh, args) -> None:
    """One rank of a ``--mesh-shape`` run (``launch.mesh.spawn``)."""
    serve(args, mesh.device, mesh)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = device_mod.resolve(args.device)
    if not args.mesh_shape:
        serve(args, dev)
        return 0

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import mesh_axes

    shape = tuple(int(x) for x in args.mesh_shape.split(","))
    world = math.prod(shape)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = "nccl" if dev.type == "cuda" and world <= cards else "gloo"
    if dev.type == "cuda":
        from repro_torch.kernels import build as kbuild

        kbuild.build(["flash_attention", "qr_gather"])    # here, not in the ranks
    with tempfile.TemporaryDirectory(prefix="repro_torch_serve_") as tmp:
        mesh_mod.spawn(_rank, shape, axes=mesh_axes(shape), args=(args,), device=dev.type,
                       backend=backend, init_file=Path(tmp) / "rdv", timeout_s=RANK_TIMEOUT_S)
    return 0


if __name__ == "__main__":
    sys.exit(main())
