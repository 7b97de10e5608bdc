"""whisper's training losses, the port beside ``repro``, on the CPU.

Both packages train whisper-large-v3-smoke, or with ``--full-width`` the
full config at ``--layers`` encoder and decoder layers (QR vocabulary, the
config's bf16 compute, and fp32 compute), from the same params (``repro``'s draw,
carried over by ``convert.lm_params_from_numpy``) on one batch of frames and
tokens, repeated, with ``chip_smoke.py``'s optimizer for its depth-fitted
training runs (``LMT_FIT_OPT``: AdamW at lr 1e-4, constant after one warmup
step): ``repro``'s jitted ``make_train_step`` and the port's
``make_train_step`` on the registry's prefixed loss.  Prints each step's
loss of each, then a ``{"losses": ...}`` line.  A loss that rises in both
is the optimizer's behaviour on this model, not the port's fault.

Usage (from the repo root; needs jax, no card):
    PYTHONPATH=src python3 scripts/torch_prefix_train_losses.py [--steps 4] [--batch 2] [--seq 32]
    PYTHONPATH=src python3 scripts/torch_prefix_train_losses.py --full-width --layers 2 \
        --computes float32
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as j_registry
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch import tree
from repro_torch.configs import registry as t_registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_step as t_ts

ARCH = "whisper-large-v3"
# chip_smoke.LMT_FIT_OPT (the script imports no jax, this one no chip_smoke)
OPT = dict(lr=1e-4, warmup_steps=1, schedule="constant")


def run(compute: str, steps: int, batch: int, seq: int, layers: int | None = None) -> dict:
    import torch

    kw = dict(compute_dtype=compute, embedding_kind="qr", qr_collision=8)
    if layers:       # the full width at a depth
        kw.update(enc_layers=layers, dec_layers=layers, num_layers=2 * layers)
        jcfg = j_registry.get(ARCH).config.replace(**kw)
        tcfg = t_registry.get(ARCH).config.replace(**kw)
    else:
        jcfg = j_registry.get(ARCH).smoke.replace(**kw)
        tcfg = t_registry.get(ARCH).smoke.replace(**kw)
    jp, _ = j_registry.init_fn(j_registry.get(ARCH))(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((batch, 1536, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
    jstep = jax.jit(j_ts.make_train_step(j_registry.train_loss_fn(j_registry.get(ARCH), jcfg),
                                         j_opt.OptConfig(**OPT, total_steps=steps)))
    tstep = t_ts.make_train_step(t_registry.train_loss_fn(t_registry.get(ARCH), tcfg),
                                 t_opt.OptConfig(**OPT, total_steps=steps))
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)}
    js, ts_ = j_opt.init(jp), t_opt.init(tp)
    out = {"repro": [], "port": []}
    for _ in range(steps):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts_, tm = tstep(tp, ts_, tb)
        out["repro"].append(float(jm["loss"]))
        out["port"].append(float(tm["loss"]))
    out["params_max_abs_diff"] = max(
        float(np.abs(np.asarray(a, np.float64) - b.double().numpy()).max())
        for a, b in zip(jax.tree.leaves(jp), tree.leaves(tp)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--layers", type=int, default=2, help="a stack's depth at full width")
    ap.add_argument("--computes", nargs="+", default=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    rec = {}
    for compute in args.computes:
        got = run(compute, args.steps, args.batch, args.seq,
                  args.layers if args.full_width else None)
        rec[compute] = got
        for i, (a, b) in enumerate(zip(got["repro"], got["port"])):
            print(f"[{compute}] step {i + 1}: repro {a:.6f}  port {b:.6f}", flush=True)
        rises = [i + 2 for i in range(args.steps - 1) if got["repro"][i + 1] > got["repro"][i]]
        print(f"[{compute}] repro's loss rose at steps {rises or 'none'}; the params after "
              f"{args.steps} steps differ by {got['params_max_abs_diff']:.3g} at most",
              flush=True)
    print(json.dumps({"losses": rec}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
