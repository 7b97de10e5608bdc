"""Quickstart: the paper's operator in a few lines (port of
``examples/quickstart.py``).

Builds a QR (weight-sharing) embedding table, looks a batch of bags up three
ways — the naive double gather, the associativity-fused bag and the pooled
QR bag kernel K6 (``ops.gnr_pooled``) — checks they agree, then runs the
same bags through the engine front door (declare -> plan -> compile ->
``lookup``: one launch of K1 on the packed table), then trains a small LM
(qwen2-1.5b-smoke) whose vocabulary is the QR operator for 10 steps on one
batch (K8 for its tokens and K9 in every layer on the card).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import device as device_mod
from repro_torch import engine as engine_mod
from repro_torch.core import embedding_bag, hashing, qr_embedding
from repro_torch.core.embedding_bag import BagConfig
from repro_torch.configs import registry
from repro_torch.core.qr_embedding import EmbeddingConfig
from repro_torch.kernels import ops
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    dev = device_mod.resolve(ap.parse_args(argv).device)

    # --- 1. a weight-shared table: 1M logical rows in 16K physical rows ----
    cfg = EmbeddingConfig(vocab=1_000_000, dim=128, kind="qr", collision=64,
                          compute_dtype=torch.float32)
    params = qr_embedding.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                               device=dev)
    spec = cfg.qr_spec
    print(f"logical rows {cfg.vocab:,} -> physical {spec.q_rows + spec.r_rows:,} "
          f"({spec.compression:.1f}x compression, LUT = {spec.lut_bytes() / 1024:.0f} KiB)")

    # --- 2. three equivalent lookups ---------------------------------------
    idx = torch.randint(0, cfg.vocab, (8, 32), generator=torch.Generator(dev).manual_seed(1),
                        device=dev, dtype=torch.int32)
    naive = qr_embedding.lookup(params, idx, cfg).sum(dim=-2)         # 2 gathers
    bag = BagConfig(emb=cfg, pooling=32)
    fused = embedding_bag.bag_lookup(params, idx, bag)                # partial sums
    q_idx, r_idx = hashing.qr_decompose(idx, cfg.collision)
    kernel = ops.gnr_pooled(params["q"], params["r"], q_idx, r_idx)   # K6
    torch.testing.assert_close(fused, naive, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(kernel, naive, rtol=1e-4, atol=1e-4)
    print("naive == fused == gnr_bag kernel lookup: OK")

    # --- 3. the engine front door: declare -> plan -> compile -> execute ---
    espec = engine_mod.EngineSpec.from_bags([bag])       # tables + policies
    eng = engine_mod.compile(engine_mod.plan(espec))     # offline pass, once
    pooled = eng.lookup([params], idx[:, None, :])[:, 0]
    torch.testing.assert_close(pooled, naive, rtol=1e-4, atol=1e-4)
    print(f"engine lookup == naive: OK  (plan: {eng.summary()})")

    # --- 4. a small LM whose vocab table is the QR operator ----------------
    binding = registry.get("qwen2-1.5b")
    lm_cfg = binding.smoke.replace(embedding_kind="qr", qr_collision=8)
    lm_params, _ = registry.init_fn(binding)(lm_cfg, seed=2, device=dev)
    step = make_train_step(registry.train_loss_fn(binding, lm_cfg),
                           opt_mod.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20))
    opt = opt_mod.init(lm_params)
    batch = registry.make_batch_fn(binding, lm_cfg)(8, 64, seed=0, step=0, device=dev)
    losses = []
    for i in range(10):
        lm_params, opt, metrics = step(lm_params, opt, batch)
        losses.append(float(metrics["loss"]))
        if i % 3 == 0:
            print(f"  step {i}: loss {losses[-1]:.4f}")
    print("quickstart done.")
    return {"naive": naive, "fused": fused, "kernel": kernel, "pooled": pooled,
            "summary": eng.summary(), "lm_losses": losses}


if __name__ == "__main__":
    main()
