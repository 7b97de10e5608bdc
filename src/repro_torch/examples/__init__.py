"""Runnable walkthroughs of the port (``python -m repro_torch.examples.<name>
[--device cpu]``): ``quickstart`` (the QR operator three ways, then the
engine), ``cache_plan`` (analyzer, duplication plan, prefetch scheduler,
the cached QR bag kernel), ``train_dlrm``, ``autotune_plan`` (trace ->
cost model -> ranked knob space -> tuned plan) and ``serve_lm`` (prefill
and greedy decode of a smoke LM with the QR vocabulary)."""
