"""Runnable walkthroughs of the port (``python -m repro_torch.examples.<name>
[--device cpu]``): ``quickstart`` (the QR operator three ways, then the
engine), ``cache_plan`` (analyzer, duplication plan, prefetch scheduler,
the cached QR bag kernel), ``train_dlrm`` and ``autotune_plan`` (trace ->
cost model -> ranked knob space -> tuned plan)."""
