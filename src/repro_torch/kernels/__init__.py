"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

* ``packed_gather`` — K1 ``packed_qr_bag`` and K3 ``packed_bag``
  (``csrc/packed_gather.cu``) and K2 ``packed_tt_bag`` (``csrc/tt_bag.cu``),
  the packed multi-table pooled bags; it also loads and checks the bag body
  for the two modules below;
* ``cached_gather`` — K4a ``cached_bag`` and K4b ``cached_qr_bag``, one
  table's cached bags (``csrc/packed_gather.cu``);
* ``gnr_bag``       — K6 ``gnr_bag`` and K7 ``gnr_bag_dense``, the bags
  without a cache (``csrc/packed_gather.cu``);
* ``qr_gather``     — K8 ``qr_gather``, the unpooled QR rows
  (``csrc/qr_gather.cu``);
* ``tt_gather``     — K5 ``tt_bag``, one table's pooled TT bag
  (``csrc/tt_bag.cu``);
* ``flash_attention`` — K9 ``flash_fwd``, online-softmax GQA attention
  (``csrc/flash_attention.cu``), and ``flash_mha``, its differentiable form;
* ``ref``           — the plain versions (CPU path and on-card oracles);
* ``ops``           — the entry points: ``packed_multi_pooled``, the
  per-table bags, ``qr_lookup``, ``tt_pooled_auto`` / ``tt_lookup``,
  ``flash_attention_fused``; each differentiable (plain-version recompute);
* ``build``         — ``nvcc`` build at first use, ctypes load.
"""
