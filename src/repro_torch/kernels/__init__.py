"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

* ``packed_gather`` — K1 ``packed_qr_bag`` and K3 ``packed_bag``
  (``csrc/packed_gather.cu``) and K2 ``packed_tt_bag`` (``csrc/tt_bag.cu``),
  the packed multi-table pooled bags;
* ``tt_gather``     — K5 ``tt_bag``, one table's pooled TT bag
  (``csrc/tt_bag.cu``);
* ``ref``           — the plain versions (CPU path and on-card oracles);
* ``ops``           — the one-launch entry ``packed_multi_pooled`` and the TT
  entries ``tt_pooled_auto`` / ``tt_lookup``;
* ``build``         — ``nvcc`` build at first use, ctypes load.
"""
