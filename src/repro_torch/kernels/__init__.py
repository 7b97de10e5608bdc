"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

* ``packed_gather`` — K1 ``packed_qr_bag`` and K3 ``packed_bag``, the packed
  multi-table pooled bags (``csrc/packed_gather.cu``);
* ``ref``           — the plain versions (CPU path and on-card oracles);
* ``ops``           — the one-launch entry ``packed_multi_pooled``;
* ``build``         — ``nvcc`` build at first use, ctypes load.
"""
