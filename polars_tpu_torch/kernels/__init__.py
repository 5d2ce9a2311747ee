"""Device kernels written for Hopper (``csrc/``), each beside its plain
PyTorch version, plus the plain-tensor helpers (sort words, division)."""
