"""repro_torch.kernels — the MDRQ kernels: CUDA sources in ``csrc/``, their
wrappers (``multi_scan``, ``range_scan``, ``reducers``), the plain PyTorch
versions (``ref``) and the counted ops (``ops``)."""
