"""repro_torch.kernels — the MDRQ kernels and the LM's block-visit decode
attention: CUDA sources in ``csrc/``, their wrappers (``multi_scan``,
``range_scan``, ``reducers``, ``va_filter``, ``kv_visit``), the plain PyTorch
versions (``ref``) and the counted ops (``ops``)."""
