"""repro_torch.models — the LM's decode-serving path: configs become models
(``registry``), layers and the dense decoder, parameter init and the
conversion of the reference's parameter trees (``convert``)."""
