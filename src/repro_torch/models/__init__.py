"""repro_torch.models — the LM's decode-serving path: configs become models
(``registry``), layers, the decoder of every family (``transformer``,
``moe``, ``ssm``, ``rglru``) and the encoder-decoder (``encdec``),
parameter init and the conversion of the reference's parameter trees
(``convert``)."""
