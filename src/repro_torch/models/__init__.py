"""The LM stack of the port: layers, attention, Mamba-2, the MoE block,
blocks and the model (the ``dense``, ``moe``, ``ssm``, ``audio``, ``vlm``
and ``hybrid`` families), the analytic FLOP counts (``flops``), and the
Tucker-factorized layers (``tucker_layers``)."""
