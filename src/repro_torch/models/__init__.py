"""The LM stack of the port: layers, attention, Mamba-2, blocks and the model
(the ``dense``, ``ssm``, ``audio``, ``vlm`` and ``hybrid`` families), and
the Tucker-factorized layers (``tucker_layers``)."""
