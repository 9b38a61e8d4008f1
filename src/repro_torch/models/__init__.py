"""The LM stack of the port: layers, attention, Mamba-2, blocks and the model."""
