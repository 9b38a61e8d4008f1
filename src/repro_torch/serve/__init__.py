"""repro_torch.serve — the LM token-serving engine (``serve.engine``).

The Tucker decomposition service of the reference (``TuckerService``) is
not ported yet (ROADMAP.md queue 1, item 13); import the engine explicitly.
"""
