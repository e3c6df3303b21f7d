"""The LM family of ``repro.models`` in PyTorch: ``layers``, ``flash``,
``moe`` and the transformer's inference steps (``transformer``)."""
