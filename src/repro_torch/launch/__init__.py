"""Command-line launchers (``repro.launch``): ``tune`` and the shared
knob parser ``knobs``."""
