"""Training (slice 2 of the port): ``train_style_transfer`` and its parts.

Submodules are imported where used, so importing one part does not load
the rest."""
