"""Kernel-agreement harness: the model's SKIP/GATE claims against the
block-sparse kernels measured on the card (``fleet.validate``)."""
