"""Density kinds that the reference (``density.make_density_model``)
does not define, each found by its name: the spec ``(kind, params)``
builds ``kinds/<kind>.py``'s ``model(params: dict, tensor_size: int)``.

``params`` are the kind's keys in the configuration file beside
``"kind"``, with the tensor's ``rows`` and ``cols`` (its shape in the
layer) added by the harness.  The model returned answers ``density``
(an attribute or property: the share of nonzeros in the whole tensor),
``prob_empty(tile_size)``, ``expected_density(tile_size)`` and
``max_nnz(tile_size)``, for a tile of ``tile_size`` elements, as the
models of ``density.py`` do.  A kind's file imports nothing of the
program (``repro_torch``), of the JAX package or of JAX: it is part of
the yardstick.  The program builds the same spec with its own
``make_density_model``, so a kind the program lacks fails a run at
set-up.
"""
