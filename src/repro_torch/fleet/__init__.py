"""Fleet sweeps: every LM config through the port's batched engine.

``extract`` walks the model configs into parameter-exact per-layer
matmul workloads (prefill/decode, optionally sharded to per-device
shapes under the production mesh); ``sweep`` routes the whole fleet x
sparsity-option portfolio through shared programs in O(#options)
programs; ``validate`` checks the advisor's verdict signs against the
kernels K1-K3 measured on the card.
"""
from .extract import (LayerMatmul, MeshSpec, NetworkWorkloads,
                      extract_fleet, extract_network,
                      production_mesh_spec, shard_entries)
from .sweep import (FleetReport, LayerVerdict, SweepOption,
                    default_options, dedupe_shapes, fleet_sweep,
                    nm_design_for_weights, nm_option)

__all__ = [
    "LayerMatmul", "MeshSpec", "NetworkWorkloads", "extract_fleet",
    "extract_network", "production_mesh_spec", "shard_entries",
    "FleetReport", "LayerVerdict", "SweepOption", "default_options",
    "dedupe_shapes", "fleet_sweep", "nm_design_for_weights",
    "nm_option",
]
