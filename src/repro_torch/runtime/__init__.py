"""The training runtime (the JAX package's ``runtime/``): fault
tolerance (straggler watchdog, heartbeat, the elastic mesh) and the
int8-compressed data-parallel all-reduce."""
from .compression import compressed_grad_allreduce
from .fault_tolerance import Heartbeat, StragglerWatchdog, elastic_mesh

__all__ = ["Heartbeat", "StragglerWatchdog", "elastic_mesh",
           "compressed_grad_allreduce"]
