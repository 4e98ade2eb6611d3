"""DSE-as-a-service: persistent batched evaluation serving many
concurrent searches.

Public surface::

    from repro_torch.dse import EvaluationService, run_islands

    with EvaluationService() as svc:                 # owns warm programs
        res = run_islands(design, workload, cons,    # N concurrent
                          n_islands=4, service=svc)  # searches, 1 program
    svc.client_metrics("island0")                    # per-tenant metrics

See :mod:`repro_torch.dse.service` (the service + cross-request batcher)
and :mod:`repro_torch.dse.islands` (the island-ES client).
"""
from .islands import IslandResult, run_islands
from .service import (EvaluationService, ServiceClient, ServiceClosed)

__all__ = [
    "EvaluationService", "IslandResult", "ServiceClient",
    "ServiceClosed", "run_islands",
]
