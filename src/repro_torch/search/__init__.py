"""repro_torch.search: stochastic mapspace search on the batched engine.

Layers on ``Sparseloop.evaluate_batch`` to turn "evaluate a mapping
fast" into "find good mappings fast" (SparseMap, arXiv 2508.12906):

  * :mod:`encoding`   — flat genomes (prime-factor level assignment +
    permutation indices) that always decode to valid divisor splits,
    plus the (design, mapping) co-search extension (``DesignSpace``
    knobs append design genes, ``CoSearchEncoding``) and the
    (topology, design, mapping) one (``TopologySpace``,
    ``TopologyCoSearchEncoding``)
  * :mod:`strategies` — RandomSearch / HillClimb / SimulatedAnnealing /
    EvolutionStrategy, every draw from an explicit ``torch.Generator``
  * :mod:`runner`     — population evaluation through the batched engine
    on the CUDA card (or the CPU when ``device="cpu"``), sharded over a
    ``PopulationMesh`` when asked (``population_mesh``), scalar-oracle
    validation of the winner
  * :mod:`fused`      — device-resident ES: the whole ask -> decode ->
    evaluate -> tell generation as one captured CUDA graph, replayed
    for a chunk of generations (``run_search(fused=True)`` /
    ``REPRO_SEARCH_FUSED=1``), with an optional hybrid ES+SGD step on
    co-search design genes
  * :mod:`log`        — JSON-serializable per-generation trajectory

Entry points: :func:`run_search` here, or
``repro_torch.core.mapper.search(..., strategy="es")``.
"""
from .encoding import (COMPUTE_KNOB_LEVEL, CoSearchEncoding, DesignSpace,
                       LevelSlot, MapspaceEncoding, SAF_NONE, SAFOption,
                       TopologyCoSearchEncoding, TopologySpace,
                       prime_factors)
from .fused import (ChunkAbsorber, FusedProgram, fused_supported,
                    get_fused_program)
from .log import GenerationRecord, SearchLog
from .runner import (KNOWN_SEARCH_ENV, PopulationEvaluator, SearchConfig,
                     population_mesh, run_search, validate_search_env)
from .strategies import (STRATEGIES, EvolutionStrategy, HillClimb,
                         RandomSearch, SimulatedAnnealing, Strategy,
                         crossover, make_strategy, mutate)

__all__ = [
    "COMPUTE_KNOB_LEVEL", "CoSearchEncoding", "DesignSpace",
    "LevelSlot", "MapspaceEncoding", "SAF_NONE", "SAFOption",
    "TopologyCoSearchEncoding", "TopologySpace", "prime_factors",
    "ChunkAbsorber", "FusedProgram", "fused_supported",
    "get_fused_program",
    "GenerationRecord", "SearchLog",
    "KNOWN_SEARCH_ENV", "PopulationEvaluator", "SearchConfig",
    "population_mesh", "run_search", "validate_search_env",
    "STRATEGIES", "EvolutionStrategy", "HillClimb", "RandomSearch",
    "SimulatedAnnealing", "Strategy", "crossover", "make_strategy",
    "mutate",
]
