from repro_torch.profiling.bo import BOConfig, BOResult, Observation, run_bo, run_random_search
from repro_torch.profiling.gp import GaussianProcess
from repro_torch.profiling.pareto import (
    ParetoPoint,
    dominates,
    frontier_from_profiles,
    pareto_frontier,
    profile_latency,
)

__all__ = [
    "BOConfig", "BOResult", "Observation", "run_bo", "run_random_search",
    "GaussianProcess", "ParetoPoint", "dominates", "frontier_from_profiles",
    "pareto_frontier", "profile_latency",
]
