from repro_torch.objectives.base import SeparableObjective
from repro_torch.objectives.griewank import GRIEWANK, griewank, griewank_naive
from repro_torch.objectives.suite import (RASTRIGIN, REGISTRY, SCHWEFEL_222,
                                          SHIFTED_SPHERE, SPHERE)

OBJECTIVES = {"griewank": GRIEWANK, **REGISTRY}

__all__ = [
    "SeparableObjective", "GRIEWANK", "griewank", "griewank_naive",
    "RASTRIGIN", "SPHERE", "SCHWEFEL_222", "SHIFTED_SPHERE", "OBJECTIVES", "REGISTRY",
]
