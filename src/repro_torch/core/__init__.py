"""The MAIZX core of the port: accounting, ranking, placement, simulator."""
from repro_torch.core.cpp import (Projection, cpp_score,  # noqa: F401
                                  eu_taxonomy_projection)
from repro_torch.core.faults import (FaultConfig, FaultPlan,  # noqa: F401
                                     plan_faults)
