"""Declarative parameters and their initialisation."""
from repro_torch.distributed.sharding import Param, init_tree  # noqa: F401
