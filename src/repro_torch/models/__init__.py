"""The model stack of the port: layers, attention, Mamba-1, stacks."""
from repro_torch.models.model import Model, build_model  # noqa: F401
