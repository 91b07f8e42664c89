"""The slot serving engine."""
from repro_torch.serve.engine import GenerationResult, ServeEngine  # noqa: F401
