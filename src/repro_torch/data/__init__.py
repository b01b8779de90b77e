"""repro_torch.data — procedural scalar fields and the LM token
pipeline, verbatim numpy copies of ``repro.data.fields`` and
``repro.data.tokens`` (deterministic in name, shape, step and seed, so
the port and the reference draw identical fields and batches)."""
from .fields import FIELD_GENERATORS, synthetic_field
from .tokens import TokenPipeline, synthetic_tokens

__all__ = ["FIELD_GENERATORS", "synthetic_field", "TokenPipeline",
           "synthetic_tokens"]
