"""repro_torch.data — procedural scalar fields, a verbatim numpy copy of
``repro.data.fields`` (deterministic in name, shape and seed, so the
port and the reference draw identical fields)."""
from .fields import FIELD_GENERATORS, synthetic_field

__all__ = ["FIELD_GENERATORS", "synthetic_field"]
