"""The declarative vertex-program language: specs as data (expr, spec,
library), evaluated with torch on the pull engine."""
from lux_tpu_torch.program.spec import (  # noqa: F401
    BatchedSpecBacked,
    BatchedSpecProgram,
    SpecBacked,
    SpecProgram,
    VertexProgramSpec,
    active_changed,
    bind,
)
