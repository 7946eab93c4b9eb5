"""Explain and its display modes (counterpart of
hyperspace_tpu/plananalysis)."""

from hyperspace_tpu_torch.plananalysis.display import (
    BufferStream,
    ConsoleMode,
    DisplayMode,
    HTMLMode,
    PlainTextMode,
    Tag,
    get_display_mode,
)
from hyperspace_tpu_torch.plananalysis.explain import explain_string

__all__ = ["BufferStream", "ConsoleMode", "DisplayMode", "HTMLMode",
           "PlainTextMode", "Tag", "get_display_mode", "explain_string"]
