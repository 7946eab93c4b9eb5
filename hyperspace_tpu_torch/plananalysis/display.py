"""Display modes for the explain output (counterpart of
hyperspace_tpu/plananalysis/display.py): PlainText highlights changed
plan sections with ``<----``/``---->``, HTML wraps the output in
``<pre>`` and highlights with a green ``<b>``, Console uses an ANSI green
background; custom highlight tags from the conf override the mode's own
when both are set.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Tag:
    open: str
    close: str


class DisplayMode:
    highlight_tag: Tag = Tag("", "")
    begin_end_tag: Tag = Tag("", "")
    new_line: str = "\n"

    def __init__(self, conf=None) -> None:
        # Both tags must be set for the override to apply — a lone tag keeps
        # the mode default (getHighlightTagOrElse, DisplayMode.scala:46-55).
        begin = getattr(conf, "highlight_begin_tag", "") if conf else ""
        end = getattr(conf, "highlight_end_tag", "") if conf else ""
        if begin and end:
            self.highlight_tag = Tag(begin, end)


class PlainTextMode(DisplayMode):
    def __init__(self, conf=None) -> None:
        self.highlight_tag = Tag("<----", "---->")
        super().__init__(conf)


class HTMLMode(DisplayMode):
    begin_end_tag = Tag("<pre>", "</pre>")
    new_line = "<br>"

    def __init__(self, conf=None) -> None:
        self.highlight_tag = Tag('<b style="background:LightGreen">', "</b>")
        super().__init__(conf)


class ConsoleMode(DisplayMode):
    def __init__(self, conf=None) -> None:
        self.highlight_tag = Tag("\033[42m", "\033[0m")
        super().__init__(conf)


_MODES = {"plaintext": PlainTextMode, "html": HTMLMode, "console": ConsoleMode}


def get_display_mode(conf) -> DisplayMode:
    """PlanAnalyzer.getDisplayMode analog: conf-selected, defaulting to
    plain text."""
    name = getattr(conf, "display_mode", "plaintext").lower()
    mode = _MODES.get(name)
    if mode is None:
        raise ValueError(
            f"Unknown display mode {name!r}; expected one of {sorted(_MODES)}")
    return mode(conf)


class BufferStream:
    """A string buffer aware of the display mode's newline and highlight tags
    (BufferStream.scala:20-80)."""

    def __init__(self, mode: DisplayMode) -> None:
        self._mode = mode
        self._parts: list = []

    def write(self, s: str = "") -> "BufferStream":
        self._parts.append(s)
        return self

    def write_line(self, s: str = "") -> "BufferStream":
        self._parts.append(s)
        self._parts.append(self._mode.new_line)
        return self

    def highlight(self, s: str) -> "BufferStream":
        """Highlight ``s``, keeping leading/trailing whitespace outside the
        tags (indentation must stay aligned across modes)."""
        stripped = s.strip()
        if not stripped:
            return self.write(s)
        start = s.index(stripped[0])
        end = start + len(stripped)
        tag = self._mode.highlight_tag
        return self.write(s[:start] + tag.open + stripped + tag.close
                          + s[end:])

    def with_tag(self) -> str:
        """The buffered output wrapped in the mode's begin/end tag
        (BufferStream.scala's withTag)."""
        body = "".join(self._parts)
        tag = self._mode.begin_end_tag
        return f"{tag.open}{body}{tag.close}"

    def __str__(self) -> str:
        return "".join(self._parts)
