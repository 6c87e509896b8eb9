"""Aligned-column table formatter with deduction and rich cells (the port's
own copy of ``xalm_tpu/obs/table.py``; the same text for the same rows).

User-facing tabular output: tensor listings, profiler reports, usage and
benchmark summaries. Cells keep their native type until render, alignment
is deduced per column from the observed value types (numbers right, text
left), and a per-column format spec (a Python format spec, or ``"h"`` for
human-readable bytes) overrides the defaults. Histogram cells
(``obs.stats.Histogram``) render as their sparkline.
"""

from __future__ import annotations

import numbers

__all__ = ["Table", "human_size"]

_NUMERIC = numbers.Number  # includes numpy scalars


def human_size(n: int) -> str:
    """Human-readable byte size (the reference table.h's ``{h}`` format)."""
    size = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if size < 1024 or unit == "TiB":
            return f"{size:.0f} {unit}" if unit == "B" else f"{size:.2f} {unit}"
        size /= 1024
    return f"{n} B"  # unreachable


def _is_histogram(v) -> bool:
    return hasattr(v, "sparkline") and callable(v.sparkline)


class Table:
    """``Table(columns, formats=None, align=None)``.

    ``formats``: {column name: spec} where spec is a Python format spec
    (e.g. ``".2f"``, ``","``) or ``"h"`` (human-readable byte size).
    ``align``: {column name: "l" | "r"} to override the deduced alignment
    (numbers right, text left — reference table.h:28-36 deduces the same
    per column type; here the deduction is per observed cell values, so a
    mixed column falls back to left).
    """

    def __init__(
        self,
        columns: list[str],
        formats: dict[str, str] | None = None,
        align: dict[str, str] | None = None,
    ):
        self.columns = [str(c) for c in columns]
        self.rows: list[list] = []
        self._formats = {str(k): v for k, v in (formats or {}).items()}
        self._align = {str(k): v for k, v in (align or {}).items()}

    def add(self, *values) -> None:
        if len(values) != len(self.columns):
            raise ValueError(f"expected {len(self.columns)} values, got {len(values)}")
        self.rows.append(list(values))

    # ---------------------------------------------------------------- render

    def _fmt_cell(self, col: str, v) -> str:
        if _is_histogram(v):
            return v.sparkline()
        spec = self._formats.get(col)
        if spec == "h":
            return human_size(int(v))
        if spec is not None and isinstance(v, _NUMERIC) and not isinstance(v, bool):
            return format(v, spec)
        return str(v)

    def _col_align(self, col: str, cells: list) -> str:
        a = self._align.get(col)
        if a in ("l", "r"):
            return a
        vals = [v for v in cells if v is not None and str(v) != ""]
        if vals and all(
            isinstance(v, _NUMERIC) and not isinstance(v, bool) for v in vals
        ):
            return "r"
        return "l"

    def format(self, title: str | None = None) -> str:
        text = [
            [self._fmt_cell(c, v) for c, v in zip(self.columns, row)]
            for row in self.rows
        ]
        aligns = [
            self._col_align(c, [row[i] for row in self.rows])
            for i, c in enumerate(self.columns)
        ]
        widths = [len(c) for c in self.columns]
        for row in text:
            for i, cell in enumerate(row):
                widths[i] = max(widths[i], len(cell))

        def pad(c: str, w: int, a: str) -> str:
            return c.rjust(w) if a == "r" else c.ljust(w)

        def fmt_row(cells: list[str], header: bool = False) -> str:
            return "| " + " | ".join(
                c.ljust(w) if header else pad(c, w, a)
                for c, w, a in zip(cells, widths, aligns)
            ) + " |"

        sep = "+-" + "-+-".join("-" * w for w in widths) + "-+"
        out = []
        if title:
            out.append(title)
        out.extend([sep, fmt_row(self.columns, header=True), sep])
        out.extend(fmt_row(r) for r in text)
        out.append(sep)
        return "\n".join(out)
