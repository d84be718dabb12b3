"""Rendering of criticality reports, the paper's Figures 3-8 and Tables
II/III (port of ``repro.core.report``; the same strings for one report).

The paper visualizes critical (red) / uncritical (blue) distributions inside
3-D/1-D arrays.  On a terminal we render ASCII plane maps: ``#`` = critical,
``.`` = uncritical.  ``summary_table`` reproduces Table II; ``storage_table``
reproduces Table III.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.criticality import CriticalityReport, LeafReport


def render_distribution(
    mask: np.ndarray,
    shape: Sequence[int],
    *,
    max_planes: int = 4,
    max_cols: int = 96,
) -> str:
    """ASCII map of a criticality mask reshaped to ``shape``.

    1-D: a single row (run-length annotated if long).
    2-D: rows × cols grid.
    3-D+: leading axes flattened; up to ``max_planes`` 2-D planes shown.
    """
    mask = np.asarray(mask, dtype=bool).reshape(shape)
    lines = []
    if mask.ndim == 1:
        lines.append(_render_row(mask, max_cols))
    elif mask.ndim == 2:
        for r in range(mask.shape[0]):
            lines.append(_render_row(mask[r], max_cols))
    else:
        planes = mask.reshape((-1,) + mask.shape[-2:])
        step = max(1, len(planes) // max_planes)
        for idx in list(range(0, len(planes), step))[:max_planes]:
            lines.append(f"-- plane {idx} --")
            for r in range(planes.shape[1]):
                lines.append(_render_row(planes[idx, r], max_cols))
    return "\n".join(lines)


def _render_row(row: np.ndarray, max_cols: int) -> str:
    if row.size <= max_cols:
        return "".join("#" if v else "." for v in row)
    # Downsample long rows: a cell is '#' iff any element in its bucket is
    # critical, '.' iff none, 'o' if mixed.
    buckets = np.array_split(row, max_cols)
    out = []
    for b in buckets:
        frac = b.mean()
        out.append("#" if frac == 1.0 else "." if frac == 0.0 else "o")
    return "".join(out)


def leaf_lines(rep: LeafReport) -> str:
    head = (
        f"{rep.name}: shape={rep.shape} dtype={rep.dtype} policy={rep.policy.value} "
        f"uncritical={rep.uncritical}/{rep.total} ({100*rep.uncritical_rate:.1f}%) "
        f"regions={rep.table.num_regions}"
    )
    return head


def summary_table(report: CriticalityReport, title: str = "") -> str:
    """Paper Table II: per-variable uncritical counts."""
    lines = []
    if title:
        lines.append(f"== {title} ==")
    lines.append(f"{'variable':<28}{'uncritical':>12}{'total':>12}{'rate':>9}  policy")
    for name, unc, tot, rate, pol in report.summary_rows():
        lines.append(f"{name:<28}{unc:>12}{tot:>12}{100*rate:>8.1f}%  {pol}")
    lines.append(
        f"{'TOTAL':<28}{report.uncritical_elements:>12}{report.total_elements:>12}"
        f"{100*report.uncritical_rate:>8.1f}%"
    )
    return "\n".join(lines)


def storage_table(report: CriticalityReport, title: str = "") -> str:
    """Paper Table III: checkpoint bytes before/after, incl. aux overhead."""
    lines = []
    if title:
        lines.append(f"== {title} ==")
    lines.append(f"{'variable':<28}{'original':>12}{'optimized':>12}{'saved':>9}")
    for name, leaf in sorted(report.leaves.items()):
        t = leaf.table
        lines.append(
            f"{name:<28}{_kb(t.full_bytes):>12}{_kb(t.optimized_bytes):>12}"
            f"{100*t.storage_saved:>8.1f}%"
        )
    lines.append(
        f"{'TOTAL':<28}{_kb(report.full_bytes):>12}{_kb(report.optimized_bytes):>12}"
        f"{100*report.storage_saved:>8.1f}%"
    )
    return "\n".join(lines)


def _kb(n: int) -> str:
    return f"{n/1024:.1f}kb"
