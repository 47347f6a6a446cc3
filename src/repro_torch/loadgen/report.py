"""Render open-loop sweep results: console table + BENCH payload.

The benchmark artifact (``BENCH_load.json``) carries the saturation
curve row-by-row so the ratchet gate (``benchmarks/gate.py``) can hold
a headline — goodput peak, knee position, monotone drop behaviour —
against its committed baseline.
"""
from __future__ import annotations

from .metrics import LoadResult, monotone_nondecreasing


def render_table(results: list[LoadResult]) -> str:
    """Fixed-width saturation table for the console."""
    hdr = (f"{'offered':>9} {'goodput':>9} {'ontime':>7} {'adm':>6} "
           f"{'rej':>6} {'exp':>6} {'p50ms':>8} {'p99ms':>8} {'util':>6}")
    lines = [hdr, "-" * len(hdr)]
    for r in results:
        lat = r.latency

        def fmt(v, nd=2):
            return "-" if v is None else f"{v:.{nd}f}"

        lines.append(
            f"{r.offered_rps:9.1f} {r.goodput_rps:9.1f} "
            f"{r.on_time_frac:7.3f} "
            f"{r.admitted:6d} {r.rejected:6d} {r.expired:6d} "
            f"{fmt(lat['p50_ms']):>8} {fmt(lat['p99_ms']):>8} "
            f"{fmt(r.utilization, 3):>6}")
    return "\n".join(lines)


def headline(results: list[LoadResult], knee: dict) -> dict:
    """The gate-able summary of one sweep."""
    rates = [r.rejected_rate for r in results]
    return {
        # the open-loop sanity law: more offered load can only mean an
        # equal-or-higher drop fraction (tolerance absorbs seed-level
        # Poisson granularity at sub-capacity levels)
        "rejected_rate_monotone": monotone_nondecreasing(rates, tol=0.01),
        "goodput_peak_rps": round(knee["goodput_peak_rps"], 2),
        "knee_offered_rps": round(knee["knee_offered_rps"], 2),
        "saturated": knee["saturated"],
        "levels": len(results),
    }


def payload(results: list[LoadResult], knee: dict, *,
            config: dict, quick: bool, processes: list[dict] | None = None,
            wall: list[dict] | None = None) -> dict:
    """The full ``BENCH_load.json`` document."""
    return {
        "bench": "load_harness",
        "quick": quick,
        "config": config,
        "curve": [r.to_row() for r in results],
        "knee": knee,
        "process_rows": processes or [],
        "wall_rows": wall or [],
        "headline": headline(results, knee),
    }
