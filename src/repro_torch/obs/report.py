"""Trace report CLI: summarize a JSONL trace, optionally emit Perfetto.

    python -m repro_torch.obs.report trace.jsonl
    python -m repro_torch.obs.report trace.jsonl --chrome trace.perfetto.json

The summary is per-request: status, token count, queue/TTFT/TBT/total
latencies (from the ``timing`` records the scheduler exports), plus a
phase-time rollup and instant-event census across the whole trace —
enough to answer "where did request 7's time go" without opening a UI.
``--chrome`` writes the Chrome ``trace_event`` conversion for
https://ui.perfetto.dev.
"""

from __future__ import annotations

import argparse
from collections import Counter as TallyCounter
from collections import defaultdict
from typing import Any, Dict, List

from repro_torch.obs.export import read_jsonl, write_chrome

__all__ = ["summarize", "main"]


def summarize(records: List[Dict[str, Any]]) -> str:
    timings = [r for r in records if r.get("kind") == "timing"]
    spans = [r for r in records if r.get("kind") == "span"]
    instants = [r for r in records if r.get("kind") == "instant"]
    lines: List[str] = []

    lines.append(f"# trace: {len(spans)} spans, {len(instants)} instants, "
                 f"{len(timings)} request timings")
    if timings:
        lines.append(f"{'rid':>5} {'status':>9} {'tok':>5} {'queue_ms':>9} "
                     f"{'ttft_ms':>9} {'tbt_p50':>8} {'tbt_p99':>8} "
                     f"{'total_ms':>9}")
        for tm in sorted(timings, key=lambda r: r["rid"]):
            lines.append(
                f"{tm['rid']:>5} {tm['status']:>9} {tm['n_tokens']:>5} "
                f"{tm['queue_ms']:>9.2f} {tm['ttft_ms']:>9.2f} "
                f"{tm['tbt_ms_p50']:>8.2f} {tm['tbt_ms_p99']:>8.2f} "
                f"{tm['total_ms']:>9.2f}")

    by_phase: Dict[str, float] = defaultdict(float)
    n_phase: TallyCounter = TallyCounter()
    for s in spans:
        if s.get("t1") is not None:
            by_phase[s["name"]] += s["t1"] - s["t0"]
            n_phase[s["name"]] += 1
    if by_phase:
        lines.append("# phase rollup (total seconds across all tracks):")
        for name, total in sorted(by_phase.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<16} {total:>10.4f}s  x{n_phase[name]}")

    tally = TallyCounter(i["name"] for i in instants)
    if tally:
        lines.append("# instant events: " + ", ".join(
            f"{name}={n}" for name, n in sorted(tally.items())))
    return "\n".join(lines)


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch.obs JSONL trace.")
    ap.add_argument("trace", help="JSONL trace file (scheduler export)")
    ap.add_argument("--chrome", metavar="OUT",
                    help="also write Chrome trace_event JSON for Perfetto")
    args = ap.parse_args(argv)
    records = read_jsonl(args.trace)
    print(summarize(records))
    if args.chrome:
        n = write_chrome(args.chrome, records)
        print(f"# wrote {args.chrome}: {n} trace events "
              f"(open at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
