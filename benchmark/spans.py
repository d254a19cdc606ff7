"""The port's own spans and counters of the profiled episode
(`cyclistsocialforce_tpu_torch.tracing`), read by the per-layer metrics
whose source is `program_span` or `program_counter`. The port records
while a profiler runs, so after the traced episode its recorder holds
that episode and nothing else."""

from __future__ import annotations

PREFIX = "csf::"


def report(ctx):
    """The recorder's report of the profiled episode (`ctx["program_report"]`
    where the caller hands one, else the live one), or None: where the
    program has no recorder (a checkout from before it), or the report
    covers no steps or other steps than the trace (the recorder and the
    profiler did not cover the same episode)."""
    if "program_report" in ctx:
        rep = ctx["program_report"]
    else:
        try:
            from cyclistsocialforce_tpu_torch import tracing
        except ImportError:
            return None
        rep = tracing.report()
    if not rep or not rep.get("steps") or rep["steps"] != ctx["steps"]:
        return None
    return rep


def stream_ms_per_step(ctx, names):
    """The stream time of the spans `names` (without their prefix) per
    step, or None where no such span ran or none has a stream time (a
    run without a card)."""
    rep = report(ctx)
    if rep is None:
        return None
    spans = [rep["spans"].get(PREFIX + n) for n in names]
    ms = [s["stream_ms"] for s in spans if s is not None]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / rep["steps"]
