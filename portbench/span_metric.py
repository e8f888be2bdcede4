"""The readers of the program's own spans (``refinedet_tpu_torch/utils/
timer.span``), metrics of source ``program_span``.

``read_span(rec, name)`` takes the records of the traced stretch, the last
``steps - untraced_steps`` (outermost span, id) keys of the timer's ring,
and gives the span's device ms per step or call: the elapsed time between
its two CUDA events, summed over the stretch and divided by its length.
None where the ring holds fewer ids, where the span was not timed on the
card, or where the program has no spans at all.

The events bracket the span on the card's stream, so the reading holds
the card's idle time inside the span besides its work: where the host,
slowed by the profiler, falls behind the card within a phase, the phase
reads longer. A phase that the card runs back to back reads its work.
"""


def read_span(rec, name):
    from refinedet_tpu_torch.utils import timer
    w = rec["window"]
    n = w["steps"] - w["untraced_steps"]
    if not n or not hasattr(timer, "span_records"):
        return None
    recs = timer.span_records(last_ids=n)
    if len({(r.root, r.id) for r in recs}) < n:
        return None
    ms = timer.span_summary(recs).get(name, {}).get("device_ms")
    return None if ms is None else ms / n
