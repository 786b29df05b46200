"""prefill_us_per_token.llm: the summed length of the executor's own
``prefill`` spans (`CutieEngine.trace_export`) over the prompt tokens
they computed, in microseconds a token.  Only spans that began in the
window's untraced part count: the profiler slows the host.  A sum over
every prefill, since the prompt lengths fall into buckets whose times
differ by half, and a median would jump between them."""


def read(run):
    w = run["window"]
    spans = [(b - a, args["computed"]) for n, a, b, args
             in run["program_spans"]
             if n == "prefill" and run["t_untraced"] <= a < w["t_end"]]
    tokens = sum(t for _, t in spans)
    return 1e6 * sum(s for s, _ in spans) / tokens if tokens else None
