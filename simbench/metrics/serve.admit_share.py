"""serve.admit_share: the share of the window's host time, before the
profiler starts, spent in the program's ``serve.admit`` spans (a request's
prefill and its prompt's mirror into the paged cache); 0 where no request
was admitted then, nothing where the program has no serve spans."""
from simbench.systems import lm


def read(run):
    totals = lm.WINDOW.get("spans", {})
    if "serve.decode" not in totals or run.span_s <= 0:
        return None
    return totals.get("serve.admit", (0, 0, 0))[1] * 1e-9 / run.span_s
