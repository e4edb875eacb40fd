"""model.mamba_us_per_token: host time in the program's ``model.mamba``
spans (every layer's mamba heads, prefill and decode) over the tokens the
model ran (prompt tokens prefilled and decode steps), before the profiler
starts."""
from simbench.systems import lm


def read(run):
    total = lm.WINDOW.get("spans", {}).get("model.mamba")
    counts = lm.WINDOW.get("counters", {})
    tokens = counts.get("prefill_tokens", 0) + counts.get("decodes", 0)
    if total is None or not tokens:
        return None
    return total[1] * 1e-3 / tokens
