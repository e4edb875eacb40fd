"""serve.table_us_per_token: host time in the program's ``serve.mirror``
spans (a token's SiM block-table lookup, page allocation and table-page
program) over the tokens mirrored, before the profiler starts."""
from simbench.systems import lm


def read(run):
    total = lm.WINDOW.get("spans", {}).get("serve.mirror")
    tokens = lm.WINDOW.get("counters", {}).get("mirrored", 0)
    if total is None or not tokens:
        return None
    return total[1] * 1e-3 / tokens
