"""client.ops_per_s: the closed-loop client's rate in a traced run, the
ops completed before the profiler starts over those seconds (host clock).
Per layer where the end-to-end rate is too unsteady to bound: it reads the
host's speed as much as the program's."""


def read(run):
    if not run.span_ops or run.span_s <= 0:
        return None
    return run.span_ops / run.span_s
