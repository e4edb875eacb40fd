"""ops_per_s: the operations completed in the window over the window's
seconds, host clock, from its opening to the completion of its last op."""


def read(run):
    return run.ops / run.window_s if run.ops and run.window_s > 0 else None
