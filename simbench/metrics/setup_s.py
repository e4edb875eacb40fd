"""setup_s: from the process's start to the window's opening: imports, the
inputs drawn from the seed, the bulk load, the pages made resident and the
warm-up (and, in a checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
