"""Process start to the first timed step: imports, the kernels' build or
load, the env and policy, the warm-up steps (host clock)."""


def read(run):
    return run.setup_s
