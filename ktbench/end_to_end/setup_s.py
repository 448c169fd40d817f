"""Set-up: from the process's start to the first timed request (imports,
the CUDA context, the graphs, any kernel build, the warm requests)."""


def read(window):
    return window.setup_s
