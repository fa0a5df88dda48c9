"""setup_s: seconds from the process's start to the first timed item:
imports, the card's context, the kernel library's load (its build on a
checkout's first run) and the cell's warm-up."""


def read(run):
    return run.setup_s
