"""Set-up seconds (host clock): from the process's start to the window's,
through the imports, the card's context, the kernel library's load (and
build, in a run that builds it), the data and one short warm fit at the
cell's shapes."""


def read(run):
    return run.setup_s
