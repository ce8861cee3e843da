"""setup_s: seconds from the process's start to the window's: imports, the
CUDA context, the port's libraries (built here on the first run of a
checkout, loaded after), the entry's inputs and the warm-up calls."""


def read(run):
    return None if run.trace is not None else run.setup_s
