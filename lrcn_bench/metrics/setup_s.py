"""setup_s: seconds from the process's start to the window's: imports,
CUDA start, the kernel library (built on a checkout's first run, loaded
after), weights and inputs made on the card, the warm-up calls and the
capture of the cell's one program."""


def read(run):
    return run.setup_s
