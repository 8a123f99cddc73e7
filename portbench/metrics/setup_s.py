"""setup_s: the run's whole set-up on the host clock, from the start of
``run.py`` (before torch is imported) to the start of the window: CUDA
context, the kernel library (built on a checkout's first run, loaded
after), the inputs made from the seed, the warm-up."""


def read(run):
    return run.setup_s
