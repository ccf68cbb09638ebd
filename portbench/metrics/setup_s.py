"""Process start to the window's opening: CUDA start-up, the kernels
loaded (built on a checkout's first run), weights and tables drawn and
placed, the engine built and the clients' staggered warm-up."""


def read(run):
    return run.setup_s
