"""Seconds from the start of the process to the first timed step or
chunk: imports, the CUDA context, kernels from the build cache (built on
a checkout's first run), inputs and weights made from the seed, the
program's set-up, the first steps that the check follows, warm-up."""


def read(run):
    return run.setup_s
