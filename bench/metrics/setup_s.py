"""setup_s (host clock): process start to the first timed batch: imports,
the CUDA context, the kernels' build or load, the weights drawn, the
captures at every prompt length."""


def read(run):
    return run.setup_s
