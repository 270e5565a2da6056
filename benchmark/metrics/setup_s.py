"""setup_s: seconds from process start to the first timed operation
(the kernel library's build or load, the ack ring, the CUDA context
and the warm-up ticks)."""


def read(ctx):
    return ctx["setup_s"]
