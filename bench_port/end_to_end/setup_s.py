"""From process start to the first timed request, less the corpus's
generation (s): imports, the CUDA context, the kernel library's load (its
build on a checkout's first run), the entry's set-up and one warm-up
request."""


def read(ctx):
    return ctx.setup_s
