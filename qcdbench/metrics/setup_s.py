"""setup_s: seconds from the process's start to the window's start: imports,
kernel load or build, the field made or loaded, gauge copies, warm-up."""


def read(ctx):
    return ctx.setup_s
