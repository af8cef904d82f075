"""img_per_s: images completed in the window over its seconds (host clock;
the window ends at a synchronize)."""


def read(run):
    return run.window.images / run.window.seconds
