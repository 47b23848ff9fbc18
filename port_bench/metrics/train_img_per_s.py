"""Images the training steps consumed in the window over the window's
seconds: every step, the whole window."""


def read(run):
    return run.images / run.window_s
