"""Share of the window the loop spent blocked on the input pipeline's next
batch, in %."""


def read(run):
    return 100.0 * run.input_wait_s / run.window_s
