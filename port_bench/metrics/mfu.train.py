"""The training step's operations per image times the images of the
window, over the window and the card's published dense peak at the
configuration's precision (float32 with TF32 off: the rate outside the
tensor cores), in %."""


def read(run):
    if run.peaks is None:
        return None
    side = run.traffic["image_size"]
    flops = run.counts.train_step_flops(side, side) * run.images
    return 100.0 * flops / (run.window_s * run.peaks["flops"][run.config["precision"]])
