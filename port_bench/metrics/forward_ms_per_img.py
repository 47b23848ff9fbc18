"""Host-clock time of the program's u8 forward calls (pad to the bucket,
copy in, network, copy out, which synchronizes) per image served."""


def read(run):
    imgs = sum(f[2] for f in run.forwards)
    return sum(f[1] - f[0] for f in run.forwards) * 1e3 / imgs if imgs else None
