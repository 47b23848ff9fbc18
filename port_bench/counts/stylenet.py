"""Counts of the reference stylizer (Johnson et al. 2016 with instance
norm): its forward, its training step with the VGG19 losses, and the bytes
of its instance-norm sites and of VGG conv1_1's input gradient."""

from counts.layers import conv_flops, vgg_flops

# (kind, k, C_in, C_out, stride); "t" is a stride-2 transposed conv
LAYERS = ([("c", 9, 3, 64, 2), ("c", 3, 64, 256, 2)]
          + [("c", 3, 256, 256, 1)] * 10
          + [("t", 3, 256, 64, 2), ("t", 3, 64, 32, 2), ("c", 9, 32, 3, 1)])
STYLE_TAPS = ((64, 1), (128, 2), (256, 4))  # (C, spatial divisor) of relu1_2, relu2_2, relu3_3
CONTENT_CONV = "conv4_2"
IN_FLOPS_PER_ELEMENT = 8
IN_BWD_FLOPS_PER_ELEMENT = 16


def _conv_flops(h: int, w: int):
    """Each conv's forward operations, in order."""
    out = []
    for kind, k, cin, cout, s in LAYERS:
        if kind == "c":
            h, w = h // s, w // s
            out.append(conv_flops(h, w, cin, cout, k))
        else:
            out.append(conv_flops(h, w, cin, cout, k))
            h, w = h * 2, w * 2
    return out


def forward_flops(h: int, w: int) -> float:
    """One image's stylizer forward at h x w."""
    return sum(_conv_flops(h, w))


def gram_flops(h: int, w: int) -> float:
    return sum(2.0 * c * c * (h // d) * (w // d) for c, d in STYLE_TAPS)


def train_step_flops(h: int, w: int) -> float:
    """One training image: the stylizer's forward, its weight gradients and
    the input gradients of every conv but the first (the batch needs none);
    VGG19 down to conv4_2 on the content, on the stylized image, and that
    pass's input gradients (VGG is frozen); each style Gram forward and its
    two operand gradients."""
    s = _conv_flops(h, w)
    v = vgg_flops(h, w, CONTENT_CONV)
    return sum(s) + sum(s) + sum(s[1:]) + 3.0 * v + 3.0 * gram_flops(h, w)


def in_sites(n: int, h: int, w: int):
    """(N, C, H, W) of the 14 instance-norm sites of a forward at h x w."""
    quarter = (n, 256, h // 4, w // 4)
    return ([(n, 64, h // 2, w // 2), quarter] + [quarter] * 10
            + [(n, 64, h // 2, w // 2), (n, 32, h, w)])


def _numel(shape) -> int:
    out = 1
    for d in shape:
        out *= d
    return out


def in_fwd_cost(n: int, h: int, w: int, itemsize: int):
    """(operations, bytes) the 14 IN forwards of one forward need: x read
    once, y written once."""
    numel = sum(_numel(s) for s in in_sites(n, h, w))
    return IN_FLOPS_PER_ELEMENT * numel, 2 * numel * itemsize


def in_bwd_cost(n: int, h: int, w: int, itemsize: int):
    """(operations, bytes) of the 14 IN backwards of one step: x and the
    output gradient read once, the input gradient written once."""
    numel = sum(_numel(s) for s in in_sites(n, h, w))
    return IN_BWD_FLOPS_PER_ELEMENT * numel, 3 * numel * itemsize


def conv_dx_cost(n: int, h: int, w: int, itemsize: int):
    """(operations, bytes) of VGG conv1_1's input gradient (3 -> 64, 3x3):
    the output gradient and the weights read once, dx written once."""
    flops = conv_flops(h, w, 3, 64, 3) * n
    return flops, (n * 64 * h * w + 64 * 3 * 9 + n * 3 * h * w) * itemsize
