"""Operation counts of convolutions, as PyTorch's ``FlopCounterMode``
counts them: 2 * N * C_in * C_out * k * k per output position of a
convolution, and per input position of a transposed one."""


def conv_flops(h_out: int, w_out: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h_out * w_out * cin * cout * k * k


def vgg_convs(deepest: str):
    """(name, C_in, C_out, spatial divisor) of VGG19's convs down to
    ``deepest`` (a conv name), in forward order."""
    cfg = [("conv1_1", 3, 64), ("conv1_2", 64, 64), ("pool", 0, 0),
           ("conv2_1", 64, 128), ("conv2_2", 128, 128), ("pool", 0, 0),
           ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
           ("conv3_4", 256, 256), ("pool", 0, 0),
           ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
           ("conv4_4", 512, 512)]
    out, div = [], 1
    for name, cin, cout in cfg:
        if not cin:
            div *= 2
            continue
        out.append((name, cin, cout, div))
        if name == deepest:
            return out
    raise ValueError(f"unknown VGG19 conv {deepest!r}")


def vgg_flops(h: int, w: int, deepest: str) -> float:
    """One image's VGG19 forward down to ``deepest``."""
    return sum(conv_flops(h // d, w // d, cin, cout, 3)
               for _, cin, cout, d in vgg_convs(deepest))
