"""VGG19's convolutional features (Simonyan & Zisserman 2014) in plain
torch, float32: 3x3 zero-padded convolutions, ReLU, 2x2 max pools, taps by
layer name (``relu1_2``, ``conv4_2``, ...). The repository holds no ImageNet
weights, so the benchmark draws them from the seed (He-normal, zero
biases); speed does not depend on them."""

import torch
import torch.nn.functional as F

CFG = [("conv1_1", 3, 64), ("conv1_2", 64, 64), ("pool1", 0, 0),
       ("conv2_1", 64, 128), ("conv2_2", 128, 128), ("pool2", 0, 0),
       ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
       ("conv3_4", 256, 256), ("pool3", 0, 0),
       ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
       ("conv4_4", 512, 512), ("pool4", 0, 0),
       ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
       ("conv5_4", 512, 512)]


def param_spec():
    """(name, shape, init, fan_in) of VGG19's 16 convolutions."""
    spec = []
    for name, cin, cout in CFG:
        if cin:
            spec += [(f"{name}.weight", (cout, cin, 3, 3), "he_normal", cin * 9),
                     (f"{name}.bias", (cout,), "zero", 0)]
    return spec


def features(p, x, taps, conv=F.conv2d):
    """NCHW float32 in; ``{tap: activation}`` for each requested tap, the
    walk stopping at the deepest."""
    order = []
    for name, cin, _ in CFG:
        order.append(name)
        if cin:
            order.append("relu" + name[4:])
    deepest = max(order.index(t) for t in taps)
    out, h = {}, x
    for name in order[:deepest + 1]:
        if name.startswith("conv"):
            h = conv(h, p[name + ".weight"], p[name + ".bias"], padding=1)
        elif name.startswith("relu"):
            h = torch.relu(h)
        else:
            h = F.max_pool2d(h, 2, 2)
        if name in taps:
            out[name] = h
    return out
