"""MVSNet (FeatureNet on each source view, CostRegNet on the padded cost
volume): operations from the convolutions' shapes, forward and training.
A training step adds each layer's weight gradient and, but for the first
layer of FeatureNet (the images take no gradient), its input gradient,
each as many operations as the forward."""

# FeatureNet: (cin, cout, kernel, stride)
FEATURE = [(3, 8, 3, 1), (8, 8, 3, 1), (8, 16, 5, 2), (16, 16, 3, 1),
           (16, 16, 3, 1), (16, 32, 5, 2), (32, 32, 3, 1), (32, 32, 3, 1),
           (32, 32, 1, 1)]
# CostRegNet: (cin, cout, stride); strides < 0 are the transposed
# convolutions (their operations counted at their input's size)
COSTREG = [(41, 8, 1), (8, 16, 2), (16, 16, 1), (16, 32, 2), (32, 32, 1),
           (32, 64, 2), (64, 64, 1), (64, 32, -2), (32, 16, -2), (16, 8, -2)]


def _feature_layers(h: int, w: int):
    out = []
    for cin, cout, k, s in FEATURE:
        h, w = -(-h // s), -(-w // s)
        out.append(2.0 * cin * cout * k * k * h * w)
    return out


def _costreg_layers(d: int, h: int, w: int):
    d, h, w = (-(-x // 8) * 8 for x in (d, h, w))
    out = []
    for cin, cout, s in COSTREG:
        if s > 0:
            d, h, w = d // s, h // s, w // s
            out.append(2.0 * cin * cout * 27 * d * h * w)
        else:
            out.append(2.0 * cin * cout * 27 * d * h * w)
            d, h, w = d * 2, h * 2, w * 2
    return out


def forward_flops(views: int, img_hw, planes: int, pad: int) -> float:
    h, w = img_hw
    feat = views * sum(_feature_layers(h, w))
    return feat + sum(_costreg_layers(planes, h // 4 + 2 * pad,
                                      w // 4 + 2 * pad))


def train_flops(views: int, img_hw, planes: int, pad: int) -> float:
    h, w = img_hw
    feat = _feature_layers(h, w)
    feat_train = 3 * sum(feat) - feat[0]
    reg = _costreg_layers(planes, h // 4 + 2 * pad, w // 4 + 2 * pad)
    return views * feat_train + 3 * sum(reg)
