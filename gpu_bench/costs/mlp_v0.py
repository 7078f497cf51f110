"""The v0 NeRF MLP (D=6, W=128, a skip after layer 4; 63 PE + 20
feature + 3 direction inputs): its operations and bytes per sample, for
the render body (K8: PE, MLP and compositing) and the training MLP (K7)."""

IN_PTS, IN_FEAT, IN_VIEWS, W = 63, 20, 3, 128
LAYERS = [(IN_PTS, W), (W, W), (W, W), (W, W), (W, W), (W + IN_PTS, W),
          (IN_FEAT, W), (W, W), (W, 1), (W + IN_VIEWS, W // 2), (W // 2, 3)]
MACS = sum(i * o for i, o in LAYERS)   # 125,696
FLOPS = 2 * MACS                       # 251,392 a sample, forward


def render_flops(samples: int) -> float:
    """K8's operations for `samples` samples: the MLP forward."""
    return float(FLOPS) * samples


def render_bytes(rays: int, samples_per_ray: int) -> float:
    """K8's inputs (NDC, depth, 20 features a sample, a direction a ray)
    and outputs (rgb, depth, acc a ray; a weight a sample)."""
    n = rays * samples_per_ray
    return 4.0 * (n * (3 + 1 + 20 + 1) + rays * (3 + 5))


def train_flops(samples: int) -> float:
    """K7 forward and backward (input and weight gradients)."""
    return 3.0 * FLOPS * samples

