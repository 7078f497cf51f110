"""The v1 attention MLP (D=6, W=128, additive bias, no skip; 63 PE + 20
feature + 3 direction inputs; a 4-head attention over 3 tokens of 12):
its operations and bytes per sample for the render body (K11: the colour
attention, PE, MLP and compositing)."""

IN_PTS, IN_VIEWS, W = 63, 3, 128
N_VIEWS, D_MODEL, N_HEAD, D_K = 3, 12, 4, 4
LAYERS = [(IN_PTS, W), (W, W), (W, W), (W, W), (W, W), (W, W),
          (8 + 3, W), (W, W), (W, 1), (W + IN_VIEWS, W // 2), (W // 2, 3)]
MACS = sum(i * o for i, o in LAYERS)   # 116,480: trunk, pts_bias, heads
# the attention a sample, each product over the 3 tokens: q, k, v; the
# scores and their weighted values in each head; fc; weight_out
ATTENTION = [(N_VIEWS, D_MODEL, N_HEAD * D_K)] * 3 + [
    (N_HEAD * N_VIEWS, D_K, N_VIEWS), (N_HEAD * N_VIEWS, N_VIEWS, D_K),
    (N_VIEWS, N_HEAD * D_K, D_MODEL), (N_VIEWS, D_MODEL, 3)]
ATTENTION_MACS = sum(m * k * n for m, k, n in ATTENTION)   # 2,700
FLOPS = 2 * (MACS + ATTENTION_MACS)    # 238,360 a sample, forward


def render_flops(samples: int) -> float:
    """K11's operations for `samples` samples: the MLP forward."""
    return float(FLOPS) * samples


def render_bytes(rays: int, samples_per_ray: int) -> float:
    """K11's inputs (NDC, depth, the 20 features a sample that K8 reads,
    a direction a ray) and outputs (rgb, depth, acc a ray; a weight, an
    alpha and the 14 folded features, [volume | colour | colour], a
    sample)."""
    n = rays * samples_per_ray
    return 4.0 * (n * (3 + 1 + 20 + 1 + 1 + 14) + rays * (3 + 5))
