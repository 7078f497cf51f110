"""Per cent of its roofline reached by the v1 render body K11; None where
K11 never launched (the parent's program renders v1 on the module)."""
from gpu_bench.readers import render_roofline

# K11 (`render_v1_feats`: the colour attention, PE, MLP, compositing) by
# its name on the card; `readers.K8` does not match it
K11 = r"\brender_v1_kernel\b"


def read(ctx):
    return render_roofline(ctx, K11, "render_v1_feats.launches", "mlp_v1")
