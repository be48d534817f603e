"""Model FLOPs of one train step of the CMDM ``trans_enc``: the forward's
matrix products and attention products (the transformer's QK^T and AV, the
point layers' weighted sums over their neighbours) counted from the
configuration's shapes, and twice those for the backward; no recomputation.
Gathers, norms, softmax and elementwise work are not counted."""


def point_block(n: int, c: int, k: int) -> float:
    """One PointTransformerBlock on ``n`` points of ``c`` channels and ``k``
    neighbours: linear1, q, k, v, linear3; the position MLP (3 -> 3 -> c) and
    the weight MLP (c -> c/8 -> c/8) on every neighbour; the weighted sum."""
    mid = c // 8
    return (5 * 2 * n * c * c + n * k * (2 * 3 * 3 + 2 * 3 * c)
            + n * k * (2 * c * mid + 2 * mid * mid) + 2 * n * k * c)


def forward_per_row(s: dict) -> float:
    d, f, t = s["latent_dim"], s["dim_feedforward"], s["tokens"]
    layers = s["num_layers"] * (t * 2 * d * (4 * d + 2 * f) + t * 4 * t * d)
    adapters = (2 * s["text_dim"] * d * s["text_tokens"] + 2 * s["motion_dim"] * d * s["horizon"]
                + 2 * s["planes"][-1] * d * s["groups"] + 2 * d * s["motion_dim"] * s["horizon"]
                + 2 * 2 * s["time_emb_dim"] * d)
    encoder, c_in, n = 0.0, 3 + s["contact_dim"], s["points"]
    for i, (c, blocks, stride, k) in enumerate(zip(s["planes"], s["blocks"], s["strides"],
                                                   s["nsamples"])):
        if stride == 1:
            encoder += 2 * n * c_in * c
        else:
            n //= stride
            encoder += 2 * n * k * (3 + c_in) * c
        encoder += (blocks - 1) * point_block(n, c, k)
        c_in = c
    return layers + adapters + encoder


def flops_per_step(config: dict, traffic: dict) -> float:
    s = config["shapes"]
    return 3.0 * s["batch"] * forward_per_row(s)
