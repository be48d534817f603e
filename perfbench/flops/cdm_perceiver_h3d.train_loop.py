"""Model FLOPs of one train step of the CDM with its Perceiver-IO backbone:
the forward's matrix products and attention products counted from the
configuration's shapes, and twice those for the backward; no recomputation.
Norms, softmax and elementwise work are not counted."""


def forward_per_row(s: dict) -> float:
    n, q, kv, dq = s["points"], s["q_channels"], s["kv_channels"], s["decoder_q_channels"]
    te, latents = s["time_emb_dim"], 2
    embed = 2 * 2 * te * te + 2 * n * (s["contact_dim"] + 3) * kv + 2 * s["text_dim"] * q \
        + 2 * te * q
    enc_cross = (2 * latents * q * q + 2 * 2 * n * kv * q + 2 * 2 * latents * n * q
                 + 2 * latents * q * q + 2 * latents * 2 * q * q * s["widening"])
    enc_self = s["self_layers"] * (2 * latents * 4 * q * q + 2 * 2 * latents * latents * q
                                   + 2 * latents * 2 * q * q * s["widening"])
    dec = (2 * n * kv * dq + 2 * n * dq * dq + 2 * 2 * latents * q * dq
           + 2 * 2 * n * latents * dq + 2 * n * dq * dq + 2 * n * 2 * dq * dq * s["widening"]
           + 2 * n * dq * s["contact_dim"])
    return embed + enc_cross + enc_self + dec


def flops_per_step(config: dict, traffic: dict) -> float:
    s = config["shapes"]
    return 3.0 * s["batch"] * forward_per_row(s)
