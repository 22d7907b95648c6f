"""Operations of a CNN Q-network's forward and backward pass, from its shapes:
the count module of the configurations that name it under `"counts"`
(`forward_flops`, `learn_flops`; read by `core/readers.py`'s `mfu`).

A multiply-add counts two operations; biases, activations and the loss are
left out. A convolution over an (H, W) input with kernel k, stride s and
padding p makes ((H + 2p - k) // s + 1) x ((W + 2p - k) // s + 1) outputs per
output channel, each over in_channels x k x k inputs.
"""

from __future__ import annotations

from typing import Dict, List


def layer_flops(config: dict) -> List[Dict]:
    """[{"kind": "conv" | "dense", "flops": forward operations a frame}]."""
    net, env = config["network"], config["env"]
    H, W = env["height"], env["width"]
    c = config["history_length"] * env["frames"]
    out = []
    for oc, k, s, p in zip(net["out_channels"], net["kernel_sizes"], net["strides"],
                           net["paddings"]):
        H, W = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
        out.append({"kind": "conv", "flops": 2 * oc * H * W * c * k * k})
        c = oc
    d = c * H * W
    for h in (*net["hidden_dims"], env["num_actions"]):
        out.append({"kind": "dense", "flops": 2 * d * h})
        d = h
    return out


def forward_flops(config: dict) -> int:
    """One window's forward pass."""
    return sum(layer["flops"] for layer in layer_flops(config))


def learn_flops(config: dict) -> Dict[str, int]:
    """One DQN learn's operations by layer kind: for each row of the batch,
    the online network's forward, its backward (the weights' gradient of
    every layer and the input's gradient of every layer but the first, whose
    input needs none) and the target network's forward."""
    batch = config["learner"]["batch_size"]
    out = {"conv": 0, "dense": 0}
    for i, layer in enumerate(layer_flops(config)):
        passes = 4 if i > 0 else 3
        out[layer["kind"]] += batch * passes * layer["flops"]
    return out
