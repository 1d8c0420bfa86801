"""Shared helpers of the tests that hold the PyTorch port against the JAX
package."""

import numpy as np


def np_params(spec, c=3, seed=11):
    """HWIO params drawn with numpy (torch-default uniform bounds) in the
    JAX package's layout; both packages get the same arrays."""
    rng = np.random.RandomState(seed)

    def conv(k, cin, cout):
        bound = 1.0 / np.sqrt(cin * k * k)
        return {"w": rng.uniform(-bound, bound, (k, k, cin, cout))
                .astype(np.float32),
                "b": rng.uniform(-bound, bound, cout).astype(np.float32)}

    params = []
    for layer in spec:
        if layer.kind == "squeeze":
            c *= 4
        if layer.kind != "glow":
            params.append(None)
            continue
        len1, len2, k, h = layer.split_len1, c - layer.split_len1, \
            layer.kernel, layer.hidden
        params.append({
            "s1": {"conv1": conv(k, len1, h), "conv2": conv(k, h, 2 * len2)},
            "s2": {"conv1": conv(k, len2, h), "conv2": conv(k, h, 2 * len1)}})
    return params
