"""How far the superpixels' k-means parts ways on a last-bit difference: the
JAX package's ``_superpixels`` compiled against the same function run eagerly
(op by op), and the port's against the compiled one, on the inputs and draws
of ``tests/test_torch_port_augment_heavy.py::test_superpixels_match_jax``.
Prints, per size, the share of pixels more than 0.05 apart (on 0..255), over
the batch and per sample. Not a test: it explains that test's bounds.

Run: ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/diag_torch_port_superpixels_spread.py``
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pointcloududa_tpu.ops import augment as jaug
from pointcloududa_torch.ops import augment as taug
from test_torch_port_augment_heavy import PIPE_ATOL, _batch, _images, _superpixel_draws


def shares(a, b):
    differ = (np.abs(a - b).max(-1) > PIPE_ATOL).reshape(len(a), -1).mean(1)
    return f"{differ.mean():.4f} (per sample {np.round(differ, 4).tolist()})"


def main():
    torch.set_num_threads(1)
    cfg = jaug.heavy()
    for size, b in ((48, 6), (130, 3)):
        img = _images(7, b=b, h=size, w=size)
        keys = jax.random.split(jax.random.PRNGKey(7), b)
        compiled = np.asarray(jax.jit(jax.vmap(lambda k, im: jaug._superpixels(k, im, cfg)))(keys, img))
        eager = np.stack([np.asarray(jaug._superpixels(k, jnp.asarray(im), cfg)) for k, im in zip(keys, img)])
        port = taug.apply_op("superpixels", torch.tensor(img), _batch(lambda k: _superpixel_draws(k, cfg, size, size), keys)).numpy()
        print(f"{size}^2: JAX eager vs compiled {shares(eager, compiled)}; port vs JAX compiled {shares(port, compiled)}")


if __name__ == "__main__":
    main()
