"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

``one_torch_thread`` is a module-scoped autouse fixture: a test file takes
it with ``from tests._torch_parity import one_torch_thread``.

``random_params`` gives a flax module parameters drawn from a numpy seed,
with the tree taken from ``jax.eval_shape`` of the module's ``init``: no
XLA compile, which costs several seconds a model on the CPU. Both packages
then read the same values, so the draw's distribution only has to keep the
models' activations of order 1.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's thread pool gains little at the tests' shapes and spins
    against the other test workers when the cores are shared (the tier-1 run
    has six): one thread a worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_params(module, *args, seed: int = 0, **kwargs) -> dict:
    """``module.init(key, *args, **kwargs)["params"]``'s tree of numpy fp32
    arrays, drawn from ``np.random.default_rng(seed)``: kernels N(0,
    1/fan_in) over their leading axes, norm scales 1 + N(0, 0.1^2), biases
    N(0, 0.02^2), LayerScale U(0.5, 1) (of order 1, so that every block
    counts), every other leaf (tokens, embeddings, codebooks, adapters)
    N(0, 0.02^2)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        name = keys[-1]
        shape = tuple(leaf.shape)
        if any(k.startswith("lora_") for k in keys):  # an adapter: a small delta
            x = 0.02 * rng.normal(size=shape)
        elif name == "kernel":
            fan_in = int(np.prod(shape[:-1])) or 1
            x = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif name == "scale":
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in ("ls1", "ls2"):
            x = rng.uniform(0.5, 1.0, shape)
        else:
            x = 0.02 * rng.normal(size=shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)
