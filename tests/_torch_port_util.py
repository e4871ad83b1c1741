"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy
inputs go through a JAX function and its PyTorch counterpart."""

import numpy as np
import jax
import torch


def to_numpy_tree(variables):
    return jax.tree.map(np.asarray, variables)


def numpy_variables(module, *args, seed=0, scale=0.1, **kwargs):
    """flax variables for ``module`` with every leaf drawn from numpy:
    ``eval_shape`` of ``init`` gives the tree without running (or compiling)
    the initialisers, and random biases and LayerNorm scales test more than
    flax's zeros and ones would."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: (rs.randn(*s.shape) * scale).astype(np.float32), shapes)


def t(a):
    """numpy → torch tensor (CPU), dtype kept."""
    return torch.from_numpy(np.ascontiguousarray(a))


def n(x):
    """torch tensor or jax array → float/bool numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def load(module, state_dict):
    """Strict load, eval mode."""
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def ragged_mask(rs, b, n_rows, low=None):
    """(b, n_rows) bool mask with a ragged number of leading valid rows."""
    n_valid = rs.randint(low if low is not None else n_rows // 2,
                         n_rows + 1, (b, 1))
    return np.arange(n_rows)[None] < n_valid
