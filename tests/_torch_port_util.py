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


def ct_variables(variables, seed=1):
    """``numpy_variables`` of a module that holds a CT trunk, made fit for a
    17-layer-deep comparison: BatchNorm variances positive, BatchNorm scales
    around 1 and conv kernels He-scaled, so that the layer4 map neither
    vanishes nor overflows and a wrong weight layout shows."""
    def fix(node, in_bn=False):
        out = {}
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                out[key] = fix(leaf, in_bn or key == "bn")
            elif key == "var":
                out[key] = np.abs(leaf) + 0.5
            elif key == "scale" and in_bn:
                out[key] = 1.0 + leaf
            elif key == "kernel" and leaf.ndim >= 4:
                fan_in = int(np.prod(leaf.shape[:-1]))
                out[key] = (leaf * 10.0 * np.sqrt(2.0 / fan_in)).astype(
                    np.float32)
            else:
                out[key] = leaf
        return out
    return fix(to_numpy_tree(variables))


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
