"""The LM side of the port: model configs, layers, attention, MoE, SSD and
the decoder-only transformer, as plain functions on dicts of tensors in
the reference's tree layout."""
import numpy as np
import torch

from .config import ModelConfig, MoEConfig, SSMConfig
from .transformer import (block_kinds, decode_step, forward, init_cache,
                          init_params, lm_loss, tree_leaves, tree_map,
                          tree_unflatten)


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a numpy dtype torch knows: carry bits
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_numpy(tree, cfg: ModelConfig, device="cpu") -> dict:
    """The port's parameter tree from a tree of numpy arrays in the
    reference's layout (``init_params``' dicts and the ``tail`` list, its
    leaves as ``np.asarray`` gives them): the carry-over of parameters made
    elsewhere, such as the reference's, so both packages compute the same
    function.  Floating leaves must have ``cfg``'s parameter dtype."""
    out = tree_map(lambda x: _leaf(x, device), tree)
    for leaf in tree_leaves(out):
        if leaf.is_floating_point() and leaf.dtype != cfg.pdtype():
            raise ValueError(f"a {leaf.dtype} leaf in a {cfg.param_dtype} "
                             f"tree")
    return out


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "block_kinds",
           "decode_step", "forward", "init_cache", "init_params", "lm_loss",
           "params_from_numpy", "tree_leaves", "tree_map",
           "tree_unflatten"]
