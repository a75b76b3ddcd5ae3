"""Weight bridge between the JAX package's flax param tree and the port's
``state_dict``, through numpy.

The flax tree of ``EmbedMLPModel`` (``{"params": {"tok_embed":
{"embedding"}, "Dense_0": {"kernel", "bias"}, "Dense_1": ...}}``) maps as:

* ``tok_embed/embedding`` [V, D] → ``tok_embed.weight`` as is;
* ``Dense_0/kernel`` [D, H] → ``fc1.weight`` [H, D], transposed;
  ``Dense_0/bias`` → ``fc1.bias``;
* ``Dense_1`` → ``fc2`` the same way.

Both directions copy, so the result never aliases its input.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = (("Dense_0", "fc1"), ("Dense_1", "fc2"))


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves; with or without the top-level
    ``"params"`` key) → the port's ``state_dict``."""
    p = tree["params"] if "params" in tree else tree
    out = {"tok_embed.weight": torch.from_numpy(
        np.array(p["tok_embed"]["embedding"], dtype=np.float32))}
    for flax_name, torch_name in _DENSE:
        dense = p[flax_name]
        out[f"{torch_name}.weight"] = torch.from_numpy(
            np.array(np.asarray(dense["kernel"], dtype=np.float32).T, order="C"))
        out[f"{torch_name}.bias"] = torch.from_numpy(
            np.array(dense["bias"], dtype=np.float32))
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` → flax param tree with numpy leaves."""
    def arr(name: str) -> np.ndarray:
        return state_dict[name].detach().to("cpu", torch.float32).numpy().copy()

    params: Dict[str, Any] = {"tok_embed": {"embedding": arr("tok_embed.weight")}}
    for flax_name, torch_name in _DENSE:
        params[flax_name] = {"kernel": np.ascontiguousarray(arr(f"{torch_name}.weight").T),
                             "bias": arr(f"{torch_name}.bias")}
    return {"params": params}
