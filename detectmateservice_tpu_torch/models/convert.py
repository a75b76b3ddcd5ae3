"""Weight bridge between the JAX package's flax param trees and the port's
``state_dict``s, through numpy, for the ``mlp``, ``gru`` and ``logbert``
families.

``mlp`` (``EmbedMLPModel``):

* ``tok_embed/embedding`` [V, D] → ``tok_embed.weight`` as is;
* ``Dense_0/kernel`` [D, H] → ``fc1.weight`` [H, D], transposed;
  ``Dense_0/bias`` → ``fc1.bias``; ``Dense_1`` → ``fc2`` the same way.

``logbert`` (``LogBERT``):

* ``tok_embed/embedding`` → ``tok_embed.weight``; ``pos_embed`` as is;
* ``blocks_{i}/LayerNorm_0`` and ``LayerNorm_1`` → ``blocks.{i}.ln1`` and
  ``ln2`` (``scale`` → ``weight``, ``bias`` → ``bias``);
* ``blocks_{i}/{qkv, proj, mlp_in, mlp_out}`` → ``blocks.{i}.{same}``,
  ``kernel`` transposed into ``weight``;
* ``final_ln`` → ``final_ln`` as a LayerNorm.

``gru`` (``GRULM``):

* ``tok_embed/embedding`` → ``tok_embed.weight``; ``bos_embed`` as is;
* ``rnns_{i}/cell/{ir, iz, in, hr, hz, hn}`` → ``rnns.{i}.{same}``,
  ``kernel`` transposed into ``weight``; ``bias`` where flax has one (not
  ``hr``, ``hz``);
* ``final_ln`` → ``final_ln`` as a LayerNorm.

The family comes from the keys (``pos_embed`` only in logbert, ``bos_embed``
only in gru) unless given.
Both directions copy, so the result never aliases its input.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_MLP_DENSE = (("Dense_0", "fc1"), ("Dense_1", "fc2"))
_LOGBERT_DENSE = ("qkv", "proj", "mlp_in", "mlp_out")
_LOGBERT_NORM = (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2"))
_GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")
FAMILIES = ("mlp", "gru", "logbert")


def _tensor(value: Any, transpose: bool = False) -> torch.Tensor:
    arr = np.asarray(value, dtype=np.float32)
    return torch.from_numpy(np.array(arr.T if transpose else arr, order="C"))


def _family(keys, given: Optional[str]) -> str:
    if given is not None:
        if given not in FAMILIES:
            raise ValueError(f"unknown model family {given!r}; expected one of {FAMILIES}")
        return given
    if "pos_embed" in keys:
        return "logbert"
    return "gru" if "bos_embed" in keys else "mlp"


def params_from_flax(tree: Mapping[str, Any],
                     family: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves; with or without the top-level
    ``"params"`` key) → the port's ``state_dict``."""
    p = tree["params"] if "params" in tree else tree
    out = {"tok_embed.weight": _tensor(p["tok_embed"]["embedding"])}
    family = _family(p, family)
    if family == "mlp":
        for flax_name, torch_name in _MLP_DENSE:
            out[f"{torch_name}.weight"] = _tensor(p[flax_name]["kernel"], transpose=True)
            out[f"{torch_name}.bias"] = _tensor(p[flax_name]["bias"])
        return out
    if family == "gru":
        out["bos_embed"] = _tensor(p["bos_embed"])
        depth = sum(1 for key in p if re.fullmatch(r"rnns_\d+", key))
        for i in range(depth):
            cell = p[f"rnns_{i}"]["cell"]
            for gate in _GRU_GATES:
                out[f"rnns.{i}.{gate}.weight"] = _tensor(cell[gate]["kernel"],
                                                         transpose=True)
                if "bias" in cell[gate]:
                    out[f"rnns.{i}.{gate}.bias"] = _tensor(cell[gate]["bias"])
        out["final_ln.weight"] = _tensor(p["final_ln"]["scale"])
        out["final_ln.bias"] = _tensor(p["final_ln"]["bias"])
        return out
    out["pos_embed"] = _tensor(p["pos_embed"])
    depth = sum(1 for key in p if re.fullmatch(r"blocks_\d+", key))
    for i in range(depth):
        blk = p[f"blocks_{i}"]
        for flax_name, torch_name in _LOGBERT_NORM:
            out[f"blocks.{i}.{torch_name}.weight"] = _tensor(blk[flax_name]["scale"])
            out[f"blocks.{i}.{torch_name}.bias"] = _tensor(blk[flax_name]["bias"])
        for name in _LOGBERT_DENSE:
            out[f"blocks.{i}.{name}.weight"] = _tensor(blk[name]["kernel"], transpose=True)
            out[f"blocks.{i}.{name}.bias"] = _tensor(blk[name]["bias"])
    out["final_ln.weight"] = _tensor(p["final_ln"]["scale"])
    out["final_ln.bias"] = _tensor(p["final_ln"]["bias"])
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor],
                   family: Optional[str] = None) -> Dict[str, Any]:
    """The port's ``state_dict`` → flax param tree with numpy leaves."""
    def arr(name: str, transpose: bool = False) -> np.ndarray:
        value = state_dict[name].detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(value.T) if transpose else value.copy()

    params: Dict[str, Any] = {"tok_embed": {"embedding": arr("tok_embed.weight")}}
    family = _family(state_dict, family)
    if family == "mlp":
        for flax_name, torch_name in _MLP_DENSE:
            params[flax_name] = {"kernel": arr(f"{torch_name}.weight", transpose=True),
                                 "bias": arr(f"{torch_name}.bias")}
        return {"params": params}
    if family == "gru":
        params["bos_embed"] = arr("bos_embed")
        depth = sum(1 for key in state_dict if re.fullmatch(r"rnns\.\d+\.ir\.weight", key))
        for i in range(depth):
            cell: Dict[str, Any] = {}
            for gate in _GRU_GATES:
                cell[gate] = {"kernel": arr(f"rnns.{i}.{gate}.weight", transpose=True)}
                if f"rnns.{i}.{gate}.bias" in state_dict:
                    cell[gate]["bias"] = arr(f"rnns.{i}.{gate}.bias")
            params[f"rnns_{i}"] = {"cell": cell}
        params["final_ln"] = {"scale": arr("final_ln.weight"), "bias": arr("final_ln.bias")}
        return {"params": params}
    params["pos_embed"] = arr("pos_embed")
    depth = sum(1 for key in state_dict if re.fullmatch(r"blocks\.\d+\.ln1\.weight", key))
    for i in range(depth):
        blk: Dict[str, Any] = {}
        for flax_name, torch_name in _LOGBERT_NORM:
            blk[flax_name] = {"scale": arr(f"blocks.{i}.{torch_name}.weight"),
                              "bias": arr(f"blocks.{i}.{torch_name}.bias")}
        for name in _LOGBERT_DENSE:
            blk[name] = {"kernel": arr(f"blocks.{i}.{name}.weight", transpose=True),
                         "bias": arr(f"blocks.{i}.{name}.bias")}
        params[f"blocks_{i}"] = blk
    params["final_ln"] = {"scale": arr("final_ln.weight"), "bias": arr("final_ln.bias")}
    return {"params": params}
