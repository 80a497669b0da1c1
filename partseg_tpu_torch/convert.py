"""Carry the JAX package's PartNet parameters across to the port.

Flax numbers submodules per class in the order they are called
(``shape_enc/Hourglass_0/ResBlock_5/ConvBlock_1/Conv_0/kernel``); the
port's modules keep those orders (the hourglass's ``blocks`` list is in
call order), so each Flax path maps to one ``state_dict`` key:

  conv kernel HWIO → weight OIHW;  Dense kernel [in, out] → weight [out, in];
  GroupNorm scale → weight;        bias → bias.

Every Flax leaf is consumed exactly once; an unknown name or a second
leaf for the same key raises.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# kind → [(Flax child-name pattern, torch child-name template, child kind)]
_CHILDREN: dict[str, list[tuple[str, str, str]]] = {
    "partnet": [("shape_enc", "shape_enc", "shape_enc"),
                ("app_enc", "app_enc", "app_enc"),
                ("decoder", "decoder", "decoder")],
    "shape_enc": [(r"_Stem_0", "stem", "stem"),
                  (r"Hourglass_(\d+)", "hourglasses.{0}", "hourglass"),
                  (r"ConvBlock_0", "head_block", "convblock"),
                  (r"Conv_0", "head", "conv")],
    "app_enc": [(r"_Stem_0", "stem", "stem"),
                (r"Hourglass_0", "hourglass", "hourglass"),
                (r"ConvBlock_0", "head_block", "convblock"),
                (r"Conv_0", "head", "conv")],
    "stem": [(r"Conv_0", "conv", "conv"), (r"ResBlock_0", "res", "resblock")],
    "hourglass": [(r"ResBlock_(\d+)", "blocks.{0}", "resblock")],
    "resblock": [(r"GroupNorm_0", "norm", "norm"),
                 (r"ConvBlock_([0-2])", "convs.{0}", "convblock"),
                 (r"Conv_0", "skip", "conv")],
    "convblock": [(r"GroupNorm_0", "norm", "norm"), (r"Conv_0", "conv", "conv")],
    "decoder": [(r"app_proj_(\d+)", "app_proj.{0}", "dense"),
                (r"ResBlock_(\d+)", "blocks.{0}", "resblock"),
                (r"Conv_0", "to_rgb", "conv")],
}

_LEAVES = {
    "conv": {"kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1)), "bias": ("bias", None)},
    "dense": {"kernel": ("weight", lambda a: a.T), "bias": ("bias", None)},
    "norm": {"scale": ("weight", None), "bias": ("bias", None)},
}


def flatten_params(params: Mapping) -> dict[str, np.ndarray]:
    """Nested Flax dict (with or without the top-level "params") or an
    already flat ``/``-keyed dict → flat ``/``-keyed numpy dict."""
    if set(params) == {"params"} and isinstance(params["params"], Mapping):
        params = params["params"]
    flat: dict[str, np.ndarray] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            path = f"{prefix}/{name}" if prefix else name
            if isinstance(value, Mapping):
                walk(value, path)
            else:
                flat[path] = np.asarray(value)

    walk(params, "")
    return flat


def _torch_key(path: str, root: str) -> tuple[str, callable]:
    *mods, leaf = path.split("/")
    kind, out = root, []
    for seg in mods:
        for pattern, template, child in _CHILDREN.get(kind, []):
            m = re.fullmatch(pattern, seg)
            if m:
                out.append(template.format(*m.groups()))
                kind = child
                break
        else:
            raise KeyError(f"no port module for Flax path {path!r} (at {seg!r} in a {kind})")
    if kind not in _LEAVES or leaf not in _LEAVES[kind]:
        raise KeyError(f"no port parameter for Flax leaf {path!r}")
    name, fn = _LEAVES[kind][leaf]
    return ".".join(out + [name]), fn


def flax_to_state_dict(params: Mapping, root: str = "partnet") -> dict[str, torch.Tensor]:
    """The JAX package's params (numpy leaves) → the port's state_dict (f32
    tensors on the CPU). ``root`` names the module the params belong to:
    "partnet" (default) or one of its parts ("shape_enc", "app_enc",
    "decoder", "stem", "hourglass", "resblock", "convblock")."""
    if root not in _CHILDREN:
        raise KeyError(f"unknown root module kind {root!r}; known: {sorted(_CHILDREN)}")
    state: dict[str, torch.Tensor] = {}
    for path, value in flatten_params(params).items():
        key, fn = _torch_key(path, root)
        if key in state:
            raise KeyError(f"two Flax leaves map to {key!r} (second: {path!r})")
        arr = fn(value) if fn is not None else value
        state[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return state


def load_flax_params(model: torch.nn.Module, params: Mapping,
                     root: str = "partnet") -> torch.nn.Module:
    """Load JAX params into ``model``; raises unless every parameter of
    the model is covered and every Flax leaf is used, with equal shapes."""
    state = flax_to_state_dict(params, root)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing[:5]}, unused {extra[:5]}")
    for key, value in state.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: port shape {tuple(own[key].shape)}, "
                             f"converted {tuple(value.shape)}")
    model.load_state_dict(state, strict=True)
    return model


def save_npz(path, state: Mapping[str, torch.Tensor]) -> None:
    """Write a state_dict as an .npz of f32 arrays (keys unchanged)."""
    np.savez(path, **{k: v.detach().cpu().float().numpy() for k, v in state.items()})


def load_npz(path) -> dict[str, torch.Tensor]:
    """Read a state_dict written by ``save_npz``."""
    with np.load(path) as data:
        return {k: torch.from_numpy(data[k].copy()) for k in data.files}
