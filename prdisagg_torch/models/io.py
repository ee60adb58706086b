"""Weight import and export: the JAX package's ``.npz`` and the reference's
Keras ``.h5``.

Both formats hold a net as a tree of ``{kernel, bias}`` numpy arrays in the
Flax/Keras layouts: Dense kernels (in, out), Conv3D kernels (kd, kh, kw, in,
out).  The generator's tree is ``{latent_proj, conv0.., head}``, the
critic's ``{conv0..conv3, score}``.  :func:`params_from_jax` and
:func:`critic_params_from_jax` turn a tree into the port's ``state_dict``;
:func:`params_to_jax` goes back, and :func:`save_params_npz` writes the JAX
package's ``params/<layer>/<kind>`` layout.

Keras layer mapping: dense -> latent_proj, conv3d/_1/_2 -> conv0..2,
conv3d_3 -> head.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from prdisagg_torch.core.config import ModelConfig


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _unwrap(tree):
    return tree["params"] if "params" in tree and isinstance(
        tree["params"], dict) else tree


def load_params_npz(path: str):
    """Read the JAX package's flat ``.npz`` (keys like
    ``params/conv0/kernel``) into a nested tree of numpy arrays."""
    with np.load(path) as f:
        return _unflatten({k: f[k] for k in f.files})


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:  # the JAX loader canonicalizes to float32 too
        a = a.astype(np.float32)
    return torch.tensor(a)


def _conv_names(p):
    """conv0, conv1, ... of a tree, in numeric order."""
    return sorted((k for k in p if re.fullmatch(r"conv\d+", k)),
                  key=lambda s: int(s[4:]))


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX/Keras generator tree -> the port's ``Generator`` state_dict.

    Dense (in, out) becomes ``nn.Linear``'s (out, in); the stage kernels keep
    (3, 3, 3, Cin, Cout); the head becomes ``F.conv3d``'s (Cout, Cin, 3, 3, 3).
    """
    p = _unwrap(tree)
    sd = {"latent_proj.weight": _to_tensor(p["latent_proj"]["kernel"]).T
          .contiguous(),
          "latent_proj.bias": _to_tensor(p["latent_proj"]["bias"])}
    for name in _conv_names(p):
        sd[f"{name}.weight"] = _to_tensor(p[name]["kernel"])
        sd[f"{name}.bias"] = _to_tensor(p[name]["bias"])
    sd["head.weight"] = _to_tensor(p["head"]["kernel"]).permute(
        4, 3, 0, 1, 2).contiguous()
    sd["head.bias"] = _to_tensor(p["head"]["bias"])
    return sd


def critic_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX/Keras critic tree -> the port's ``Critic`` state_dict: conv
    kernels keep (3, 3, 3, Cin, Cout); the score Dense (in, 1) becomes
    ``nn.Linear``'s (1, in)."""
    p = _unwrap(tree)
    sd = {}
    for name in _conv_names(p):
        sd[f"{name}.weight"] = _to_tensor(p[name]["kernel"])
        sd[f"{name}.bias"] = _to_tensor(p[name]["bias"])
    sd["score.weight"] = _to_tensor(p["score"]["kernel"]).T.contiguous()
    sd["score.bias"] = _to_tensor(p["score"]["bias"])
    return sd


def params_to_jax(state_dict) -> dict:
    """A port ``Generator`` or ``Critic`` state_dict -> the JAX tree
    ``{"params": {layer: {kernel, bias}}}`` of float32 numpy arrays."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    layers = {k.split(".")[0] for k in sd}
    out = {}
    for name in layers:
        w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
        if name in ("latent_proj", "score"):
            w = w.T
        elif name == "head":
            w = w.transpose(2, 3, 4, 1, 0)
        out[name] = {"kernel": np.ascontiguousarray(w), "bias": b}
    return {"params": out}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_params_npz(path: str, params) -> None:
    """Write a JAX-layout tree (:func:`params_to_jax`) as the JAX package's
    flat ``.npz`` (keys like ``params/conv0/kernel``).  Atomic: a reader
    never sees half a file."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(fh, **_flatten(params))
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Keras .h5 import
# ---------------------------------------------------------------------------

_LAYER_RE = re.compile(r"^(dense|conv3d)(?:_(\d+))?$")


def _collect_keras_layers(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Walk an .h5 file collecting {layer_name: {kernel, bias}} for every
    dense/conv3d layer, regardless of group nesting."""
    import h5py

    layers: Dict[str, Dict[str, np.ndarray]] = {}

    def visit(name, obj):
        if not isinstance(obj, h5py.Dataset):
            return
        parts = name.split("/")
        leaf = parts[-1].split(":")[0]
        if leaf not in ("kernel", "bias"):
            return
        layer = next(
            (p for p in reversed(parts[:-1]) if _LAYER_RE.match(p)), None
        )
        if layer is None:
            return
        layers.setdefault(layer, {})[leaf] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return layers


def _sorted_by_kind(layers: Dict[str, Dict[str, np.ndarray]], kind: str):
    """Keras auto-names layers kind, kind_1, kind_2, ... in creation order."""
    found: list[Tuple[int, str]] = []
    for name in layers:
        m = _LAYER_RE.match(name)
        if m and m.group(1) == kind:
            found.append((int(m.group(2) or 0), name))
    return [layers[name] for _, name in sorted(found)]


def _as_param(w):
    return {"kernel": np.asarray(w["kernel"], np.float32),
            "bias": np.asarray(w["bias"], np.float32)}


def infer_generator_config(
    params, n_cond_channels: int = 1, nhours: int = 24,
    compute_dtype: str = "float32",
) -> ModelConfig:
    """Reconstruct the ModelConfig from a generator tree (JAX/Keras layout).

    `compute_dtype` defaults to float32: weight-file inference serves the
    reference-parity load path (the reference predicts in implicit f32).

    The architecture is fully determined by the weight shapes given the
    conditioning-channel count: base channels = conv0's Cin, stage widths =
    conv biases, and ndomain/latent_dim fall out of the dense kernel
    (out = base * (nhours/8) * (nd/8)^2, in = latent_dim + nd^2 * C).

    CAUTION: the conditioning-channel count itself is NOT inferable — the
    dense in-dim only constrains latent_dim + nd^2*C, so doy/lon weights
    loaded with the default n_cond_channels=1 produce a structurally valid
    but semantically wrong config (extra channels absorbed into latent_dim).
    Pass the variant's channel count explicitly for non-base conditioning."""
    p = _unwrap(params)
    stages = sorted((k for k in p if re.fullmatch(r"conv\d+", k)),
                    key=lambda s: int(s[4:]))
    gen_channels = tuple(int(np.asarray(p[c]["bias"]).shape[0])
                         for c in stages)
    base = int(np.asarray(p["conv0"]["kernel"]).shape[-2])
    in_dim, out_dim = (int(s) for s in np.asarray(
        p["latent_proj"]["kernel"]).shape)
    gd = nhours // 8
    grid2 = out_dim // (base * gd)
    nd = 8 * int(round(grid2 ** 0.5))
    if base * gd * (nd // 8) ** 2 != out_dim:
        raise ValueError(f"cannot infer ndomain from dense out dim {out_dim}")
    latent_dim = in_dim - nd * nd * n_cond_channels
    if latent_dim <= 0:
        raise ValueError(
            f"dense in dim {in_dim} inconsistent with ndomain {nd} and "
            f"{n_cond_channels} conditioning channels")
    default_latent = ModelConfig.__dataclass_fields__["latent_dim"].default
    if latent_dim != default_latent:
        warnings.warn(
            f"inferred latent_dim={latent_dim} differs from the default "
            f"{default_latent}: if these are doy/lon-variant weights, their "
            f"extra conditioning channels have been absorbed into latent_dim "
            f"— pass the variant's n_cond_channels explicitly "
            f"(got n_cond_channels={n_cond_channels})",
            stacklevel=2,
        )
    return ModelConfig(
        ndomain=nd, nhours=nhours, latent_dim=latent_dim,
        n_cond_channels=n_cond_channels, gen_channels=gen_channels,
        base_channels=base, compute_dtype=compute_dtype,
    )


def load_keras_generator_h5(path: str, cfg: Optional[ModelConfig] = None,
                            n_cond_channels: int = 1):
    """Reference generator .h5 -> generator tree ``{"params": {...}}``.

    With cfg=None the architecture is inferred from the stored shapes."""
    layers = _collect_keras_layers(path)
    dense = _sorted_by_kind(layers, "dense")
    convs = _sorted_by_kind(layers, "conv3d")
    n_stages = len(convs) - 1 if cfg is None else len(cfg.gen_channels)
    if len(dense) != 1 or len(convs) != n_stages + 1:
        raise ValueError(
            f"unexpected generator layout in {path}: "
            f"{len(dense)} dense, {len(convs)} conv3d layers"
        )
    params = {"latent_proj": _as_param(dense[0])}
    for i in range(n_stages):
        params[f"conv{i}"] = _as_param(convs[i])
    params["head"] = _as_param(convs[-1])
    if cfg is None:
        cfg = infer_generator_config(params, n_cond_channels)
    _check_generator_shapes(params, cfg, path)
    return {"params": params}


def _check_generator_shapes(params, cfg: ModelConfig, path: str) -> None:
    gd, gh, gw = cfg.latent_grid
    want_in = cfg.latent_dim + cfg.ndomain * cfg.ndomain * cfg.n_cond_channels
    want_out = cfg.base_channels * gd * gh * gw
    got = params["latent_proj"]["kernel"].shape
    if got != (want_in, want_out):
        raise ValueError(
            f"{path}: dense kernel {got} does not match config "
            f"({want_in}, {want_out}) — wrong ndomain/conditioning?"
        )
