"""Weight import and export: the JAX package's ``.npz`` and the reference's
Keras ``.h5``.

Both formats hold a net as a tree of ``{kernel, bias}`` numpy arrays in the
Flax/Keras layouts: Dense kernels (in, out), Conv3D kernels (kd, kh, kw, in,
out).  The generator's tree is ``{latent_proj, conv0.., head}``, the
critic's ``{conv0..conv3, score}``.  :func:`params_from_jax` and
:func:`critic_params_from_jax` turn a tree into the port's ``state_dict``;
:func:`params_to_jax` goes back, and :func:`save_params_npz` writes the JAX
package's ``params/<layer>/<kind>`` layout.  :func:`save_keras_generator_h5`
and :func:`save_keras_critic_h5` write the reference's ``.h5`` layout.

Keras layer mapping: dense -> latent_proj, conv3d/_1/_2 -> conv0..2,
conv3d_3 -> head; in the critic conv3d/_1/_2/_3 -> conv0..3, dense ->
score.  ``h5py`` is imported only by the functions that read or write .h5.
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


def _critic_score_in(ndomain: int, nhours: int, channels) -> int:
    """The critic's score input size: its last stage's extent times its
    last width."""
    from prdisagg_torch.models.critic import critic_stage_dims

    dims = critic_stage_dims(ModelConfig(ndomain=ndomain, nhours=nhours,
                                         critic_channels=tuple(channels)))
    return int(np.prod(dims[-1])) * channels[-1]


def infer_critic_config(params, nhours: int = 24,
                        ndomain: Optional[int] = None,
                        compute_dtype: str = "float32") -> ModelConfig:
    """Reconstruct the ModelConfig from a critic tree (JAX/Keras layout).

    The critic's weights pin the conditioning channels exactly (conv0's
    input is 1 + n_cond_channels) and the stage widths (the conv biases).
    The domain follows from the score's input size; the stride-2 stack maps
    several domains to one size, so a given `ndomain` is checked against
    the candidates, and otherwise 16 wins when it fits, else the largest."""
    p = _unwrap(params)
    stages = _conv_names(p)
    critic_channels = tuple(int(np.asarray(p[c]["bias"]).shape[0])
                            for c in stages)
    in_ch = int(np.asarray(p["conv0"]["kernel"]).shape[-2])
    n_cond_channels = in_ch - 1
    if n_cond_channels < 1:
        raise ValueError(f"conv0 input channels {in_ch} < 2")
    score_in = int(np.asarray(p["score"]["kernel"]).shape[0])
    candidates = [nd for nd in range(8, 1025, 8)
                  if _critic_score_in(nd, nhours, critic_channels) == score_in]
    if not candidates:
        raise ValueError(f"cannot infer ndomain: no multiple of 8 yields "
                         f"score in-dim {score_in} with channels "
                         f"{critic_channels}")
    if ndomain is not None:
        if ndomain not in candidates:
            raise ValueError(f"ndomain={ndomain} inconsistent with critic "
                             f"weights (score in-dim {score_in} allows "
                             f"{candidates})")
        nd = ndomain
    else:
        default_nd = ModelConfig.__dataclass_fields__["ndomain"].default
        nd = default_nd if default_nd in candidates else candidates[-1]
    return ModelConfig(ndomain=nd, nhours=nhours,
                       n_cond_channels=n_cond_channels,
                       critic_channels=critic_channels,
                       compute_dtype=compute_dtype)


def load_keras_critic_h5(path: str, cfg: Optional[ModelConfig] = None,
                         nhours: int = 24):
    """Reference critic .h5 -> critic tree ``{"params": {...}}``, its
    shapes checked against `cfg` or, with cfg None, against the config
    they imply (:func:`infer_critic_config`)."""
    layers = _collect_keras_layers(path)
    dense = _sorted_by_kind(layers, "dense")
    convs = _sorted_by_kind(layers, "conv3d")
    n_stages = len(convs) if cfg is None else len(cfg.critic_channels)
    if len(dense) != 1 or len(convs) != n_stages:
        raise ValueError(f"unexpected critic layout in {path}: "
                         f"{len(dense)} dense, {len(convs)} conv3d layers")
    params = {f"conv{i}": _as_param(convs[i]) for i in range(len(convs))}
    params["score"] = _as_param(dense[0])
    check_cfg = cfg if cfg is not None else infer_critic_config(
        params, nhours=nhours)
    _check_critic_shapes(params, check_cfg, path)
    return {"params": params}


def _check_critic_shapes(params, cfg: ModelConfig, path: str) -> None:
    got_in = int(np.asarray(params["conv0"]["kernel"]).shape[-2])
    want_in = 1 + cfg.n_cond_channels
    if got_in != want_in:
        raise ValueError(f"{path}: conv0 input channels {got_in} != "
                         f"{want_in} (1 sample + {cfg.n_cond_channels} "
                         f"conditioning)")
    want_score = _critic_score_in(cfg.ndomain, cfg.nhours,
                                  cfg.critic_channels)
    got_score = int(np.asarray(params["score"]["kernel"]).shape[0])
    if got_score != want_score:
        raise ValueError(f"{path}: score in-dim {got_score} does not match "
                         f"config ({want_score}) — wrong ndomain/channels?")


# ---------------------------------------------------------------------------
# Keras .h5 export
# ---------------------------------------------------------------------------
# The reference's file layout (TF 2.1 writing a functional model that wraps a
# Sequential): weights under model_weights/sequential/sequential/<layer>/
# <kernel|bias>:0, and a model_config attribute with the whole architecture.
# The critic's repeat_elements Lambda (gan_train_cwgangp_pixelnorm.py:
# 278-279) is written as the equivalent UpSampling3D(size=(nhours, 1, 1)),
# keeping the layer name "lambda" so the weight groups match the
# reference's files.

_KERAS_VERSION = b"2.2.4-tf"  # the keras version string TF 2.1.0 writes
_GEN_TOP_LAYERS = [b"input_1", b"input_2", b"flatten", b"concatenate",
                   b"sequential"]
_CRITIC_TOP_LAYERS = [b"input_1", b"reshape", b"lambda", b"input_2",
                      b"concatenate", b"sequential"]


def _layer(class_name: str, name: str, inbound=None, **config):
    config = {"name": name, "trainable": True, "dtype": "float32", **config}
    out = {"name": name, "class_name": class_name, "config": config}
    if inbound is not None:
        out["inbound_nodes"] = [[[src, 0, 0, {}] for src in inbound]]
    return out


def _input_layer(name: str, shape):
    return {"name": name, "class_name": "InputLayer",
            "config": {"batch_input_shape": [None, *shape],
                       "dtype": "float32", "sparse": False, "name": name},
            "inbound_nodes": []}


def _conv3d(name: str, filters: int, padding: str, strides=(1, 1, 1)):
    return {"class_name": "Conv3D", "config": {
        "name": name, "trainable": True, "dtype": "float32",
        "filters": filters, "kernel_size": [3, 3, 3],
        "strides": list(strides), "padding": padding,
        "data_format": "channels_last", "dilation_rate": [1, 1, 1],
        "activation": "linear", "use_bias": True}}


def _leaky(name: str, alpha: float):
    return {"class_name": "LeakyReLU", "config": {
        "name": name, "trainable": True, "dtype": "float32", "alpha": alpha}}


def _model_config_generator(cfg: ModelConfig) -> dict:
    """TF-2.1-style functional model config of the reference generator
    (gan_train_cwgangp_pixelnorm.py:312-357), parameterized by cfg."""
    gd, gh, gw = cfg.latent_grid
    n_nodes = cfg.base_channels * gd * gh * gw
    seq = [
        {"class_name": "Dense", "config": {
            "name": "dense", "trainable": True, "dtype": "float32",
            "units": n_nodes, "activation": "linear", "use_bias": True}},
        _leaky("leaky_re_lu", cfg.leak),
        {"class_name": "Reshape", "config": {
            "name": "reshape_seq", "trainable": True, "dtype": "float32",
            "target_shape": [gd, gh, gw, cfg.base_channels]}},
    ]
    for i, c in enumerate(cfg.gen_channels):
        sfx = "" if i == 0 else f"_{i}"
        seq += [
            {"class_name": "UpSampling3D", "config": {
                "name": f"up_sampling3d{sfx}", "trainable": True,
                "dtype": "float32", "size": [2, 2, 2],
                "data_format": "channels_last"}},
            _conv3d(f"conv3d{sfx}", c, "same"),
            {"class_name": "PixelNormalization", "config": {
                "name": f"pixel_normalization{sfx}", "trainable": True,
                "dtype": "float32"}},
            _leaky(f"leaky_re_lu_{i + 1}", cfg.leak),
        ]
    seq += [
        _conv3d(f"conv3d_{len(cfg.gen_channels)}", 1, "same"),
        {"class_name": "Softmax", "config": {
            "name": "softmax", "trainable": True, "dtype": "float32",
            "axis": 1}},
    ]
    nd, ncc = cfg.ndomain, cfg.n_cond_channels
    return {"class_name": "Model", "config": {
        "name": "model",
        "layers": [
            _input_layer("input_1", (cfg.latent_dim,)),
            _input_layer("input_2", (nd, nd, ncc)),
            _layer("Flatten", "flatten", inbound=["input_2"],
                   data_format="channels_last"),
            _layer("Concatenate", "concatenate",
                   inbound=["input_1", "flatten"], axis=-1),
            {"name": "sequential", "class_name": "Sequential",
             "config": {"name": "sequential", "layers": seq},
             "inbound_nodes": [[["concatenate", 0, 0, {}]]]},
        ],
        "input_layers": [["input_1", 0, 0], ["input_2", 0, 0]],
        "output_layers": [["sequential", 0, 0]],
    }}


def _model_config_critic(cfg: ModelConfig) -> dict:
    """TF-2.1-style functional model config of the reference critic
    (gan_train_cwgangp_pixelnorm.py:272-309)."""
    seq = []
    for i, c in enumerate(cfg.critic_channels):
        sfx = "" if i == 0 else f"_{i}"
        seq += [
            _conv3d(f"conv3d{sfx}", c, "valid" if i == 0 else "same",
                    strides=(2, 2, 2)),
            _leaky(f"leaky_re_lu{sfx}", cfg.leak),
            {"class_name": "Dropout", "config": {
                "name": f"dropout{sfx}", "trainable": True,
                "dtype": "float32", "rate": cfg.dropout_rate}},
        ]
    seq += [
        _layer("Flatten", "flatten_seq", data_format="channels_last"),
        {"class_name": "Dense", "config": {
            "name": "dense", "trainable": True, "dtype": "float32",
            "units": 1, "activation": "linear", "use_bias": True}},
    ]
    nd, nh, ncc = cfg.ndomain, cfg.nhours, cfg.n_cond_channels
    return {"class_name": "Model", "config": {
        "name": "model",
        "layers": [
            _input_layer("input_1", (nd, nd, ncc)),
            _layer("Reshape", "reshape", inbound=["input_1"],
                   target_shape=[1, nd, nd, ncc]),
            _layer("UpSampling3D", "lambda", inbound=["reshape"],
                   size=[nh, 1, 1], data_format="channels_last"),
            _input_layer("input_2", (nh, nd, nd, 1)),
            _layer("Concatenate", "concatenate",
                   inbound=["input_2", "lambda"], axis=-1),
            {"name": "sequential", "class_name": "Sequential",
             "config": {"name": "sequential", "layers": seq},
             "inbound_nodes": [[["concatenate", 0, 0, {}]]]},
        ],
        "input_layers": [["input_2", 0, 0], ["input_1", 0, 0]],
        "output_layers": [["sequential", 0, 0]],
    }}


def _keras_name_pairs_generator(cfg: ModelConfig):
    """[(tree name, Keras layer name), ...] in Keras creation order."""
    pairs = [("latent_proj", "dense")]
    for i in range(len(cfg.gen_channels)):
        pairs.append((f"conv{i}", "conv3d" if i == 0 else f"conv3d_{i}"))
    pairs.append(("head", f"conv3d_{len(cfg.gen_channels)}"))
    return pairs


def _keras_name_pairs_critic(cfg: ModelConfig):
    pairs = [(f"conv{i}", "conv3d" if i == 0 else f"conv3d_{i}")
             for i in range(len(cfg.critic_channels))]
    pairs.append(("score", "dense"))
    return pairs


def _write_keras_h5(path: str, params, pairs, top_layers,
                    model_config: dict) -> None:
    """Write a tree in the reference's .h5 layout; atomic (temp file and
    ``os.replace``), so an interrupted export leaves no half file."""
    import json

    import h5py

    params = _unwrap(params)
    tmp = f"{path}.tmp-{os.getpid()}"
    with h5py.File(tmp, "w") as f:
        f.attrs["keras_version"] = _KERAS_VERSION
        f.attrs["backend"] = b"tensorflow"
        f.attrs["model_config"] = json.dumps(model_config).encode()
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array(top_layers, dtype="S")
        mw.attrs["backend"] = b"tensorflow"
        mw.attrs["keras_version"] = _KERAS_VERSION
        for name in top_layers:
            g = mw.create_group(name.decode())
            if name != b"sequential":
                g.attrs["weight_names"] = np.array([], dtype="S1")
        seq = mw["sequential"]
        weight_names = []
        for tree_name, keras_name in pairs:
            for wname in ("kernel", "bias"):
                # nested-model paths carry the inner model's name, as TF's
                # writer does: model_weights/sequential/sequential/<layer>/..
                full = f"sequential/{keras_name}/{wname}:0"
                weight_names.append(full.encode())
                seq.create_dataset(full, data=np.asarray(
                    params[tree_name][wname], dtype=np.float32))
        seq.attrs["weight_names"] = np.array(weight_names, dtype="S")
    os.replace(tmp, path)


def save_keras_generator_h5(path: str, params, cfg: ModelConfig) -> None:
    """A generator tree (:func:`params_to_jax`) -> reference-layout Keras
    .h5 with the reference's layer names and a full ``model_config``; it
    loads back through :func:`load_keras_generator_h5` and the JAX
    package's ``PretrainedGenerator.from_keras_h5``."""
    _write_keras_h5(path, params, _keras_name_pairs_generator(cfg),
                    _GEN_TOP_LAYERS, _model_config_generator(cfg))


def save_keras_critic_h5(path: str, params, cfg: ModelConfig) -> None:
    """A critic tree -> reference-layout Keras .h5 (see
    :func:`save_keras_generator_h5`)."""
    _write_keras_h5(path, params, _keras_name_pairs_critic(cfg),
                    _CRITIC_TOP_LAYERS, _model_config_critic(cfg))
