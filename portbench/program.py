"""The binding to the system under test, ``prdisagg_torch``: its
configuration objects from a configuration file, and the benchmark's
weights in the program's parameter names and layouts.  The only module of
the yardstick, with the drivers, that imports the program.
"""

from __future__ import annotations

import gc
import subprocess

import torch


def model_config(model: dict, compute_dtype: str):
    from prdisagg_torch.core.config import ModelConfig

    return ModelConfig(
        ndomain=model["ndomain"], nhours=model["nhours"],
        latent_dim=model["latent_dim"],
        n_cond_channels=model["n_cond_channels"],
        gen_channels=tuple(model["gen_channels"]),
        base_channels=model["base_channels"],
        critic_channels=tuple(model["critic_channels"]),
        leak=model["leak"], dropout_rate=model["dropout_rate"],
        init_stddev=model["init_stddev"], compute_dtype=compute_dtype)


def data_config(data: dict):
    from prdisagg_torch.core.config import DataConfig

    return DataConfig(ndomain=data["ndomain"], stride=data["stride"],
                      tp_thresh_daily=data["tp_thresh_daily"],
                      n_thresh=data["n_thresh"],
                      norm_scale=data["norm_scale"],
                      frac_eps=data["frac_eps"])


def train_config(train: dict):
    from prdisagg_torch.core.config import TrainConfig

    return TrainConfig(n_disc=train["n_disc"], gp_weight=train["gp_weight"],
                       learning_rate=train["learning_rate"],
                       beta1=train["beta1"], beta2=train["beta2"])


def generator_state(w: dict) -> dict:
    """The generator's leaves of `w` (Keras layout) as a ``Generator``
    state_dict, copied."""
    n = sum(1 for k in w if k.startswith("gen.conv") and k.endswith("kernel"))
    sd = {"latent_proj.weight": w["gen.proj.kernel"].t(),
          "latent_proj.bias": w["gen.proj.bias"],
          "head.weight": w["gen.head.kernel"].permute(4, 3, 0, 1, 2),
          "head.bias": w["gen.head.bias"]}
    for i in range(n):
        sd[f"conv{i}.weight"] = w[f"gen.conv{i}.kernel"]
        sd[f"conv{i}.bias"] = w[f"gen.conv{i}.bias"]
    return {k: v.detach().contiguous().clone() for k, v in sd.items()}


def critic_state(w: dict) -> dict:
    n = sum(1 for k in w if k.startswith("critic.conv") and k.endswith("kernel"))
    sd = {"score.weight": w["critic.score.kernel"].t(),
          "score.bias": w["critic.score.bias"]}
    for i in range(n):
        sd[f"conv{i}.weight"] = w[f"critic.conv{i}.kernel"]
        sd[f"conv{i}.bias"] = w[f"critic.conv{i}.bias"]
    return {k: v.detach().contiguous().clone() for k, v in sd.items()}


#: program parameter name -> the benchmark's leaf name
GEN_NAMES = {"latent_proj.weight": "gen.proj.kernel",
             "latent_proj.bias": "gen.proj.bias",
             "head.weight": "gen.head.kernel", "head.bias": "gen.head.bias"}
CRITIC_NAMES = {"score.weight": "critic.score.kernel",
                "score.bias": "critic.score.bias"}


def leaf_name(net: str, name: str) -> str:
    table = GEN_NAMES if net == "gen" else CRITIC_NAMES
    if name in table:
        return table[name]
    conv, part = name.split(".")
    return f"{net}.{conv}.{'kernel' if part == 'weight' else 'bias'}"


def device_facts(device: str) -> dict:
    """The card's name, count, peak allocated bytes and power limit (the
    peak is the process's, read before the reference runs)."""
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(q.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return out


def free(device: str) -> None:
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
