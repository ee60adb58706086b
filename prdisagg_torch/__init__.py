"""prdisagg_torch — the PyTorch/CUDA port of prdisagg_tpu.

Stochastic temporal disaggregation of precipitation with a conditional
WGAN-GP generator, running on an NVIDIA Hopper GPU.  Module names follow
the JAX package so each counterpart is easy to find:

core       data, model and training configuration
data       the card-resident dataset and its sampler
ops        generator ops; ops/upsample_conv.py holds the folded
           upsample-conv and ops/gather.py the patch gather, each with its
           hand-written CUDA kernel (csrc/)
models     Generator, Critic and the weight files (.npz / Keras .h5)
train      the train step (a CUDA graph on the card), Trainer, checkpoints
           and the background artifact writer
api        PretrainedGenerator (generate_scenarios) and the serving daemon
eval       CRPS, LSD, the evaluation battery and the parity report
baselines  RainFARM, the non-ML baseline (calibration, downscaling, CRPS)
utils      plots, TensorBoard and the heartbeat
cli        ``python -m prdisagg_torch.cli <subcommand>``

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; kernels are built by nvcc at first use (_build.py).
"""

__version__ = "0.1.0"
