"""prdisagg_torch — the PyTorch/CUDA port of prdisagg_tpu.

Stochastic temporal disaggregation of precipitation with a conditional
WGAN-GP generator, running on an NVIDIA Hopper GPU.  Module names follow
the JAX package so each counterpart is easy to find:

core       model configuration
ops        generator ops; ops/upsample_conv.py holds the folded
           upsample-conv with its hand-written CUDA kernel (csrc/)
models     Generator and the weight import (.npz / Keras .h5)
api        PretrainedGenerator (generate_scenarios) and the serving daemon
utils      heartbeat for supervised daemons

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; kernels are built by nvcc at first use (_build.py).
"""

__version__ = "0.1.0"
