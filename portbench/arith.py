"""The yardstick's arithmetic: the H100's peaks, the least time a piece of
work could take, K1's operations and bytes, and the model's FLOP count.

Frozen here so that no change to the program can move the yardstick.  The
peaks, :func:`bound_ms` and K1's formulas are copied from ``chip_smoke.py``
(``PEAK_*``, ``_bound``, the ``[kernel]`` rows' FLOPs and bytes and
``_k1_backward``'s bytes).  The model FLOP count follows one rule for every
layer, written out in ``PERF.md`` (section 2): forward FLOPs are 2 x the
multiply-adds; K1's upsample-convs count the phase-folded 8 taps a phase
(64 multiply-adds an input position); every other conv and dense layer its
dense taps; pixel-norm, softmax and element-wise work are not counted; a
backward counts 1x its forward for input gradients and 1x for weight
gradients.  Nothing here imports torch or the program.
"""

from __future__ import annotations

import math

# published dense peaks of one H100 SXM at its 700 W limit
PEAK_F32_FLOPS = 67e12      # float32 FMA, outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # TF32 tensor cores (3xTF32 is f32-accurate)
PEAK_BF16_FLOPS = 989e12    # bf16 tensor cores
PEAK_BYTES = 3.35e12        # HBM3


def peak_flops(dtype: str) -> float:
    """The peak an MFU is read against: bf16's tensor cores for bf16 work;
    for float32 the faster of the two routes that keep f32's accuracy,
    3xTF32 (3 TF32 products a product) on the tensor cores, 165 TFLOP/s,
    above the exact FMA's 67, so that neither route can read above 1."""
    if dtype == "float32":
        return max(PEAK_F32_FLOPS, PEAK_TF32_FLOPS / 3)
    return PEAK_BF16_FLOPS


def bound_ms(flops: float, nbytes: float, dtype: str) -> float:
    """The least milliseconds the card could take for `flops` operations on
    `nbytes` bytes: the larger of FLOPs over the type's peak and bytes over
    HBM's rate.  float32 work is held to the faster of exact FMA and 3xTF32
    (``chip_smoke.py`` ``_bound``)."""
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    if dtype != "float32" or not flops:
        return max(1e3 * flops / PEAK_BF16_FLOPS, bytes_ms)
    ops_ms = min(1e3 * flops / PEAK_F32_FLOPS, 3e3 * flops / PEAK_TF32_FLOPS)
    return max(ops_ms, bytes_ms)


def elem_bytes(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2}[dtype]


def k1_forward_flops(b, d, h, w, cin, cout) -> float:
    """Nearest-upsample x2 + Conv3D(3^3) of a (b, d, h, w, cin) input, as 8
    phase convolutions of 8 folded taps on the low-resolution grid."""
    return 2.0 * 64 * b * d * h * w * cin * cout


def k1_forward_bytes(b, d, h, w, cin, cout, dtype: str) -> float:
    """Each byte once: the input, the 8 phases' folded weights, the float32
    bias and the 8x output."""
    es = elem_bytes(dtype)
    return (b * d * h * w * cin * es + 64 * cin * cout * es + 4 * cout
            + 8 * b * d * h * w * cout * es)


def k1_backward_flops(b, d, h, w, cin, cout) -> float:
    """dx and dkernel: twice the forward's."""
    return 2 * k1_forward_flops(b, d, h, w, cin, cout)


def k1_backward_bytes(b, d, h, w, cin, cout, dtype: str) -> float:
    """x read and dx written, the 8x cotangent, and the float32 3^3 kernel
    read and its gradient written."""
    es = elem_bytes(dtype)
    x = b * d * h * w * cin
    return es * (2 * x + 8 * b * d * h * w * cout) + 2 * 4 * 27 * cin * cout


def generator_stages(model: dict) -> list:
    """(d, h, w, cin, cout) of the generator's upsample-conv stages, each
    the input grid and widths of one K1 call."""
    nd, nh = model["ndomain"], model["nhours"]
    d, h = nh // 8, nd // 8
    cin, out = model["base_channels"], []
    for cout in model["gen_channels"]:
        out.append((d, h, h, cin, cout))
        d, h, cin = 2 * d, 2 * h, cout
    return out


def critic_stage_dims(model: dict) -> list:
    """(hours, y, x) after each critic stage: stage 0 VALID, the rest SAME,
    all at stride 2."""
    dims = (model["nhours"], model["ndomain"], model["ndomain"])
    out = []
    for i in range(len(model["critic_channels"])):
        dims = tuple((n - 3) // 2 + 1 if i == 0 else -(-n // 2) for n in dims)
        out.append(dims)
    return out


def generator_flops(model: dict) -> float:
    """One sample's generator forward: the latent projection, the three K1
    stages (phase-folded) and the 3^3 head at its dense taps."""
    nd, nh = model["ndomain"], model["nhours"]
    g = (nh // 8) * (nd // 8) ** 2
    k_in = model["latent_dim"] + nd * nd * model["n_cond_channels"]
    macs = k_in * model["base_channels"] * g
    for d, h, w, cin, cout in generator_stages(model):
        macs += 64 * d * h * w * cin * cout
    macs += 27 * model["gen_channels"][-1] * 1 * nh * nd * nd
    return 2.0 * macs


def critic_flops(model: dict) -> float:
    """One sample's critic forward: four stride-2 3^3 convs at their dense
    taps (pad-only taps included) and the dense score."""
    cin = 1 + model["n_cond_channels"]
    macs = 0
    for dims, cout in zip(critic_stage_dims(model), model["critic_channels"]):
        macs += math.prod(dims) * 27 * cin * cout
        cin = cout
    macs += math.prod(critic_stage_dims(model)[-1]) * cin
    return 2.0 * macs


def step_terms(n_disc: int) -> dict:
    """A fused train step's work in forwards of one B-sample batch, by
    term: generator forwards ``gen`` and critic forwards ``critic``.

    Each critic update: the 2B real+fake forward (2) and its backward (2 x
    2); the penalty's forward at B (1), its input gradient (1) and the
    second-order backward of that two-pass graph (2 x 2).  The generator
    update: its forward (1) and backward (2), the critic's forward (1) and
    its input gradient back to the fakes (1).  The held-over fakes: n_disc
    generator forwards at B, without gradient."""
    per_critic_update = 2 + 4 + 1 + 1 + 4
    return {"gen": n_disc + 3, "critic": n_disc * per_critic_update + 2}


def step_flops(model: dict, batch: int, n_disc: int) -> float:
    t = step_terms(n_disc)
    return batch * (t["gen"] * generator_flops(model)
                    + t["critic"] * critic_flops(model))


def request_flops(model: dict, n_scenarios: int) -> float:
    return n_scenarios * generator_flops(model)


def chunks(n: int, max_batch: int) -> list:
    """The forward batches a request of n scenarios runs as, at most
    `max_batch` each."""
    return [min(max_batch, n - i) for i in range(0, n, max_batch)]


def k1_serve_cases(model: dict, n_scenarios: int, max_batch: int,
                   dtype: str) -> list:
    """K1's calls in one served request: every stage at every chunk."""
    return [("forward", dtype, (b, *s)) for b in chunks(n_scenarios, max_batch)
            for s in generator_stages(model)]


def k1_train_cases(model: dict, batch: int, n_disc: int, dtype: str) -> list:
    """K1's calls in one fused step: the held-over forward at n_disc*B
    (no gradient), the generator update's forward at B and its backward."""
    stages = generator_stages(model)
    return ([("forward", dtype, (n_disc * batch, *s)) for s in stages]
            + [("forward", dtype, (batch, *s)) for s in stages]
            + [("backward", dtype, (batch, *s)) for s in stages])


def k1_case_bound_ms(case) -> float:
    kind, dtype, shape = case
    if kind == "forward":
        return bound_ms(k1_forward_flops(*shape),
                        k1_forward_bytes(*shape, dtype), dtype)
    return bound_ms(k1_backward_flops(*shape),
                    k1_backward_bytes(*shape, dtype), dtype)
