"""The plain reference: the paper's generator, critic and WGAN-GP step in
plain PyTorch, float32 with TF32 off, written from the published layer
equations (Scher & Pessenteiner, HESS 25, 2021; the reference's
``gan_train_cwgangp_pixelnorm.py:143-174,249-408``).  It imports nothing of
the program and runs on whatever weights, data and random stream the
benchmark hands it.

Layout is channels-last (B, hours, y, x, C) and the weights are the Keras
layout of the paper's code: dense kernels (in, out), conv kernels (3, 3, 3,
Cin, Cout).

* Generator: [latent, flatten(cond)] -> dense -> LeakyReLU(0.2) -> reshape
  (nhours/8, nd/8, nd/8, base) -> three [UpSampling3D(2) -> Conv3D(3^3,
  SAME) -> PixelNorm -> LeakyReLU] stages -> Conv3D(3^3, SAME) to one
  channel -> softmax over the hour axis.
* Critic: [sample, cond broadcast over hours] -> four stride-2 Conv3D(3^3)
  (VALID, then SAME with JAX/Keras' low = total // 2 pads) with LeakyReLU
  and dropout keep masks -> flatten (B, D, H, W, C) -> dense score.
* Step: n_disc critic updates on the held-over fakes, each the 2B
  real+fake call and the gradient penalty's call, then one generator
  update; Adam(lr, beta1, beta2, eps 1e-8).  The draws follow the order in
  which the program's step draws from its random stream
  (``prdisagg_torch/train/wgan_gp.py`` ``draw_step_inputs``), so that a
  generator seeded alike hands both the same rows, latents, eps and masks.

`prec` selects how the operands of every dense and conv layer are rounded
before an f32 product: "f32" (none), "tf32" (10 mantissa bits, round to
nearest even, as the TF32 tensor cores read f32) or "fp8" (the operands in
e4m3 and the gradients handed back through each product in e5m2, each
tensor under one scale, as fp8 training does; the rounding's own
gradient is the identity).  The last two are the
controls: the reference one precision below the configuration's.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

LEAK = 0.2


@contextlib.contextmanager
def strict_f32():
    """TF32 off for cuDNN and cuBLAS, and cuDNN's deterministic algorithms
    (its default ones sum in no fixed order, which alone moves a training
    step's readings: section 2 of PERF.md); the caller's settings restored."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             b.cudnn.deterministic)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    b.cudnn.deterministic = True
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
         b.cudnn.deterministic) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an 8-bit float `dtype` under one per-tensor scale that
    maps its largest magnitude to the type's largest finite value `top`."""
    amax = x.detach().abs().max()
    s = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / s).to(dtype).to(torch.float32) * s


class _E4m3(torch.autograd.Function):
    """Operands in fp8 e4m3; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _E5m2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradE5m2(torch.autograd.Function):
    """The identity, whose backward hands the product's gradient on in fp8
    e5m2, so that the backward's products read fp8 operands too."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _E5m2.apply(g)


def quant(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return x
    if prec == "tf32":
        return round_tf32(x)
    if prec == "fp8":
        return _E4m3.apply(x)
    raise ValueError(f"unknown precision {prec!r}")


def product(y: torch.Tensor, prec: str) -> torch.Tensor:
    """A product's output: in fp8, its gradient is rounded to e5m2."""
    return _GradE5m2.apply(y) if prec == "fp8" else y


def dense(x, kernel, bias, prec):
    return product(quant(x, prec) @ quant(kernel, prec), prec) + bias


def conv3d(x, kernel, bias, prec, stride=1, padding=0):
    """x NCDHW, kernel (3, 3, 3, Cin, Cout)."""
    w = quant(kernel, prec).permute(4, 3, 0, 1, 2)
    y = F.conv3d(quant(x, prec), w, None, stride=stride, padding=padding)
    return product(y, prec) + bias[:, None, None, None]


def upsample2(x):
    """Nearest x2 of the (hours, y, x) volume of (B, D, H, W, C)."""
    return (x.repeat_interleave(2, 1).repeat_interleave(2, 2)
            .repeat_interleave(2, 3))


def pixel_norm(x, eps=1e-8):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def generator(w: dict, model: dict, latent, cond, prec="f32"):
    """Fractions (B, nhours, nd, nd, 1), softmax over hours."""
    b = latent.shape[0]
    nd, nh = model["ndomain"], model["nhours"]
    x = torch.cat([latent, cond.reshape(b, -1)], dim=-1)
    x = F.leaky_relu(dense(x, w["gen.proj.kernel"], w["gen.proj.bias"], prec),
                     LEAK)
    x = x.reshape(b, nh // 8, nd // 8, nd // 8, model["base_channels"])
    for i in range(len(model["gen_channels"])):
        y = conv3d(upsample2(x).permute(0, 4, 1, 2, 3),
                   w[f"gen.conv{i}.kernel"], w[f"gen.conv{i}.bias"], prec,
                   padding=1)
        x = F.leaky_relu(pixel_norm(y.permute(0, 2, 3, 4, 1)), LEAK)
    y = conv3d(x.permute(0, 4, 1, 2, 3), w["gen.head.kernel"],
               w["gen.head.bias"], prec, padding=1)
    return torch.softmax(y.permute(0, 2, 3, 4, 1), dim=1)


def _same_pads(n: int):
    out = -(-n // 2)
    total = max((out - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def critic_stage_dims(model: dict) -> list:
    dims = (model["nhours"], model["ndomain"], model["ndomain"])
    out = []
    for i in range(len(model["critic_channels"])):
        dims = tuple((n - 3) // 2 + 1 if i == 0 else -(-n // 2) for n in dims)
        out.append(dims)
    return out


def critic(w: dict, model: dict, sample, cond, masks=None, prec="f32"):
    """Scores (B, 1).  masks: None, or a keep mask (B, C, D, H, W) a stage;
    kept activations are divided by the keep rate."""
    b, nh = sample.shape[0], model["nhours"]
    keep = 1.0 - model["dropout_rate"]
    cond_b = cond[:, None].expand(b, nh, *cond.shape[1:])
    x = torch.cat([sample, cond_b], dim=-1).permute(0, 4, 1, 2, 3)
    dims = (nh, model["ndomain"], model["ndomain"])
    for i in range(len(model["critic_channels"])):
        if i > 0:
            x = F.pad(x, [p for n in reversed(dims) for p in _same_pads(n)])
        x = conv3d(x, w[f"critic.conv{i}.kernel"], w[f"critic.conv{i}.bias"],
                   prec, stride=2)
        dims = tuple(x.shape[2:])
        x = F.leaky_relu(x, LEAK)
        if masks is not None:
            x = torch.where(masks[i], x / keep, 0.0)
    x = x.permute(0, 2, 3, 4, 1).reshape(b, -1)
    return dense(x, w["critic.score.kernel"], w["critic.score.bias"], prec)


def leaf_shapes(model: dict) -> dict:
    """Every weight's name and shape, generator then critic."""
    nd, nh = model["ndomain"], model["nhours"]
    k_in = model["latent_dim"] + nd * nd * model["n_cond_channels"]
    base = model["base_channels"]
    s = {"gen.proj.kernel": (k_in, base * (nh // 8) * (nd // 8) ** 2)}
    s["gen.proj.bias"] = (s["gen.proj.kernel"][1],)
    cin = base
    for i, ch in enumerate(model["gen_channels"]):
        s[f"gen.conv{i}.kernel"] = (3, 3, 3, cin, ch)
        s[f"gen.conv{i}.bias"] = (ch,)
        cin = ch
    s["gen.head.kernel"] = (3, 3, 3, cin, 1)
    s["gen.head.bias"] = (1,)
    cin = 1 + model["n_cond_channels"]
    for i, ch in enumerate(model["critic_channels"]):
        s[f"critic.conv{i}.kernel"] = (3, 3, 3, cin, ch)
        s[f"critic.conv{i}.bias"] = (ch,)
        cin = ch
    flat = math.prod(critic_stage_dims(model)[-1]) * cin
    s["critic.score.kernel"] = (flat, 1)
    s["critic.score.bias"] = (1,)
    return s


def make_weights(model: dict, seed: int, device) -> dict:
    """Every weight from `seed` on `device`, in two draws: the generator's
    leaves, biases too, N(0, init_stddev) (the paper's RandomNormal; its
    biases start at 0, here they are drawn so that the bias paths carry
    data); the critic's kernels Glorot-uniform (Keras' default) and its
    biases N(0, init_stddev)."""
    shapes = leaf_shapes(model)
    gen = torch.Generator(device=device).manual_seed(seed)
    names = list(shapes)
    g_names = [n for n in names if n.startswith("gen.")]
    c_names = [n for n in names if n.startswith("critic.")]
    sizes = [math.prod(shapes[n]) for n in g_names]
    flat = model["init_stddev"] * torch.randn(sum(sizes), generator=gen,
                                              device=device)
    out = {n: t.view(shapes[n]) for n, t in zip(g_names, flat.split(sizes))}
    sizes = [math.prod(shapes[n]) for n in c_names]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    for n, t in zip(c_names, flat.split(sizes)):
        s = shapes[n]
        if n.endswith("kernel"):
            fan_in, fan_out = math.prod(s[:-1]), math.prod(s[:-2]) * s[-1]
            if len(s) == 2:
                fan_in, fan_out = s
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            out[n] = ((2 * t - 1) * limit).view(s)
        else:
            out[n] = ((2 * t - 1) * model["init_stddev"]).view(s)
    return out


# -- the training step --------------------------------------------------------

def draw_masks(model: dict, batch: int, g: torch.Generator, device):
    rate = model["dropout_rate"]
    if rate == 0.0:
        return None
    return [torch.rand((batch, ch, *dims), generator=g, device=device) >= rate
            for ch, dims in zip(model["critic_channels"],
                                critic_stage_dims(model))]


def draw_step(model: dict, rows: torch.Tensor, batch: int, n_disc: int,
              g: torch.Generator) -> dict:
    """One step's draws from `g`, in the program's order."""
    dev, b = rows.device, batch

    def draw_rows(n):
        return rows[torch.randint(0, rows.shape[0], (n,), generator=g,
                                  device=dev)]

    out = {"real_rows": draw_rows(n_disc * b),
           "latent": torch.randn((n_disc * b, model["latent_dim"]),
                                 generator=g, device=dev),
           "eps": torch.rand((n_disc, b), generator=g, device=dev)}
    out["masks"] = [draw_masks(model, 2 * b, g, dev) for _ in range(n_disc)]
    out["gp_masks"] = [draw_masks(model, b, g, dev) for _ in range(n_disc)]
    out["gen_latent"] = torch.randn((b, model["latent_dim"]), generator=g,
                                    device=dev)
    out["gen_rows"] = draw_rows(b)
    out["gen_masks"] = draw_masks(model, b, g, dev)
    return out


def patches(data: torch.Tensor, rows: torch.Tensor, nd: int) -> torch.Tensor:
    """(B, nhours, nd, nd) windows of (days, nhours, ny, nx) at rows."""
    t, y, x = (rows[:, i].long() for i in range(3))
    r = torch.arange(nd, device=data.device)
    yy = (y[:, None] + r)[:, :, None]
    xx = (x[:, None] + r)[:, None, :]
    return data[t[:, None, None], :, yy, xx].permute(0, 3, 1, 2)


def real_and_cond(data, rows, data_cfg):
    """(fractions (B, nh, nd, nd, 1), daily sum / norm_scale (B, nd, nd, 1))
    of the patches at rows (reference ``generate_real_samples``)."""
    p = patches(data, rows, data_cfg["ndomain"])[..., None]
    s = p.sum(dim=1)
    frac = p / torch.clamp(s[:, None], min=data_cfg["frac_eps"])
    return frac, s / data_cfg["norm_scale"]


def critic_loss(w, model, frac_real, cond, fake, eps, masks, gp_masks,
                gp_weight, prec):
    b = frac_real.shape[0]
    scores = critic(w, model, torch.cat([frac_real, fake]),
                    torch.cat([cond, cond]), masks, prec)
    e = eps.reshape(b, 1, 1, 1, 1)
    interp = (e * frac_real + (1 - e) * fake).requires_grad_(True)
    (g,) = torch.autograd.grad(critic(w, model, interp, cond, gp_masks,
                                      prec).sum(), interp, create_graph=True)
    norm = torch.sqrt(g.reshape(b, -1).square().sum(dim=1) + 1e-12)
    gp = (norm - 1).square().mean()
    return (-scores[:b]).mean() + scores[b:].mean() + gp_weight * gp


class Trainer:
    """The reference's training run on given weights, data and rows, its
    draws from a generator seeded with `draw_seed` on the data's device."""

    def __init__(self, weights: dict, model: dict, data_cfg: dict,
                 train: dict, data: torch.Tensor, rows, draw_seed: int,
                 prec: str = "f32", moments=None):
        """`moments`: None (Adam starts cold) or (step, {leaf: v}), Adam's
        step count and a second moment for every element of each leaf."""
        self.model, self.data_cfg, self.train = model, data_cfg, train
        self.data, self.prec = data, prec
        self.rows = torch.as_tensor(rows, dtype=torch.int32,
                                    device=data.device)
        self.w = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights.items()}
        self.gen_names = [k for k in self.w if k.startswith("gen.")]
        self.critic_names = [k for k in self.w if k.startswith("critic.")]
        self.rng = torch.Generator(device=data.device).manual_seed(draw_seed)

        def adam(names):
            return torch.optim.Adam(
                [self.w[k] for k in names], lr=train["learning_rate"],
                betas=(train["beta1"], train["beta2"]),
                eps=train["adam_eps"])

        self.gen_opt = adam(self.gen_names)
        self.critic_opt = adam(self.critic_names)
        if moments is not None:
            t, v = moments
            for opt, names in ((self.gen_opt, self.gen_names),
                               (self.critic_opt, self.critic_names)):
                for k in names:
                    p = self.w[k]
                    opt.state[p] = {
                        "step": torch.tensor(float(t)),
                        "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": torch.full_like(p, v[k])}

    def exp_avg(self) -> dict:
        """Adam's first moment of every leaf: with beta1 = 0 the last
        gradient each optimizer applied."""
        out = {}
        for opt, names in ((self.gen_opt, self.gen_names),
                           (self.critic_opt, self.critic_names)):
            for k in names:
                out[k] = opt.state[self.w[k]]["exp_avg"].detach()
        return out

    def _apply(self, opt, names, grads):
        for k, g in zip(names, grads):
            self.w[k].grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def mean_square_gradients(self) -> dict:
        """{leaf: mean square of its gradient} of the first critic update's
        loss and of the generator update's, at the current weights, on one
        step's draws; nothing is applied."""
        model, tr, prec = self.model, self.train, self.prec
        b = tr["batch_size"]
        d = draw_step(model, self.rows, b, 1, self.rng)
        with strict_f32():
            frac, cond = real_and_cond(self.data, d["real_rows"],
                                       self.data_cfg)
            with torch.no_grad():
                fake = generator(self.w, model, d["latent"], cond, prec)
            loss = critic_loss(self.w, model, frac, cond, fake, d["eps"][0],
                               d["masks"][0], d["gp_masks"][0],
                               tr["gp_weight"], prec)
            out = dict(zip(self.critic_names, torch.autograd.grad(
                loss, [self.w[k] for k in self.critic_names])))
            _, cond_g = real_and_cond(self.data, d["gen_rows"], self.data_cfg)
            fake_g = generator(self.w, model, d["gen_latent"], cond_g, prec)
            g_loss = (-critic(self.w, model, fake_g, cond_g, d["gen_masks"],
                              prec)).mean()
            out.update(zip(self.gen_names, torch.autograd.grad(
                g_loss, [self.w[k] for k in self.gen_names])))
        return {k: g.square().mean().item() for k, g in out.items()}

    def step(self) -> None:
        """One fused step."""
        model, tr, prec = self.model, self.train, self.prec
        n_disc, b = tr["n_disc"], tr["batch_size"]
        d = draw_step(model, self.rows, b, n_disc, self.rng)
        with strict_f32():
            frac, cond = real_and_cond(self.data, d["real_rows"],
                                       self.data_cfg)
            with torch.no_grad():
                fake = generator(self.w, model, d["latent"], cond, prec)
            shape = (n_disc, b)
            frac = frac.reshape(*shape, *frac.shape[1:])
            cond = cond.reshape(*shape, *cond.shape[1:])
            fake = fake.reshape(*shape, *fake.shape[1:])
            c_params = [self.w[k] for k in self.critic_names]
            for i in range(n_disc):
                loss = critic_loss(
                    self.w, model, frac[i], cond[i], fake[i], d["eps"][i],
                    d["masks"][i], d["gp_masks"][i], tr["gp_weight"], prec)
                grads = torch.autograd.grad(loss, c_params)
                self._apply(self.critic_opt, self.critic_names, grads)
            _, cond_g = real_and_cond(self.data, d["gen_rows"], self.data_cfg)
            fake_g = generator(self.w, model, d["gen_latent"], cond_g, prec)
            g_loss = (-critic(self.w, model, fake_g, cond_g, d["gen_masks"],
                              prec)).mean()
            g_params = [self.w[k] for k in self.gen_names]
            g_grads = torch.autograd.grad(g_loss, g_params)
            self._apply(self.gen_opt, self.gen_names, g_grads)


def serve_fractions(w: dict, model: dict, latent, cond, block: int,
                    prec: str = "f32") -> torch.Tensor:
    """The generator's fractions (B, nhours, nd, nd) of B latents on one
    condition (nd, nd, C), in blocks of `block` rows."""
    out = []
    with torch.no_grad(), strict_f32():
        for i in range(0, latent.shape[0], block):
            lat = latent[i:i + block]
            c = cond[None].expand(lat.shape[0], *cond.shape)
            out.append(generator(w, model, lat, c, prec)[..., 0])
    return torch.cat(out)
