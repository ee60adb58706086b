"""Inference API on a trained generator — the reference's importable surface
(raindisagg_gan_pretrained.py:52-90):

  generate_scenarios(cond, n_scenarios) : (nd, nd, 1) daily sums in mm
      -> (n_scenarios, 24, nd, nd) hourly mm scenarios whose per-gridpoint
      time-sum equals the input daily sum (softmax conservation).
  plot_scenarios(scenarios) : n x 24 map grid, LogNorm(0.01, 50), shared
      colorbar.

Semantics: condition divided by norm_scale=127.4 before the network,
latents ~ N(0,1), fractions rescaled by cond * norm_scale back to mm/h.

The forward runs on ``device`` ("cuda" by default) under
``torch.inference_mode()``; on a CUDA device the generator's three
upsample-conv stages run through the hand-written kernel
(ops/upsample_conv.py).  Asking for "cuda" without a card raises.  A
request's chunks are all queued before its response is copied out: the
host touches the returned array's pages while the card computes, and each
chunk leaves the card under the next chunk's forward, straight into
those pages.  The returned arrays are ordinary numpy arrays.

With a data-parallel ``mesh`` (parallel/mesh.py) every rank holds the same
weights and draws a request's full latents from the same seeded stream;
each forwards its contiguous shard of the batch and the shards are
all-gathered, so every rank returns the whole result.  The calls are then
collective: every rank makes them with the same arguments.
"""

from __future__ import annotations

import contextlib
import mmap
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from prdisagg_torch.core.config import ModelConfig
from prdisagg_torch.core.device import resolve_device
from prdisagg_torch.models.generator import Generator
from prdisagg_torch.models.io import (
    infer_generator_config,
    load_keras_generator_h5,
    load_params_npz,
    params_from_jax,
    params_to_jax,
    save_params_npz,
)
from prdisagg_torch.parallel.mesh import (
    all_gather_batch,
    batch_shard,
    replicate,
)
from prdisagg_torch.utils.profiling import span

NORM_SCALE = 127.4

#: Default per-forward batch cap at 16x16.  chip_smoke.py measures the peak
#: device memory of a float32 generate_scenarios call at 4.72 MB per
#: scenario on an 80 GB H100 (PERF.md): 8192 scenarios take 38.7 GB, which
#: leaves half the card as headroom.
MAX_BATCH_16 = 8192


def default_max_batch(ndomain: int) -> int:
    """:data:`MAX_BATCH_16` scaled by the domain's activation footprint
    (~ndomain^2), at least 32."""
    return max(32, int(MAX_BATCH_16 * (16 / ndomain) ** 2))


def _touch_pages(a: np.ndarray) -> None:
    """Write a zero byte into every memory page of the C-contiguous array
    `a`, so that a fresh allocation takes its page faults here rather than
    inside the copy that fills it."""
    b = a.reshape(-1).view(np.uint8)
    b[::mmap.PAGESIZE] = 0
    b[-1:] = 0


def _bucket(n: int) -> int:
    """Smallest b >= n with b in {2^k, 1.5*2^k}: bounds the set of fused
    batch shapes; padding stays under 50% (worst case is just above a power
    of two: 2^k + 1 -> 1.5 * 2^k)."""
    p = 1
    while p < n:
        p <<= 1
    if p > 1 and 3 * p // 4 >= n:
        return 3 * p // 4
    return p


class PretrainedGenerator:
    """A trained generator on one device, loadable from the JAX package's
    ``.npz`` or the reference's Keras ``.h5`` checkpoints."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 cfg: Optional[ModelConfig] = None,
                 norm_scale: float = NORM_SCALE, seed: int = 0,
                 max_batch: Optional[int] = None, device="cuda",
                 wire_dtype: Optional[str] = None, mesh=None):
        """`params` is a ``Generator`` state_dict (models/io.py
        ``params_from_jax`` makes one from a JAX/Keras tree).

        `max_batch` caps the per-forward batch: larger requests are served
        in chunks.  The default scales :data:`MAX_BATCH_16` with the
        domain's activation footprint (~ndomain^2); bfloat16 activations
        take less memory than the float32 ones it was measured on.

        Precision: inference defaults to float32 — the reference's predict
        path is implicit f32 and published weights expect it.  Pass a cfg
        with compute_dtype="bfloat16" for throughput-first serving.

        `wire_dtype="float16"` casts the output fractions to float16 on the
        device before the device->host copy, which halves its bytes; the mm
        rescale then runs on the host in float32.  Fractions lie in [0, 1],
        where float16's relative step of about 1e-3 costs about 5e-4
        relative conservation error.  None or "float32" keeps the exact
        float32 path.

        `mesh` turns on data-parallel serving on the mesh's device (of
        `device`'s type): the weights are broadcast from rank 0, every
        forward is split over the ranks (zero-padded to a multiple of the
        mesh size), and `max_batch` rounds down to such a multiple.
        Per-sample output is the single-device output."""
        # checked before any device work
        if wire_dtype not in (None, "float32", "float16"):
            raise ValueError(f"wire_dtype must be None/'float32'/'float16', "
                             f"got {wire_dtype!r}")
        self.wire_dtype = None if wire_dtype == "float32" else wire_dtype
        self.cfg = cfg or ModelConfig(compute_dtype="float32")
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh computes on {mesh.device}, the "
                                 f"generator was asked for {self.device}")
            self.device = mesh.device
        self.norm_scale = norm_scale
        if max_batch is None:
            max_batch = default_max_batch(self.cfg.ndomain)
        if mesh is not None:  # chunks must divide evenly over the mesh
            max_batch = max(mesh.size, max_batch - max_batch % mesh.size)
        self.max_batch = max_batch
        self._gen = self._build(params)
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._held = threading.local()  # a request's weight snapshot
        # on a card, responses leave on a stream of their own, under the
        # forward of the request's next chunk
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def _build(self, params) -> Generator:
        with torch.device("meta"):
            gen = Generator(self.cfg)
        gen.load_state_dict({k: torch.as_tensor(v).to(self.device)
                             for k, v in params.items()},
                            strict=True, assign=True)
        gen = gen.requires_grad_(False).eval()
        return gen if self.mesh is None else replicate(gen, self.mesh)

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_npz(cls, path: str, cfg: Optional[ModelConfig] = None,
                 n_cond_channels: int = 1, **kw):
        """cfg=None infers the architecture from the stored weight shapes."""
        tree = load_params_npz(path)
        cfg = cfg or infer_generator_config(tree, n_cond_channels)
        return cls(params_from_jax(tree), cfg, **kw)

    @classmethod
    def from_keras_h5(cls, path: str, cfg: Optional[ModelConfig] = None,
                      n_cond_channels: int = 1, **kw):
        """cfg=None infers the architecture from the stored weight shapes."""
        tree = load_keras_generator_h5(path, cfg, n_cond_channels)
        cfg = cfg or infer_generator_config(tree, n_cond_channels)
        return cls(params_from_jax(tree), cfg, **kw)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The served weights (state_dict of the current generator)."""
        return self._gen.state_dict()

    def save_npz(self, path: str) -> None:
        """Write the served weights as the JAX package's ``.npz``, which its
        ``PretrainedGenerator.from_npz`` loads."""
        save_params_npz(path, params_to_jax(self.params))

    # -- hot reload --------------------------------------------------------------
    def load_weights_file(self, path: str) -> Dict[str, torch.Tensor]:
        """Read a weight file (.h5 Keras or .npz) into a host state_dict for
        THIS generator's architecture — the load half of a hot reload, safe
        to run off the compute path (pure disk/CPU work)."""
        if path.endswith((".h5", ".hdf5")):
            return params_from_jax(load_keras_generator_h5(path, self.cfg))
        return params_from_jax(load_params_npz(path))

    def reload_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Swap in new weights of the same architecture.

        Validates names, shapes and dtypes BEFORE touching the served
        generator: a mismatch raises and the old weights keep serving.  The
        swap itself is one attribute assignment — an in-flight forward uses
        whichever generator it already grabbed, never a mix.  With a mesh,
        a collective: the new weights are rank 0's."""
        self._gen = self._build(self.check_params(params))

    def check_params(self, params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """`params` as tensors, or ValueError unless their names, shapes
        and dtypes are the served generator's."""
        cur = self.params
        new = {k: torch.as_tensor(v) for k, v in params.items()}
        if set(cur) != set(new):
            raise ValueError(
                f"param names mismatch: serving {sorted(cur)}, got "
                f"{sorted(new)} — reload requires the same architecture")
        bad = [
            f"{k}: serving {tuple(cur[k].shape)}/{cur[k].dtype}, got "
            f"{tuple(new[k].shape)}/{new[k].dtype}"
            for k in sorted(cur)
            if new[k].shape != cur[k].shape or new[k].dtype != cur[k].dtype
        ]
        if bad:
            raise ValueError("param mismatch (reload requires identical "
                             "shapes/dtypes):\n  " + "\n  ".join(bad))
        return new

    # -- warmup ----------------------------------------------------------------
    def warm(self, batch_sizes=("max",)) -> float:
        """Run the forward once at the given request sizes BEFORE serving
        traffic, so that kernel builds, cuDNN algorithm choice and the
        caching allocator's first growth happen outside any request.

        Each entry is ``"max"`` (the `max_batch` chunk shape), ``"buckets:N"``
        (every micro-batching bucket size {2^k, 1.5*2^k} up to N), or an int
        n (capped at `max_batch`); with a mesh the forward pads each to a
        multiple of its size, as it pads a request.  Returns the total
        warm seconds.  Uses zero inputs; the generator's random stream is
        not consumed."""
        sizes = []
        for b in batch_sizes:
            if b == "max":
                sizes.append(self.max_batch)
            elif isinstance(b, str) and b.startswith("buckets"):
                _, _, lim = b.partition(":")
                lim = min(int(lim) if lim else 16, self.max_batch)
                p = 1
                while p <= lim:
                    sizes.append(p)
                    if 3 * p // 2 <= lim and p > 1:
                        sizes.append(3 * p // 2)
                    p <<= 1
            else:
                sizes.append(min(int(b), self.max_batch))
        t0 = time.perf_counter()
        for n in sorted(set(max(1, n) for n in sizes)):
            cfg = self.cfg
            lat = torch.zeros((n, cfg.latent_dim), device=self.device)
            cnd = torch.zeros((n, cfg.ndomain, cfg.ndomain,
                               cfg.n_cond_channels), device=self.device)
            self._device_forward(lat, cnd, self._gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    # -- inference ------------------------------------------------------------
    def _normalize_cond(self, cond: np.ndarray) -> np.ndarray:
        """Channel-aware conditioning normalization.

        Channel 0 is the daily precipitation sum in mm, divided by
        norm_scale; any extra variant channels — doy sin/cos, normalized lon
        index — arrive already in their natural ranges and pass through
        untouched.  Accepts any leading dims; a missing channel axis is
        added for the base 1-channel case."""
        if cond.ndim == 2 or (cond.ndim == 3
                              and self.cfg.n_cond_channels == 1
                              and cond.shape[-1] != 1):
            # (nd, nd) map or (K, nd, nd) stack of base maps
            cond = cond[..., None]
        if cond.shape[-1] != self.cfg.n_cond_channels:
            raise ValueError(
                f"cond has {cond.shape[-1]} channels where this generator "
                f"needs {self.cfg.n_cond_channels} (channel 0 = daily sums "
                f"in mm; extra channels per the variant's scheme, "
                "data/sampler.py)")
        nd = self.cfg.ndomain
        if cond.shape[-3:-1] != (nd, nd):
            # catches e.g. a (nd, nd, 3) array fed to a 1-channel generator,
            # which the heuristic above would otherwise expand into a
            # nonsense (nd, nd, 3, 1) "stack" that fails far downstream
            raise ValueError(
                f"cond shape {cond.shape} does not end in "
                f"({nd}, {nd}, {self.cfg.n_cond_channels}) — expected one "
                f"conditioning map or a (K, ...) stack of them")
        norm = cond.astype(np.float32).copy()
        norm[..., 0] /= self.norm_scale
        return norm

    def _latent(self, n: int) -> torch.Tensor:
        return torch.randn((n, self.cfg.latent_dim), generator=self._rng,
                           device=self.device)

    def _device_forward(self, lat, cnd, gen: Generator) -> torch.Tensor:
        """One forward; with a mesh, this rank's shard of the batch
        (zero-padded to a multiple of the mesh size), then the shards
        gathered and the padding dropped."""
        with span("prdisagg.forward"), torch.inference_mode():
            if self.mesh is None:
                return gen(lat, cnd)
            n = lat.shape[0]
            pad = (-n) % self.mesh.size
            if pad:
                lat = torch.cat([lat, lat.new_zeros((pad, *lat.shape[1:]))])
                cnd = torch.cat([cnd, cnd.new_zeros((pad, *cnd.shape[1:]))])
            out = gen(batch_shard(lat, self.mesh), batch_shard(cnd, self.mesh))
            return all_gather_batch(out, self.mesh)[:n]

    def predict_fractions(self, latent, cond_batch) -> torch.Tensor:
        """Raw generator output on the device: (B, nhours, nd, nd, 1)
        fractions.  Batches above `max_batch` run in chunks of `max_batch`,
        all with ONE weight snapshot: a concurrent hot reload swaps the
        generator atomically, and a chunked request must not mix versions.
        Inside a ``generate_scenarios*`` call, every call on its thread
        uses the snapshot that the request took at its start."""
        latent = torch.as_tensor(latent, dtype=torch.float32,
                                 device=self.device)
        cond_batch = torch.as_tensor(cond_batch, dtype=torch.float32,
                                     device=self.device)
        gen = getattr(self._held, "gen", None)
        if gen is None:
            gen = self._gen
        n, mb = latent.shape[0], self.max_batch
        if n <= mb:
            return self._device_forward(latent, cond_batch, gen)
        return torch.cat([
            self._device_forward(latent[i0:i0 + mb], cond_batch[i0:i0 + mb],
                                 gen)
            for i0 in range(0, n, mb)])

    @contextlib.contextmanager
    def _snapshot(self):
        """Hold this thread's `predict_fractions` calls to the generator
        served now, so that the chunks of one request never mix weight
        versions whatever a hot reload swaps in meanwhile."""
        self._held.gen = self._gen
        try:
            yield
        finally:
            self._held.gen = None

    def _fetch(self, t: torch.Tensor, dst: torch.Tensor, ready,
               c: Optional[torch.Tensor] = None) -> None:
        """The device chunk `t` into the host slice `dst`, returning once it
        has landed; with `c`, `t` holds float16 fractions and `dst` gets
        them times `c` times `norm_scale`, in float32 on the host.

        On a card the chunk is copied on the copy stream once its event
        `ready` has passed, beside whatever the compute stream runs next,
        straight into `dst` (or into a host float16 tensor); `t`'s memory
        is not reused before the copy ends."""
        stream = self._copy_stream
        with span("prdisagg.fetch"):
            src = t
            if stream is not None:
                src = dst if c is None else torch.empty(t.shape,
                                                        dtype=t.dtype)
                with torch.cuda.stream(stream):
                    stream.wait_event(ready)
                    t.record_stream(stream)
                    src.copy_(t)  # a blocking copy waits for its stream
            if c is not None:
                torch.mul(src.float() * c, self.norm_scale, out=dst)
            elif src is not dst:
                dst.copy_(src)

    def _serve(self, latent, cond_batch, cond0: np.ndarray, per: int,
               rows: int) -> np.ndarray:
        """A request's response: the first `rows` rows of the batch's
        scenarios in mm, (rows, nhours, nd, nd), as one host float32 array
        that the caller owns.

        The batch runs through `predict_fractions` in chunks of at most
        `max_batch` rows, all queued before any copy and all on one weight
        snapshot.  Each chunk's fractions are scaled by their daily sums on
        the device (with a float16 wire, on the host after the copy), as
        element-wise products, so any chunking gives the same bits.  The
        host touches the array's pages while the device computes; then each
        chunk's copy waits for that chunk alone, so it runs under the next
        chunk's forward.

        `cond_batch` is the normalized condition of every row; `cond0`
        holds the normalized daily sums (channel 0) on the host, one map
        for every `per` rows, for the float16 wire's host scaling."""
        latent = torch.as_tensor(latent, dtype=torch.float32,
                                 device=self.device)
        cond_batch = torch.as_tensor(cond_batch, dtype=torch.float32,
                                     device=self.device)
        if latent.shape[0] != cond_batch.shape[0]:
            raise ValueError(f"{latent.shape[0]} latents for "
                             f"{cond_batch.shape[0]} conditions")
        mb, chunks = self.max_batch, []
        with self._snapshot():
            for i0 in range(0, rows, mb):
                m = min(mb, rows - i0)
                frac = self.predict_fractions(
                    latent[i0:i0 + mb], cond_batch[i0:i0 + mb])[:m]
                frac = frac.squeeze(-1)
                if self.wire_dtype is None:
                    c = cond_batch[i0:i0 + m, ..., 0]
                    wire = frac * c.unsqueeze(-3) * self.norm_scale
                else:
                    wire = frac.to(torch.float16)
                ready = None
                if self._copy_stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(self.device))
                chunks.append((i0, wire, ready))
        nd = self.cfg.ndomain
        # torch's CPU allocator, as `.cpu()` used
        host = torch.empty((rows, self.cfg.nhours, nd, nd),
                           dtype=torch.float32)
        out = host.numpy()
        with span("prdisagg.fetch.touch"):
            _touch_pages(out)
        for i0, wire, ready in chunks:
            c = None
            if self.wire_dtype is not None:
                c = torch.as_tensor(
                    cond0[np.arange(i0, i0 + len(wire)) // per]).unsqueeze(-3)
            self._fetch(wire, host[i0:i0 + len(wire)], ready, c)
        return out

    def generate_scenarios(
        self, cond: np.ndarray, n_scenarios: int,
        latent: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Reference semantics (raindisagg_gan_pretrained.py:52-65).

        cond: (nd, nd) or (nd, nd, C) daily precipitation sums in mm
        (channel 0; variant generators take their extra conditioning
        channels after it).  Returns (n_scenarios, nhours, nd, nd) hourly
        precipitation in mm.
        """
        with span("prdisagg.request"):
            cond_norm = self._normalize_cond(
                np.asarray(cond, dtype=np.float32))
            if latent is None:
                latent = self._latent(n_scenarios)
            cond_batch = torch.as_tensor(cond_norm, device=self.device)[None]
            cond_batch = cond_batch.expand(n_scenarios, *cond_norm.shape)
            return self._serve(latent, cond_batch, cond_norm[None, ..., 0],
                               n_scenarios, n_scenarios)

    def generate_scenarios_batch(
        self, conds: np.ndarray, n_scenarios: int,
        latent: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Serve MANY conditions in one fused forward.

        conds: (K, nd, nd) or (K, nd, nd, C) daily precipitation sums in mm.
        Returns (K, n_scenarios, nhours, nd, nd) hourly precipitation in mm
        — row k equals ``generate_scenarios(conds[k], n_scenarios)`` up to
        the latent draw.  `max_batch` chunking bounds device memory for
        any K."""
        with span("prdisagg.request"):
            cond_norm = self._normalize_cond(
                np.asarray(conds, dtype=np.float32))   # (K, nd, nd, C)
            k = cond_norm.shape[0]
            if latent is None:
                latent = self._latent(k * n_scenarios)
            cond_batch = torch.as_tensor(cond_norm, device=self.device)
            cond_batch = cond_batch.repeat_interleave(n_scenarios, dim=0)
            out = self._serve(latent, cond_batch, cond_norm[..., 0],
                              n_scenarios, k * n_scenarios)
            return out.reshape(k, n_scenarios, *out.shape[1:])

    def generate_scenarios_multi(
        self, conds: list, n_list: list,
    ) -> list:
        """Serve HETEROGENEOUS requests in one fused forward.

        conds: list of daily-sum maps, each (nd, nd) or (nd, nd, 1) in mm;
        n_list: per-request scenario counts.  Returns a list of
        (n_i, nhours, nd, nd) arrays — request i's scenarios.

        This is the device side of the serving daemon's dynamic
        micro-batching: K concurrent small requests cost one forward and
        fill the batch dimension.  One latent draw covers the fused batch,
        so each request still gets independent N(0,1) latents, but the exact
        values depend on how requests were batched together.  Fused totals
        under `max_batch` are zero-padded up to a bucket size in
        {2^k, 1.5*2^k} (< 50% padding), which keeps the set of batch shapes
        the device sees small; padded rows are sliced off."""
        if len(conds) != len(n_list) or not conds:
            raise ValueError("conds and n_list must be equal-length and "
                             "non-empty")
        with span("prdisagg.request"):
            norm, counts = [], []
            for cond, n in zip(conds, n_list):
                norm.append(self._normalize_cond(
                    np.asarray(cond, dtype=np.float32)))
                counts.append(int(n))
            total = sum(counts)
            target = max(min(_bucket(total), self.max_batch), total)
            latent = self._latent(target)
            cond_batch = np.repeat(np.stack(norm), counts, axis=0)
            if target > total:  # pad conds to the bucket shape; sliced below
                cond_batch = np.concatenate(
                    [cond_batch, np.zeros((target - total,
                                           *cond_batch.shape[1:]),
                                          cond_batch.dtype)])
            scenarios = self._serve(latent, cond_batch, cond_batch[..., 0],
                                    1, total)
            return list(np.split(scenarios, np.cumsum(counts)[:-1]))

    def plot_scenarios(self, scenarios: np.ndarray,
                       hour_labels: str = "reference"):
        return plot_scenarios(scenarios, hour_labels=hour_labels)


def generate_scenarios(gen: PretrainedGenerator, cond, n_scenarios: int):
    """Free-function form of the reference API."""
    return gen.generate_scenarios(cond, n_scenarios)


def plot_scenarios(scenarios: np.ndarray, hour_labels: str = "reference"):
    """n x 24 map grid of (n, 24, nd, nd) mm scenarios, LogNorm(0.01, 50)
    and a shared colorbar (raindisagg_gan_pretrained.py:68-90).  Needs
    matplotlib.

    hour_labels="reference" (default) reproduces the reference's off-by-one
    panel indexing on purpose: panel ``jplot`` shows ``scenarios[:,
    jplot-1]`` under the label ``{jplot:02d}:00``, so the column labelled
    00:00 shows hour 23 (raindisagg_gan_pretrained.py:80 indexes with
    ``plotidx-1`` from a 1-based plotidx).  hour_labels="aligned" shows
    hour ``jplot`` under that label."""
    from matplotlib.colors import LogNorm

    from prdisagg_torch.utils.plotting import _pyplot

    if hour_labels not in ("reference", "aligned"):
        raise ValueError(f"unknown hour_labels {hour_labels!r}")
    _, plt = _pyplot()
    shift = -1 if hour_labels == "reference" else 0
    scenarios = np.asarray(scenarios)
    nrows = len(scenarios)
    fig = plt.figure(figsize=(24, nrows))
    plt.axis("off")
    im = None
    for iplot in range(nrows):
        for jplot in range(24):
            ax = plt.subplot(nrows, 24, iplot * 24 + jplot + 1)
            if iplot == 0:
                ax.annotate(
                    f"{jplot:02d}:00", xy=(0.5, 1), xytext=(0, 5),
                    xycoords="axes fraction", textcoords="offset points",
                    size="large", ha="center", va="baseline")
            im = plt.imshow(scenarios[iplot, jplot + shift, :, :],
                            cmap=plt.cm.gist_earth_r,
                            norm=LogNorm(vmin=0.01, vmax=50))
            plt.axis("off")
    fig.subplots_adjust(right=0.93)
    cbar_ax = fig.add_axes([0.93, 0.15, 0.007, 0.7])
    cbar = fig.colorbar(im, cax=cbar_ax)
    cbar.set_label("fraction of daily precipitation", fontsize=16)
    cbar.ax.tick_params(labelsize=16)
    return fig
