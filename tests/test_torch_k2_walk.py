"""The patch-gather kernel's (K2's) walk against the JAX package, on the CPU.

``csrc/gather.cu``'s ``k2_gather`` runs a grid of (patch, block of
HOURS_PER_BLOCK hours) with THREADS threads; on its 16-byte path each thread
loads UNROLL float4s into registers before it stores any, on its scalar
path one float per pass.  A plain numpy emulation of that walk, with the
kernel's own constants read from its source, must write every output
element exactly once, read only inside the tensor with 16-byte aligned
vector accesses, and equal the plain version and the TPU kernel (Pallas
interpret mode) bit for bit.  The launch records the wrapper caches are
checked with a stand-in for the library.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.ops import gather as tg  # noqa: E402
from prdisagg_tpu.ops.pallas_gather import gather_patches_pallas  # noqa: E402

_SOURCE = Path(tg.__file__).resolve().parent.parent / "csrc" / "gather.cu"
K = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                         _SOURCE.read_text()).group(1))
     for name in ("THREADS", "HOURS_PER_BLOCK", "UNROLL")}
# the rows of tests/test_torch_train.py (y on the TPU kernel's 8-row
# alignment; x = 5 takes the scalar path) plus the last day, row and column
# of a (4, nh, 48, 40) tensor
ROWS = np.array([[0, 0, 5], [2, 16, 16], [3, 32, 24], [1, 8, 0],
                 [3, 32, 24], [3, 0, 0], [0, 32, 12]], dtype=np.int32)


def _emulate(data, rows, nd, aligned=True):
    """k2_gather in numpy, block for block and thread for thread.  Returns
    the output and how often each of its elements was written."""
    _, nh, ny, nx = data.shape
    flat = data.reshape(-1)
    threads, hours, unroll = (K["THREADS"], K["HOURS_PER_BLOCK"],
                              K["UNROLL"])
    out = np.full(len(rows) * nh * nd * nd, np.nan, np.float32)
    writes = np.zeros(out.size, np.int64)
    plane = ny * nx
    vec_ok = nx % 4 == 0 and nd % 4 == 0 and aligned
    tid = np.arange(threads)
    for b, (t, y, x) in enumerate(rows.astype(np.int64)):
        for h0 in range(0, nh, hours):
            hn = min(hours, nh - h0)
            src = (t * nh + h0) * plane + y * nx + x
            dst = (b * nh + h0) * nd * nd
            if vec_ok and x % 4 == 0:
                q = nd // 4
                n = hn * nd * q
                # pass p, unrolled load u, thread: i = base + u * THREADS
                passes = np.arange(-(-n // (threads * unroll)))
                i = (passes[:, None, None] * threads * unroll
                     + np.arange(unroll)[None, :, None] * threads
                     + tid[None, None, :]).ravel()
                i = i[i < n]
                c, r, h = i % q, (i // q) % nd, i // (q * nd)
                s = src + h * plane + r * nx + 4 * c
                d = dst + 4 * i
                assert (s % 4 == 0).all() and (d % 4 == 0).all()
                s = (s[:, None] + np.arange(4)).ravel()
                d = (d[:, None] + np.arange(4)).ravel()
            else:
                n = hn * nd * nd
                i = (np.arange(-(-n // threads))[:, None] * threads
                     + tid[None, :]).ravel()
                i = i[i < n]
                c, r, h = i % nd, (i // nd) % nd, i // (nd * nd)
                s = src + h * plane + r * nx + c
                d = dst + i
            assert 0 <= s.min() and s.max() < flat.size
            out[d] = flat[s]
            np.add.at(writes, d, 1)
    shape = (len(rows), nh, nd, nd)
    return out.reshape(shape), writes.reshape(shape)


def _data(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("nh", [24, 1])
@pytest.mark.parametrize("path", ["vector", "scalar"])
def test_emulated_walk_equals_plain_and_pallas_exactly(nh, path):
    data = _data((4, nh, 48, 40), seed=nh)
    got, writes = _emulate(data, ROWS, 16, aligned=path == "vector")
    assert (writes == 1).all()
    want = tg.gather_patches_reference(torch.tensor(data),
                                       torch.tensor(ROWS), 16).numpy()
    pal = np.asarray(gather_patches_pallas(
        jnp.asarray(data), jnp.asarray(ROWS), 16, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("shape,nd,b", [
    ((3, 24, 48, 40), 16, 7),       # the flagship patch
    ((2, 24, 128, 136), 64, 3),     # the 64x64 domain: many passes a block
    ((2, 9, 64, 64), 8, 30),        # a partial hour block
    ((3, 5, 40, 40), 12, 9),        # three float4s a row
    ((3, 5, 17, 23), 5, 9),         # nd % 4: scalar path
    ((4, 24, 33, 37), 16, 4),       # nx % 4: scalar path
    ((2, 1, 21, 19), 16, 5),        # nh = 1, nx % 4
    ((5, 1, 64, 64), 16, 32),       # conditions: nh 1 at B 32
    ((2, 3, 24, 24), 24, 2),        # the whole field
])
def test_emulated_walk_writes_every_element_once(shape, nd, b):
    n_days, nh, ny, nx = shape
    data = _data(shape, seed=sum(shape) + nd)
    rng = np.random.RandomState(b)
    rows = np.stack([rng.randint(0, n_days, b), rng.randint(0, ny - nd + 1, b),
                     rng.randint(0, nx - nd + 1, b)], 1)
    rows[0] = (n_days - 1, ny - nd, nx - nd)  # the last day, row and column
    rows[-1, 2] -= rows[-1, 2] % 4            # one row on the 16-byte path
    got, writes = _emulate(data, rows, nd)
    assert (writes == 1).all()
    for i, (t, y, x) in enumerate(rows):
        np.testing.assert_array_equal(got[i], data[t, :, y:y + nd, x:x + nd])


def test_train_step_block_is_one_pass():
    """A block of the train step's gathers (HOURS_PER_BLOCK hours of a
    16 x 16 patch in float4s) is one pass of the unrolled loop: every
    thread issues all its loads before its first store."""
    n = K["HOURS_PER_BLOCK"] * 16 * 16 // 4
    assert n <= K["THREADS"] * K["UNROLL"]
    assert K["THREADS"] % 32 == 0


def test_launch_records_cached_by_source_shape_nd_and_batch(monkeypatch):
    """One record is prepared per (address, shape, nd, B) and reused; a full
    cache is emptied rather than grown."""
    prepared = []

    def prepare(rec, ptr, b, nh, ny, nx, nd):
        prepared.append((ptr, b, nh, ny, nx, nd))
        return 0

    kernels = (prepare, None, None, 8)
    monkeypatch.setattr(tg, "_records", {})
    key = (4096, 3, 24, 48, 40, 16, 160)
    first = tg._record(key, kernels)
    assert tg._record(key, kernels) is first and len(prepared) == 1
    assert prepared[0] == (4096, 160, 24, 48, 40, 16)
    for other in [(4096, 3, 24, 48, 40, 16, 32), (4096, 6, 12, 48, 40, 16, 160),
                  (8192, 3, 24, 48, 40, 16, 160), (4096, 3, 24, 48, 40, 8, 160)]:
        assert tg._record(other, kernels) is not first
    assert len(prepared) == 5
    for n in range(tg._MAX_RECORDS):
        tg._record((n, 1, 1, 16, 16, 16, 1), kernels)
    assert len(tg._records) <= tg._MAX_RECORDS


def test_failed_prepare_raises(monkeypatch):
    kernels = (lambda *args: 1, None, lambda err: b"invalid argument", 8)
    monkeypatch.setattr(tg, "_records", {})
    with pytest.raises(RuntimeError, match="invalid argument"):
        tg._record((4096, 3, 24, 48, 40, 16, 160), kernels)
    assert tg._records == {}
