"""The probe kernels' plain versions (ops/probe.py) against a numpy
transcription of the JAX package's probes (scripts/probe_kernel.py).

The JAX probes are closures inside ``probe1`` / ``probe2`` that return only
profiler durations, so their bodies (:31-32 and :55-94) are transcribed
here in numpy, loop for loop: per program the window at the 8-aligned start,
every chunk's 32 rows unmasked, the alpha, the inclusive scan feeding
``exp(s - s)``, the three payload sums. Inputs: the script's own
(``counts`` = 2, all-ones rows) at a small grid, and seeded random ones
with zero counts and windows spanning two chunks. Tolerance: relative 1e-6
(float32 sums in another order); P1 exact. The kernels themselves are held
against these plain versions on the card (test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu_torch.ops import probe as P

NT, MP = 200, 1024


def numpy_probe2(starts, counts, rec):
    """scripts/probe_kernel.py:55-94 in numpy, one program at a time."""
    nt = len(starts)
    out = np.zeros((nt, 8, 256), np.float32)
    px = np.arange(256, dtype=np.float32)[None, :]
    for t in range(nt):
        start, count = int(starts[t]), int(counts[t])
        astart = (start // 8) * 8
        end = start - astart + count
        nchunks = 0 if count == 0 else -(-end // 32)
        acc = np.zeros((1, 256), np.float32)
        for i in range(nchunks):
            r = rec[astart + i * 32: astart + (i + 1) * 32]      # (32, 128)
            dx = px - r[:, 0:1]
            dy = px - r[:, 1:2]
            q = (r[:, 2:3] * dx * dx + np.float32(2.0) * r[:, 3:4] * dx * dy
                 + r[:, 4:5] * dy * dy)
            a = np.clip(r[:, 5:6] * np.exp(np.float32(-0.5) * q),
                        np.float32(0.0), np.float32(0.99))
            s = np.maximum(np.log1p(-a), np.float32(-30.0))
            s = np.cumsum(s, axis=0)
            w = np.exp(s - s) * a
            acc = acc + (np.sum(w * r[:, 6:7], axis=0, keepdims=True)
                         + np.sum(w * r[:, 7:8], axis=0, keepdims=True)
                         + np.sum(w * r[:, 8:9], axis=0, keepdims=True))
        out[t] = np.broadcast_to(acc, (8, 256))
    return out


def _rel(got, want):
    return float(np.linalg.norm((got - want).astype(np.float64))
                 / np.linalg.norm(want.astype(np.float64)))


@pytest.mark.parametrize("inputs", ["script", "seeded_random"])
def test_probe_window_plain_matches_numpy_transcription(inputs):
    if inputs == "script":
        args = P.probe_inputs(NT, MP, device="cpu")
    else:
        args = P.probe_random_inputs(NT, MP, seed=3, device="cpu")
    starts, counts, rec = (t.numpy() for t in args)
    chunks = P.window_chunks(*args[:2])[1]
    if inputs == "seeded_random":
        # the cases the script's inputs never reach
        assert (counts == 0).any() and int(chunks.max()) == 2
        assert int((chunks == 1).sum()) > 0
    want = numpy_probe2(starts, counts, rec)
    got = P.probe_window(*args).numpy()            # plain version on the CPU
    assert got.shape == (NT, 8, 256)
    assert _rel(got, want) <= 1e-6
    assert (got[counts == 0] == 0).all()
    assert (got == got[:, :1]).all()               # each row the same sum


def test_probe_window_reads_rows_past_the_table_as_zero():
    starts = torch.tensor([MP - 8], dtype=torch.int32)
    counts = torch.tensor([40], dtype=torch.int32)   # two chunks, past MP
    rec = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(MP, 128)).astype(np.float32))
    padded = torch.cat([rec, torch.zeros((64, 128))])
    np.testing.assert_array_equal(
        P.probe_window(starts, counts, rec).numpy(),
        P.probe_window(starts, counts, padded).numpy())


def test_probe_zero_plain_and_sizes():
    out = P.probe_zero(7, device="cpu")
    assert out.shape == (7, 8, 256) and out.dtype == torch.float32
    assert not out.any()
    assert (P.NT, P.MP, P.G) == (65856, 1 << 18, 32)
    assert P.P2_OPS_PER_ELEMENT == 29
    starts, counts, rec = P.probe_inputs(10, 64, device="cpu")
    assert starts.tolist() == list(range(0, 20, 2)) and (rec == 1).all()
    assert P.window_chunks(starts, counts)[1].tolist() == [1] * 10


def test_profiling_helpers_on_the_cpu():
    """The port's utils/profiling.py off the card: no device time without
    a card."""
    from intro_to_gaussian_splatting_tpu_torch.utils import profiling as U

    assert U.profile_device_time(lambda: torch.ones(4), iters=2) == []
