"""The FDMT block on a host ('system') ring (blocks/fdmt.py): the input is
staged onto the pipeline's device with a carried tail of the last
max_delay frames, so after a sequence's first gulp only the new frames
cross, as the JAX block's `_stage_gulp` does (bifrost_tpu/blocks/
fdmt.py:179-212).

array_source (u8 [time, freq]) -> transpose(['freq', 'time']) -> fdmt,
every ring in the 'system' space (the layout `frb_search_spec` builds
after the capture): the stream split into gulps is BITWISE the stream in
one gulp (u8 sums are exact in f32), the output ring stays in the input's
space, and the staged-frame count equals the JAX block's on the same
chain."""

import numpy as np
import pytest

from bifrost_tpu_torch.blocks import fdmt, gather_sink, transpose
from bifrost_tpu_torch.blocks.testing import array_source, inject_burst
from bifrost_tpu_torch.pipeline import Pipeline

NCHAN, MAX_DELAY, NFRAME = 64, 16, 384
F0, DF, DT = 40.0, 0.00928, 1e-3


def _data():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 32, (NFRAME, NCHAN)).astype(np.uint8)
    inject_burst(data, 200, 10, F0, DF, amp=60)
    return data


HDR = {"labels": ["time", "freq"], "scales": [[0.0, DT], [F0, DF]],
       "units": ["s", "MHz"]}


def _port(data, gulp):
    out = []
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, gulp, header=dict(HDR))
        t = transpose(src, ["freq", "time"], gulp_nframe=gulp)
        d = fdmt(t, max_delay=MAX_DELAY, gulp_nframe=gulp)
        gather_sink(d, out, gulp_nframe=gulp)
    pipe.run()
    return np.concatenate(out, axis=-1), d


def _jax(data, gulp):
    from bifrost_tpu import blocks as jblocks
    from bifrost_tpu.blocks.testing import array_source as j_source
    from bifrost_tpu.blocks.testing import gather_sink as j_gather
    from bifrost_tpu.pipeline import Pipeline as JaxPipeline
    out = []
    with JaxPipeline() as pipe:
        src = j_source(data, gulp, header=dict(HDR))
        t = jblocks.transpose(src, ["freq", "time"], gulp_nframe=gulp)
        d = jblocks.fdmt(t, max_delay=MAX_DELAY, gulp_nframe=gulp)
        j_gather(d, out, gulp_nframe=gulp)
    pipe.run()
    return np.concatenate(out, axis=-1), d


@pytest.mark.parametrize("gulp", [32, 48, 100])
def test_split_stream_bitwise_equals_one_gulp(gulp):
    whole, dw = _port(_data(), NFRAME)
    split, ds = _port(_data(), gulp)
    assert ds.orings[0].space == ds.irings[0].space == "system"
    assert whole.shape == split.shape == (MAX_DELAY, NFRAME - MAX_DELAY)
    assert np.array_equal(whole.view(np.uint32), split.view(np.uint32))
    # Only new frames cross after the first gulp.
    assert dw._frames_staged == NFRAME
    assert ds._frames_staged == NFRAME


@pytest.mark.parametrize("gulp", [32, 100])
def test_staged_frames_and_output_equal_the_jax_block(gulp):
    p, dp = _port(_data(), gulp)
    j, dj = _jax(_data(), gulp)
    assert dp._frames_staged == dj._frames_staged
    assert p.shape == j.shape
    assert np.array_equal(p.view(np.uint32),
                          np.asarray(j, np.float32).view(np.uint32))
