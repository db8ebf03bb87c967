"""The port's legacy v1 block API (bifrost_tpu_torch/block.py) against the
JAX package's (bifrost_tpu/block.py): every case of
tests/test_legacy_block.py and of tests/test_pipeline.py's two v1 cases,
run through both packages on the same numpy input.  The v1 blocks are
host code computing with numpy in both packages, so every file they
write, and every header and matrix they return, is compared byte for
byte; the original assertions then hold the port's output.

A zero-copy case feeds the v1 blocks a span published from the
writer's own array (`WriteSpan.publish_external`): the readers must
leave it unchanged."""

import threading

import numpy as np
import pytest

from bifrost_tpu import block as jblk
from bifrost_tpu.io.sigproc import write_header

from bifrost_tpu_torch import block as tblk

PACKAGES = (("jax", jblk), ("torch", tblk))


def _run(blk, blocks):
    blk.Pipeline(blocks).main()


def _read_ascii(path, dtype=np.float32):
    return np.array(open(path).read().split(), dtype=dtype)


def _both(tmp_path, case):
    """Run `case(blk, dir)` -> (paths written, extras) through both
    packages; the files compare byte for byte and the extras equal.
    -> the port's (paths, extras)."""
    res = {}
    for name, blk in PACKAGES:
        d = tmp_path / name
        d.mkdir()
        res[name] = case(blk, d)
    (jpaths, jext), (tpaths, text) = res["jax"], res["torch"]
    assert len(jpaths) == len(tpaths)
    for jp, tp in zip(jpaths, tpaths):
        jb, tb = open(jp, "rb").read(), open(tp, "rb").read()
        assert jb == tb, f"{tp} differs from the JAX block's {jp}"
    assert len(jext) == len(text)
    for je, te in zip(jext, text):
        if isinstance(je, np.ndarray):
            assert je.dtype == te.dtype
            np.testing.assert_array_equal(te, je)
        else:
            assert te == je
    return tpaths, text


def _write_fil(path, data, tsamp=1e-4, fch1=400.0, foff=-0.1,
               tstart=57000.0):
    """A minimal 8-bit sigproc filterbank (the JAX writer)."""
    hdr = {"nchans": data.shape[1], "nifs": 1, "nbits": 8,
           "tsamp": tsamp, "tstart": tstart, "fch1": fch1, "foff": foff,
           "data_type": 1}
    with open(path, "wb") as f:
        write_header(f, hdr)
        f.write(data.astype(np.uint8).tobytes())


def test_legacy_multi_add(tmp_path):
    a = np.arange(8, dtype=np.float32)
    b = np.arange(8, dtype=np.float32) * 10

    def case(blk, d):
        out = str(d / "sum.txt")
        _run(blk, [
            (blk.TestingBlock(a), [], ["a"]),
            (blk.TestingBlock(b), [], ["b"]),
            (blk.MultiAddBlock(), {"in_1": "a", "in_2": "b",
                                   "out_sum": "s"}),
            (blk.WriteAsciiBlock(out), ["s"], []),
        ])
        return [out], []
    (out,), _ = _both(tmp_path, case)
    np.testing.assert_array_equal(_read_ascii(out), a + b)


def test_legacy_splitter(tmp_path):
    arr = np.arange(8, dtype=np.float32)
    sections = [[0, 1, 2, 3], [4, 5, 6, 7]]

    def case(blk, d):
        out1, out2 = str(d / "s1.txt"), str(d / "s2.txt")
        _run(blk, [
            (blk.TestingBlock(arr), [], ["in"]),
            (blk.SplitterBlock(sections),
             {"in": "in", "out_1": "o1", "out_2": "o2"}),
            (blk.WriteAsciiBlock(out1), ["o1"], []),
            (blk.WriteAsciiBlock(out2), ["o2"], []),
        ])
        return [out1, out2], []
    (out1, out2), _ = _both(tmp_path, case)
    np.testing.assert_array_equal(_read_ascii(out1), arr[sections[0]])
    np.testing.assert_array_equal(_read_ascii(out2), arr[sections[1]])


def test_legacy_fft_ifft_roundtrip(tmp_path):
    arr = np.random.default_rng(0).standard_normal(16).astype(np.float32)

    def case(blk, d):
        out, spec = str(d / "fft.txt"), str(d / "spec.txt")
        _run(blk, [
            (blk.TestingBlock(arr), [], [0]),
            (blk.FFTBlock(), [0], [1]),
            (blk.IFFTBlock(), [1], [2]),
            (blk.WriteAsciiBlock(out), [2], []),
        ])
        _run(blk, [
            (blk.TestingBlock(arr), [], [0]),
            (blk.FFTBlock(), [0], [1]),
            (blk.WriteAsciiBlock(spec), [1], []),
        ])
        return [out, spec], []
    (out, spec), _ = _both(tmp_path, case)
    vals = _read_ascii(out)
    got = vals.reshape(-1, 2)[:, 0]     # interleaved (re, im): real parts
    np.testing.assert_allclose(got, arr, rtol=1e-4, atol=1e-4)
    fwd = _read_ascii(spec).view(np.complex64)
    np.testing.assert_array_equal(
        fwd, np.fft.fft(arr.astype(np.complex64)).astype(np.complex64))


def test_legacy_write_header(tmp_path):
    arr = np.arange(4, dtype=np.float32)

    def case(blk, d):
        out = str(d / "hdr.txt")
        _run(blk, [
            (blk.TestingBlock(arr), [], [0]),
            (blk.WriteHeaderBlock(out), [0], []),
        ])
        return [out], []
    (out,), _ = _both(tmp_path, case)
    text = open(out).read()
    assert "float32" in text and "shape" in text


def test_legacy_numpy_source_block(tmp_path):
    def gen():
        for i in range(3):
            yield np.full(4, float(i), dtype=np.float32)

    def case(blk, d):
        out = str(d / "src.txt")
        _run(blk, [
            (blk.NumpySourceBlock(gen, changing=False), {"out_1": "x"}),
            (blk.WriteAsciiBlock(out), ["x"], []),
        ])
        return [out], []
    (out,), _ = _both(tmp_path, case)
    want = np.concatenate([np.full(4, float(i), np.float32)
                           for i in range(3)])
    np.testing.assert_array_equal(_read_ascii(out), want)


def test_legacy_numpy_block_two_inputs(tmp_path):
    a = np.arange(6, dtype=np.float32)
    b = np.arange(6, dtype=np.float32) + 1

    def case(blk, d):
        out = str(d / "dot.txt")
        _run(blk, [
            (blk.TestingBlock(a), [], ["a"]),
            (blk.TestingBlock(b), [], ["b"]),
            (blk.NumpyBlock(lambda x, y: x * y, inputs=2),
             {"in_1": "a", "in_2": "b", "out_1": "c"}),
            (blk.WriteAsciiBlock(out), ["c"], []),
        ])
        return [out], []
    (out,), _ = _both(tmp_path, case)
    np.testing.assert_array_equal(_read_ascii(out), a * b)


def _sigproc_like_source(blk, data, header):
    """A SourceBlock feeding bytes under a sigproc-read-style header."""

    class Source(blk.SourceBlock):
        def main(self, output_ring):
            self.gulp_size = max(1, data.nbytes)
            self.write_to_ring(output_ring, data.tobytes(), header)
    return Source()


def test_legacy_kurtosis_flags_bad_channel(tmp_path):
    rng = np.random.default_rng(1)
    nsamp, nchan = 512, 4
    # Channels 0, 1, 3: gamma(2) power, whose SK estimator tends to the
    # block's expected 0.5; channel 2 is constant (estimator 0: flagged).
    power = rng.gamma(2.0, 1.0, (nsamp, nchan)).astype(np.float32)
    power[:, 2] = 1.0
    hdr = {"frame_shape": [nchan, 1], "dtype": "float32", "nbit": 32}

    def case(blk, d):
        out = str(d / "sk.txt")
        _run(blk, [
            (_sigproc_like_source(blk, power, hdr), [], [0]),
            (blk.KurtosisBlock(gulp_size=power.nbytes), [0], [1]),
            (blk.WriteAsciiBlock(out), [1], []),
        ])
        return [out], []
    (out,), _ = _both(tmp_path, case)    # the SK flags, bitwise
    got = _read_ascii(out).reshape(nsamp, nchan)
    assert np.all(got[:, 2] == 0), "constant channel not flagged"
    np.testing.assert_array_equal(got[:, 0], power[:, 0])
    np.testing.assert_array_equal(got[:, 3], power[:, 3])


def test_legacy_sigproc_read(tmp_path):
    fil = str(tmp_path / "t.fil")
    data = np.arange(64, dtype=np.uint8).reshape(16, 4)
    _write_fil(fil, data)

    def case(blk, d):
        out = str(d / "fil.txt")
        _run(blk, [
            (blk.SigprocReadBlock(fil), [], [0]),
            (blk.WriteAsciiBlock(out), [0], []),
        ])
        return [out], []
    (out,), _ = _both(tmp_path, case)
    got = _read_ascii(out, dtype=np.float64).astype(np.uint8)
    np.testing.assert_array_equal(got, data.reshape(-1))


def test_legacy_waterfall_and_dedisperse(tmp_path):
    fil = str(tmp_path / "w.fil")
    nsamp, nchan = 32, 8
    data = np.random.default_rng(2).integers(
        0, 255, (nsamp, nchan)).astype(np.uint8)
    _write_fil(fil, data)

    def case(blk, d):
        npy = str(d / "waterfall.npy")
        ring = blk.Ring(name="legacy_wf")
        src = blk.SigprocReadBlock(fil)
        wf = blk.WaterfallBlock(ring, imagename=npy)
        t = threading.Thread(target=src.main, args=[ring], daemon=True)
        t.start()
        matrix = wf.main()
        t.join(timeout=10)
        assert not t.is_alive()
        # Dedisperse tags the header with per-channel delays.
        t2 = threading.Thread(target=src.main, args=[ring], daemon=True)
        t2.start()
        hdr = blk.DedisperseBlock(ring).main(dispersion_measure=10.0)
        t2.join(timeout=10)
        assert not t2.is_alive()
        return [npy], [matrix, np.array(hdr["delays_samples"]),
                       sorted(hdr)]
    _, (matrix, delays, _) = _both(tmp_path, case)
    np.testing.assert_array_equal(matrix, data)
    assert delays.shape == (nchan,)
    assert delays[0] == 0.0
    assert np.all(np.diff(delays) > 0)  # lower freq -> larger delay


def test_legacy_fold_recovers_pulse_phase(tmp_path):
    fil = str(tmp_path / "p.fil")
    nsamp, nchan, bins = 1024, 2, 8
    period, tsamp = 8e-4, 1e-4  # pulse period == 8 samples
    t = np.arange(nsamp) * tsamp
    pulse = (np.fmod(t, period) < tsamp).astype(np.uint8) * 100
    data = np.repeat(pulse[:, None], nchan, axis=1) + 10
    _write_fil(fil, data, tsamp=tsamp, foff=0.0, tstart=0.0)

    def case(blk, d):
        out = str(d / "fold.txt")
        _run(blk, [
            (blk.SigprocReadBlock(fil), [], [0]),
            (blk.FoldBlock(bins=bins, period=period, dispersion_measure=0),
             [0], [1]),
            (blk.WriteAsciiBlock(out), [1], []),
        ])
        return [out], []
    (out,), _ = _both(tmp_path, case)    # the histogram, bitwise
    hist = _read_ascii(out)
    assert hist.shape == (bins,)
    above = hist > 3 * np.median(hist)
    assert above.sum() == 1, hist
    assert hist.max() > 5 * np.median(hist)


def test_insert_zeros_evenly():
    arr = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    out = tblk.insert_zeros_evenly(arr, 2)
    want = jblk.insert_zeros_evenly(arr, 2)
    assert out.dtype == want.dtype
    np.testing.assert_array_equal(out, want)
    assert out.size == 6
    assert np.count_nonzero(out == 0) >= 2


def test_legacy_block_api(tmp_path):
    """v1 byte-oriented API (tests/test_pipeline.py's basic case)."""
    arr = np.arange(8, dtype=np.float32)

    def case(blk, d):
        out = str(d / "out.txt")
        blk.Pipeline([
            (blk.TestingBlock(arr), [], [0]),
            (blk.CopyBlock(), [0], [1]),
            (blk.WriteAsciiBlock(out), [1], []),
        ]).main()
        return [out], []
    (out,), _ = _both(tmp_path, case)
    np.testing.assert_array_equal(
        np.array(open(out).read().split(), dtype=np.float32), arr)


def test_legacy_numpy_block(tmp_path):
    """NumpyBlock as a MultiTransformBlock with dict-wired ports
    (tests/test_pipeline.py's second v1 case)."""
    arr = np.arange(6, dtype=np.float32)

    def case(blk, d):
        out = str(d / "out2.txt")
        blk.Pipeline([
            (blk.TestingBlock(arr), [], ["a"]),
            (blk.NumpyBlock(lambda x: x * 2), {"in_1": "a", "out_1": "b"}),
            (blk.WriteAsciiBlock(out), ["b"], []),
        ]).main()
        return [out], []
    (out,), _ = _both(tmp_path, case)
    np.testing.assert_array_equal(
        np.array(open(out).read().split(), dtype=np.float32), arr * 2)


def test_port_exports_the_jax_v1_names():
    assert tblk.__all__ == jblk.__all__
    for name in jblk.__all__:
        assert hasattr(tblk, name), name


@pytest.mark.parametrize("reader", ["kurtosis", "copy"])
def test_v1_readers_leave_a_zero_copy_span_unchanged(tmp_path, reader):
    """The v1 blocks read a span published from the writer's own array
    (the zero-copy host plane: readers see the publisher's memory) and
    leave that array as it was; the output is the JAX block's."""
    nsamp, nchan = 64, 4
    power = np.random.default_rng(5).gamma(
        2.0, 1.0, (nsamp, nchan)).astype(np.float32)
    power[:, 1] = 1.0                   # a channel the SK flag zeroes
    published = power.view(np.uint8).reshape(-1).copy()
    before = published.copy()
    hdr = {"frame_shape": [nchan, 1], "dtype": "float32", "nbit": 32}

    class Publisher(tblk.SourceBlock):
        def main(self, ring):
            ring.begin_writing()
            try:
                with ring.begin_sequence(tblk._byte_header(hdr),
                                         gulp_nframe=published.size,
                                         buf_nframe=2 * published.size) \
                        as oseq:
                    with oseq.reserve(published.size) as ospan:
                        ospan.publish_external(published)
                        ospan.commit(published.size)
            finally:
                ring.end_writing()

    def middle(blk):
        return blk.KurtosisBlock(gulp_size=power.nbytes) \
            if reader == "kurtosis" else blk.CopyBlock()

    out = str(tmp_path / "torch.txt")
    tblk.Pipeline([(Publisher(), [], [0]), (middle(tblk), [0], [1]),
                   (tblk.WriteAsciiBlock(out), [1], [])]).main()
    np.testing.assert_array_equal(published, before)
    jout = str(tmp_path / "jax.txt")
    _run(jblk, [(_sigproc_like_source(jblk, power, hdr), [], [0]),
                (middle(jblk), [0], [1]),
                (jblk.WriteAsciiBlock(jout), [1], [])])
    assert open(out, "rb").read() == open(jout, "rb").read()
