"""The gpuspec slice (GUPPI RAW -> FFT -> Stokes -> reduce -> accumulate ->
SIGPROC) of the port against the JAX package on the CPU.

- The whole chain: a small GUPPI file (4 channels x 256 fine samples x 2
  pol, 12 blocks) written by the port's `io.guppi_raw` goes through the
  JAX testbench chain (testbench/gpuspec_simple.py:88-101) and the port's
  chain built from its `BlockChainer` (unfused, `copy('cuda')` for
  `copy('tpu')`), both ending in `write_sigproc`.  The two `.fil` files
  must have equal headers, and their data agree with each other and with
  `gpuspec_golden` within the testbench's FFT bound,
  32 * eps_f32 * sqrt(nfft) * max|want|.
- The bitwise tier: complex input whose values are small integers
  through detect (three modes), reduce (ten ops, on a non-frame axis and
  on the frame axis), accumulate, fftshift, scrunch and reverse; each
  port block bitwise equal to its JAX block, stderr within 4 eps of its
  largest value.  A `.fil` written by the port's staged SIGPROC sink is
  byte-identical to the JAX sink's.
- I/O: the GUPPI and SIGPROC readers of both packages yield the same
  headers and span bytes on files written by either package.
"""

import os
import sys

import numpy as np
import pytest

import bifrost_tpu as jbf
from bifrost_tpu import blocks as jblocks
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import gather_sink as j_gather_sink
from bifrost_tpu.io import guppi_raw as j_guppi_raw
from bifrost_tpu.io import sigproc as j_sigproc
from bifrost_tpu.pipeline import Pipeline as JaxPipeline

import bifrost_tpu_torch as pbf
from bifrost_tpu_torch import blocks as pblocks
from bifrost_tpu_torch import config as pconfig
from bifrost_tpu_torch.blocks.testing import array_source as p_array_source
from bifrost_tpu_torch.blocks.testing import gather_sink as p_gather_sink
from bifrost_tpu_torch.io import guppi_raw as p_guppi_raw
from bifrost_tpu_torch.io import sigproc as p_sigproc
from bifrost_tpu_torch.pipeline import Pipeline as PortPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "testbench"))
from gpuspec_simple import gpuspec_golden  # noqa: E402

NBLOCK, NCHAN, NTIME, NPOL = 12, 4, 256, 2
F_AVG, N_INT = 4, 3


@pytest.fixture(scope="module", autouse=True)
def _jax_fft_method_default():
    """The JAX references run at the JAX package's default `fft_method`:
    tests/test_fusion.py's latch test sets it from a sink callback, and
    under load a call that lands after the latch is released succeeds and
    stays set in that process ('matmul', 4e-3 off the 'xla' images)."""
    from bifrost_tpu import config as jconfig
    jconfig.reset("fft_method")


def write_guppi(path, io, nblock=NBLOCK, nchan=NCHAN, ntime=NTIME,
                npol=NPOL, seed=0):
    """A GUPPI RAW file of seeded ci8 voltages in [-8, 8), written with
    `io` (either package's guppi_raw codec)."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for b in range(nblock):
            io.write_header(f, {
                "BLOCSIZE": nchan * ntime * npol * 2, "OBSNCHAN": nchan,
                "NPOL": npol, "NBITS": 8, "OBSFREQ": 1420.0,
                "OBSBW": -187.5, "PKTIDX": b * 1000, "PKTSIZE": 8192,
                "STT_IMJD": 58000, "STT_SMJD": 3600, "SRC_NAME": "B0329+54",
                "TELESCOP": "GBT", "RA": 53.25, "DEC": 54.58})
            f.write(rng.integers(-8, 8, nchan * ntime * npol * 2,
                                 dtype=np.int8).tobytes())


def jax_gpuspec(raw, outdir):
    """The JAX testbench chain (testbench/gpuspec_simple.py:88-101)."""
    with JaxPipeline() as pipe:
        bc = jbf.BlockChainer()
        bc.custom(jblocks.read_guppi_raw([raw], gulp_nframe=1))
        with jbf.block_scope(fuse=True):
            bc.blocks.copy("tpu")
            bc.blocks.transpose(["time", "pol", "freq", "fine_time"])
            bc.blocks.fft(axes="fine_time", axis_labels="fine_freq",
                          apply_fftshift=True)
            bc.blocks.detect(mode="stokes")
            bc.views.merge_axes("freq", "fine_freq", label="freq")
            bc.blocks.reduce("freq", F_AVG)
            bc.blocks.accumulate(N_INT)
        bc.blocks.copy("system")
        snk = bc.blocks.write_sigproc(path=outdir)
        pipe.run()
    return snk.filename


def port_gpuspec(raw, outdir, staged_sink=False):
    """The same chain on the port, unfused, from its BlockChainer; with
    `staged_sink` the SIGPROC sink reads the 'cuda' ring itself."""
    with PortPipeline(device="cpu") as pipe:
        bc = pbf.BlockChainer()
        bc.custom(pblocks.read_guppi_raw([raw], gulp_nframe=1))
        bc.blocks.copy("cuda")
        bc.blocks.transpose(["time", "pol", "freq", "fine_time"])
        bc.blocks.fft(axes="fine_time", axis_labels="fine_freq",
                      apply_fftshift=True)
        bc.blocks.detect(mode="stokes")
        bc.views.merge_axes("freq", "fine_freq", label="freq")
        bc.blocks.reduce("freq", F_AVG)
        bc.blocks.accumulate(N_INT)
        if not staged_sink:
            bc.blocks.copy("system")
        snk = bc.blocks.write_sigproc(path=outdir)
        pipe.run()
    return snk


def read_fil(path):
    with p_sigproc.SigprocFile(path) as sf:
        return sf.header, np.array(sf.read(sf.nframe))


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpuspec")
    raw = str(d / "voltages.raw")
    write_guppi(raw, p_guppi_raw)
    os.makedirs(d / "jax")
    os.makedirs(d / "port")
    os.makedirs(d / "staged")
    jfil = jax_gpuspec(raw, str(d / "jax"))
    psnk = port_gpuspec(raw, str(d / "port"))
    ssnk = port_gpuspec(raw, str(d / "staged"), staged_sink=True)
    golden = gpuspec_golden(raw, F_AVG, N_INT)
    return read_fil(jfil), read_fil(psnk.filename), golden, ssnk


def _fft_bound(data, want):
    nfft = data.shape[-1] * F_AVG
    return 32 * np.finfo(np.float32).eps * np.sqrt(nfft) * np.abs(want).max()


def test_chain_headers_equal(chains):
    (jhdr, jdata), (phdr, pdata), _, _ = chains
    assert phdr == jhdr
    assert phdr["nifs"] == 4 and phdr["nchans"] == NCHAN * NTIME // F_AVG
    assert pdata.shape == jdata.shape == (NBLOCK // N_INT, 4,
                                          NCHAN * NTIME // F_AVG)


def test_chain_port_vs_golden(chains):
    _, (_, pdata), golden, _ = chains
    want = golden.reshape(pdata.shape)
    err = np.abs(pdata.astype(np.float64) - want)
    assert np.isfinite(pdata).all()
    assert err.max() <= _fft_bound(pdata, want)


def test_chain_port_vs_jax(chains):
    (_, jdata), (_, pdata), _, _ = chains
    err = np.abs(pdata.astype(np.float64) - jdata.astype(np.float64))
    assert err.max() <= _fft_bound(pdata, jdata)


def test_chain_staged_sink_file_identical(chains):
    """write_sigproc placed on the 'cuda' ring stages every output gulp
    and writes the same bytes as the chain with copy('system')."""
    _, (phdr, pdata), _, ssnk = chains
    shdr, sdata = read_fil(ssnk.filename)
    assert ssnk._egress_staging
    assert ssnk._egress_drained_gulps == NBLOCK // N_INT
    assert shdr == phdr
    assert np.array_equal(sdata.view(np.uint32), pdata.view(np.uint32))


# ------------------------------------------------------- bitwise tier

LABELS = ["time", "pol", "freq"]
NF, NP_, NCH = 8, 2, 16


def _exact_complex(seed=1):
    rng = np.random.default_rng(seed)
    z = rng.integers(-8, 8, (NF, NP_, NCH)) + \
        1j * rng.integers(-8, 8, (NF, NP_, NCH))
    return z.astype(np.complex64)


def _run_jax(data, gulp, build):
    out = []
    with JaxPipeline() as pipe:
        src = j_array_source(data, gulp, header={"labels": LABELS})
        dev = jblocks.copy(src, space="tpu")
        j_gather_sink(build(jblocks, dev), out)
        pipe.run()
    return out


def _run_port(data, gulp, build):
    out = []
    with PortPipeline(device="cpu") as pipe:
        src = p_array_source(data, gulp, header={"labels": LABELS})
        dev = pblocks.copy(src, space="cuda")
        p_gather_sink(build(pblocks, dev), out)
        pipe.run()
    return out


def _compare(data, gulp, build, bitwise=True):
    j = np.concatenate(_run_jax(data, gulp, build))
    p = np.concatenate(_run_port(data, gulp, build))
    if np.iscomplexobj(p) and not np.iscomplexobj(j):
        # stderr of complex input: both headers say cf32, but the JAX
        # 'tpu' ring hands on the real array its op returned; the port's
        # ring holds the header's cf32, imaginary parts zero.
        assert not p.imag.any()
        p = np.ascontiguousarray(p.real)
    assert p.dtype == j.dtype and p.shape == j.shape
    if bitwise:
        assert np.array_equal(p.view(np.uint8), j.view(np.uint8))
    else:
        tol = 4 * np.finfo(np.float32).eps * np.abs(j).max()
        assert np.abs(p - j).max() <= tol
    return p


@pytest.mark.parametrize("mode", ["scalar", "jones", "stokes"])
def test_detect_bitwise(mode):
    p = _compare(_exact_complex(), 4, lambda b, r: b.detect(r, mode))
    assert p.shape[1] == {"scalar": 2, "jones": 2, "stokes": 4}[mode]


REDUCE_CASES = [(op, axis) for op in
                ("sum", "mean", "min", "max", "stderr", "pwrsum",
                 "pwrmean", "pwrmin", "pwrmax", "pwrstderr")
                for axis in ("freq", "time")]


@pytest.mark.parametrize("op,axis", REDUCE_CASES,
                         ids=[f"{o}-{a}" for o, a in REDUCE_CASES])
def test_reduce_bitwise(op, axis):
    factor = 4 if axis == "freq" else 2
    _compare(_exact_complex(REDUCE_CASES.index((op, axis))), 4,
             lambda b, r: b.reduce(r, axis, factor, op=op),
             bitwise=not op.endswith("stderr"))


def test_reduce_real_input_bitwise():
    """A real (f32) stream through the frame-axis mean: the f32
    reciprocal product of the compiled JAX mean, bitwise."""
    data = np.random.default_rng(3).integers(-8, 8, (NF, NP_, NCH)) \
        .astype(np.float32)
    _compare(data, 4, lambda b, r: b.reduce(r, "time", 4, op="mean"))


def test_reduce_op_into_output():
    """`ops.reduce(idata, odata, op)` reduces to its output's shape, as
    the JAX `ops.reduce_to` does, bitwise."""
    import torch

    from bifrost_tpu.ops.reduce import reduce_to as j_reduce_to
    from bifrost_tpu_torch.ops import reduce as p_reduce
    x = _exact_complex(7)
    out = torch.empty((NF // 2, NP_, NCH // 4), dtype=torch.complex64)
    p_reduce(torch.from_numpy(x), out, "mean")
    want = np.asarray(j_reduce_to(x, out.shape, "mean"))
    assert np.array_equal(out.numpy().view(np.uint8), want.view(np.uint8))


def test_accumulate_bitwise():
    data = np.concatenate([_exact_complex(2)] * 2)     # 16 frames
    p = _compare(data, 1, lambda b, r: b.accumulate(r, 3))
    assert p.shape[0] == 5


@pytest.mark.parametrize("name,build", [
    ("fftshift", lambda b, r: b.fftshift(r, "freq")),
    ("ifftshift", lambda b, r: b.fftshift(r, ["pol", "freq"],
                                          inverse=True)),
    ("scrunch", lambda b, r: b.scrunch(r, 2)),
    ("reverse", lambda b, r: b.reverse(r, "freq")),
])
def test_shape_blocks_bitwise(name, build):
    _compare(_exact_complex(4), 4, build)


def test_sigproc_sink_bytes_identical(tmp_path):
    """An f32 (time, pol, freq) stream through the JAX sink and the
    port's staged sink: the same .fil bytes."""
    data = np.random.default_rng(6).standard_normal((20, 4, 32)) \
        .astype(np.float32)
    header = {"labels": ["time", "pol", "freq"],
              "scales": [[1.5e9, 0.25], None, [1420.0, -0.5]],
              "units": ["s", None, "MHz"], "source_name": "J0534+2200",
              "telescope": "GBT"}
    files = {}
    for name, Pipe, ablk, space in (("jax", JaxPipeline, jblocks, "tpu"),
                                    ("port", PortPipeline, pblocks,
                                     "cuda")):
        outdir = tmp_path / name
        outdir.mkdir()
        kw = {"device": "cpu"} if name == "port" else {}
        with Pipe(**kw) as pipe:
            src = ablk.array_source(data, 8, header=header)
            dev = ablk.copy(src, space=space)
            snk = ablk.write_sigproc(dev, path=str(outdir))
            pipe.run()
        files[name] = open(snk.filename, "rb").read()
        if name == "port":
            assert snk._egress_staging and snk._egress_drained_gulps == 3
    assert files["port"] == files["jax"]


# ----------------------------------------------------------------- I/O

def _read_both(reader_j, reader_p, path, **kw):
    out = {}
    for name, Pipe, read, gather in (
            ("jax", JaxPipeline, reader_j, j_gather_sink),
            ("port", PortPipeline, reader_p, p_gather_sink)):
        chunks, headers = [], []
        with Pipe(**({"device": "cpu"} if name == "port" else {})) as pipe:
            gather(read([path], **kw), chunks, headers)
            pipe.run()
        out[name] = (headers, np.concatenate(chunks))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_guppi_reader_parity(tmp_path, writer):
    path = str(tmp_path / "v.raw")
    write_guppi(path, j_guppi_raw if writer == "jax" else p_guppi_raw,
                nblock=3, nchan=3, ntime=32, seed=9)
    out = _read_both(jblocks.read_guppi_raw, pblocks.read_guppi_raw, path,
                     gulp_nframe=1)
    (jh,), jd = out["jax"]
    (ph,), pd = out["port"]
    assert ph == jh
    assert ph["_tensor"]["shape"] == [-1, 3, 32, 2]
    assert jd.dtype.names == ("re", "im")            # JAX host form
    assert pd.dtype == np.int8 and pd.shape == jd.shape + (2,)
    assert pd.tobytes() == jd.tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("nbits", [8, 32])
def test_sigproc_reader_parity(tmp_path, writer, nbits):
    io = j_sigproc if writer == "jax" else p_sigproc
    path = str(tmp_path / "f.fil")
    rng = np.random.default_rng(nbits)
    data = (rng.integers(0, 256, (40, 2, 24)).astype(np.uint8)
            if nbits == 8 else
            rng.standard_normal((40, 2, 24)).astype(np.float32))
    with open(path, "wb") as f:
        io.write_header(f, {
            "telescope_id": 6, "machine_id": 20, "data_type": 1,
            "source_name": "B1937+21", "tstart": 58000.5, "tsamp": 6.4e-5,
            "nbits": nbits, "fch1": 1500.0, "foff": -1.0, "nchans": 24,
            "nifs": 2, "refdm": 71.0, "src_raj": 193939.0,
            "src_dej": 213459.0})
        f.write(data.tobytes())
    out = _read_both(jblocks.read_sigproc, pblocks.read_sigproc, path,
                     gulp_nframe=16)
    (jh,), jd = out["jax"]
    (ph,), pd = out["port"]
    assert ph == jh
    assert pd.dtype == jd.dtype == data.dtype
    assert pd.tobytes() == jd.tobytes() == data.tobytes()


def test_egress_flags_latched_by_gpuspec_sink(tmp_path):
    """The staged sink of the port's chain holds the egress latches for
    its sequence and lets go at its end."""
    raw = str(tmp_path / "v.raw")
    write_guppi(raw, p_guppi_raw, nblock=6, seed=2)
    seen = []

    class Watch(pblocks.SigprocSinkBlock):
        def on_sink_data(self, arr, frame_offset):
            try:
                pconfig.set("pipeline_async_depth", 3)
            except RuntimeError as e:
                seen.append(str(e))
            super().on_sink_data(arr, frame_offset)

    with PortPipeline(device="cpu") as pipe:
        bc = pbf.BlockChainer()
        bc.custom(pblocks.read_guppi_raw([raw], gulp_nframe=1))
        bc.blocks.copy("cuda")
        bc.blocks.transpose(["time", "pol", "freq", "fine_time"])
        bc.blocks.fft(axes="fine_time", axis_labels="fine_freq",
                      apply_fftshift=True)
        bc.blocks.detect(mode="stokes")
        bc.views.merge_axes("freq", "fine_freq", label="freq")
        bc.blocks.reduce("freq", F_AVG)
        bc.custom(Watch)(path=str(tmp_path))
        pipe.run()
    assert len(seen) == 6 and "latched" in seen[0]
    pconfig.set("pipeline_async_depth", 3)
    pconfig.reset("pipeline_async_depth")
