"""The port's file blocks on the CPU against the JAX package's on the same
seeded streams: serialize/deserialize (the `.bf.json` and `.dat` files
byte for byte, multi-file rotation, with and without ringlets, each
package reading the other's files), binary_write/binary_read, the WAV
codec and blocks, and print_header's text."""

import json
import os

import numpy as np
import pytest

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import blocks as tblocks
from bifrost_tpu import blocks as jblocks
from bifrost_tpu.pipeline import Pipeline as JaxPipeline


def _stream(seed, shape=(40, 6), dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    return rng.integers(-100, 100, shape).astype(dtype)


def _files(path):
    return {p: open(os.path.join(path, p), "rb").read()
            for p in sorted(os.listdir(path))}


def _serialize(pkg, data, out, gulp, ringlets, max_file_size):
    """array_source -> [transpose to (x, time)] -> serialize, in `pkg`."""
    b = tblocks if pkg == "torch" else jblocks
    pipe = bt.Pipeline(device="cpu") if pkg == "torch" else JaxPipeline()
    with pipe:
        src = b.array_source(data, gulp, header={"labels": ["time", "x"]},
                             name="stream")
        if ringlets:
            src = b.transpose(src, ["x", "time"])
        b.serialize(src, path=str(out), max_file_size=max_file_size)
        pipe.run()
    return _files(out)


def _deserialize(pkg, basename, gulp):
    b = tblocks if pkg == "torch" else jblocks
    pipe = bt.Pipeline(device="cpu") if pkg == "torch" else JaxPipeline()
    chunks, headers = [], []
    with pipe:
        b.callback_sink(b.deserialize([basename], gulp),
                        on_sequence=headers.append,
                        on_data=lambda d: chunks.append(np.array(d)))
        pipe.run()
    return chunks, headers


@pytest.mark.parametrize("ringlets", [False, True])
@pytest.mark.parametrize("max_file_size", [0, 5 * 6 * 4, 1 << 30])
def test_serialize_files_are_the_jax_serializers(tmp_path, ringlets,
                                                 max_file_size):
    """The same stream through both serializers: the same file names and
    bytes (one file a ringlet when the frame axis is second, a new set of
    files at each rotation)."""
    data = _stream(1)
    got = {}
    for pkg in ("torch", "jax"):
        out = tmp_path / pkg
        out.mkdir()
        got[pkg] = _serialize(pkg, data, out, 8, ringlets, max_file_size)
    assert got["torch"] == got["jax"]
    nset = len({n.split(".")[2] for n in got["torch"] if n.endswith(".dat")})
    assert (nset > 1) == (max_file_size == 5 * 6 * 4)
    if ringlets:
        assert sum(n.endswith(".dat") for n in got["torch"]) == 6 * nset


@pytest.mark.parametrize("ringlets", [False, True])
@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch")])
def test_deserialize_reads_either_packages_files(tmp_path, ringlets, writer,
                                                 reader):
    """A stream serialized (with rotation) by one package and read back by
    either: every frame and the header as written."""
    data = _stream(2)
    _serialize(writer, data, tmp_path, 8, ringlets, 3 * 6 * 4)
    base = str(tmp_path / "stream.bf")
    chunks, headers = _deserialize(reader, base, 5)
    want = data.T if ringlets else data
    got = np.concatenate(chunks, axis=1 if ringlets else 0)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    with open(base + ".json") as f:
        written = json.load(f)
    assert headers[0]["_tensor"] == written["_tensor"]


def test_serialize_round_trip_ci8_rotation(tmp_path):
    """A complex-integer stream round-trips through the port's serializer
    bit for bit across several files."""
    raw = _stream(3, (64, 4, 2), np.int8)
    with bt.Pipeline(device="cpu") as pipe:
        src = tblocks.array_source(raw, 16, header={"dtype": "ci8",
                                                    "labels": ["time", "x"]},
                                   name="ci")
        tblocks.serialize(src, path=str(tmp_path), max_file_size=200)
        pipe.run()
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".dat")]) > 1
    chunks, headers = _deserialize("torch", str(tmp_path / "ci.bf"), 16)
    assert headers[0]["_tensor"]["dtype"] == "ci8"
    assert np.array_equal(np.concatenate(chunks), raw)


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
def test_binary_write_files_are_the_jax_blocks(tmp_path, dtype):
    """binary_write writes the stream's bytes, as the JAX block does; both
    packages' binary_read read them back."""
    data = _stream(4, (32, 10), dtype)
    files = {}
    for pkg, b in (("torch", tblocks), ("jax", jblocks)):
        name = str(tmp_path / f"{pkg}_stream")
        pipe = bt.Pipeline(device="cpu") if pkg == "torch" \
            else JaxPipeline()
        with pipe:
            b.binary_write(b.array_source(data, 8, name=name),
                           file_ext="bin")
            pipe.run()
        files[pkg] = open(name + ".bin", "rb").read()
    assert files["torch"] == files["jax"] == data.tobytes()
    dt = {np.float32: "f32", np.int16: "i16", np.uint8: "u8"}[dtype]
    for pkg, b in (("torch", tblocks), ("jax", jblocks)):
        pipe = bt.Pipeline(device="cpu") if pkg == "torch" \
            else JaxPipeline()
        chunks = []
        with pipe:
            b.callback_sink(b.binary_read([str(tmp_path / "torch_stream.bin")],
                                          10, 1, dt),
                            on_data=lambda d: chunks.append(np.array(d)))
            pipe.run()
        assert np.array_equal(np.concatenate(chunks).reshape(data.shape),
                              data)


@pytest.mark.parametrize("nchan,dtype", [(1, np.int16), (2, np.int16),
                                         (3, np.uint8)])
def test_write_wav_files_are_the_jax_blocks(tmp_path, nchan, dtype):
    """write_wav's RIFF/WAVE files equal the JAX sink's, byte for byte
    (sizes back-patched at the end); both read_wav blocks read them."""
    data = _stream(5, (300, nchan), dtype)
    lbl = {"labels": ["time", "channel"], "scales": [[0, 1 / 8000.0], None],
           "units": ["s", None]}
    files = {}
    for pkg, b in (("torch", tblocks), ("jax", jblocks)):
        out = tmp_path / pkg
        out.mkdir()
        pipe = bt.Pipeline(device="cpu") if pkg == "torch" \
            else JaxPipeline()
        with pipe:
            b.write_wav(b.array_source(data, 64, header=lbl, name="tone"),
                        path=str(out))
            pipe.run()
        files[pkg] = _files(out)
    assert files["torch"] == files["jax"]
    wav = str(tmp_path / "torch" / "tone.wav")
    for pkg, b in (("torch", tblocks), ("jax", jblocks)):
        pipe = bt.Pipeline(device="cpu") if pkg == "torch" \
            else JaxPipeline()
        chunks, headers = [], []
        with pipe:
            b.callback_sink(b.read_wav([wav], 64),
                            on_sequence=headers.append,
                            on_data=lambda d: chunks.append(np.array(d)))
            pipe.run()
        assert np.array_equal(np.concatenate(chunks), data)
        assert headers[0]["frame_rate"] == 8000


def test_wav_header_codec_matches_the_jax_codec():
    import io as _io
    from bifrost_tpu.blocks import wav as jwav
    from bifrost_tpu_torch.blocks import wav as twav
    hdr = {"audio_fmt": 1, "nchan": 2, "sample_rate": 44100, "nbit": 16}
    a, b = _io.BytesIO(), _io.BytesIO()
    twav.wav_write_header(a, hdr, 36 + 400, 400)
    jwav.wav_write_header(b, hdr, 36 + 400, 400)
    assert a.getvalue() == b.getvalue()
    a.seek(0)
    assert twav.wav_read_header(a) == (dict(hdr, byte_rate=176400,
                                            block_align=4), 400)


def test_print_header_prints_the_jax_text(capsys):
    """print_header prints each sequence header as the JAX block does."""
    data = _stream(6, (16, 3))
    text = {}
    for pkg, b in (("torch", tblocks), ("jax", jblocks)):
        pipe = bt.Pipeline(device="cpu") if pkg == "torch" \
            else JaxPipeline()
        with pipe:
            b.print_header(b.array_source(data, 8, header={
                "labels": ["time", "x"], "note": "same"}, name="hdr"))
            pipe.run()
        text[pkg] = capsys.readouterr().out
    assert text["torch"] == text["jax"] and '"note": "same"' in text["torch"]
