"""The port's PortAudio binding (bifrost_tpu_torch/portaudio.py) and
AudioSourceBlock on the CPU, against the compiled fake device library
tests/fake_portaudio.c: the cases of tests/test_audio.py on the port,
each in an interpreter of its own (the binding keeps the library it
loaded for the process), with its own timeout."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fake_pa_lib(tmp_path_factory):
    src = os.path.join(REPO, "tests", "fake_portaudio.c")
    lib = str(tmp_path_factory.mktemp("torch_fakepa") / "libfakeportaudio.so")
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2", src, "-o", lib],
                   check=True)
    return lib


def _run_in_subprocess(code, lib, extra_env=None):
    """`code` in a fresh interpreter with the fake library named by the
    `portaudio_lib` flag's variable; -> its output."""
    env = dict(os.environ)
    env["BIFROST_TPU_PORTAUDIO_LIB"] = lib
    if extra_env:
        env.update(extra_env)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_stream_read_against_fake_device(fake_pa_lib):
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from bifrost_tpu_torch import portaudio
assert portaudio.available()
assert "fake portaudio" in portaudio.get_version_text()
assert portaudio.get_device_count() == 1
with portaudio.open(mode="r", rate=44100, channels=2, nbits=16,
                    frames_per_buffer=64) as s:
    buf = np.empty((64, 2), np.int16)
    s.readinto(buf)
    # Fake device: sample value == global frame index on every channel.
    assert np.array_equal(buf[:, 0], np.arange(64)), buf[:4]
    assert np.array_equal(buf[:, 0], buf[:, 1])
    s.readinto(buf)
    assert buf[0, 0] == 64  # stream position advances
print("STREAM-OK")
"""
    assert "STREAM-OK" in _run_in_subprocess(code, fake_pa_lib)


def test_audio_source_block_pipeline(fake_pa_lib):
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from bifrost_tpu_torch import blocks
from bifrost_tpu_torch.pipeline import Pipeline
from bifrost_tpu_torch.blocks.testing import gather_sink
chunks, headers = [], []
with Pipeline(device="cpu") as pipe:
    src = blocks.read_audio({{"rate": 44100, "channels": 2, "nbits": 16}},
                            gulp_nframe=128)
    gather_sink(src, chunks, headers)
    pipe.run()
out = np.concatenate(chunks, axis=0)
assert out.shape == (1024, 2), out.shape   # FAKE_PA_TOTAL_FRAMES frames
assert np.array_equal(out[:, 0], np.arange(1024))
hdr = headers[0]
assert hdr["_tensor"]["dtype"] == "i16"
assert hdr["frame_rate"] == 44100
print("AUDIO-BLOCK-OK")
"""
    assert "AUDIO-BLOCK-OK" in _run_in_subprocess(
        code, fake_pa_lib, {"FAKE_PA_TOTAL_FRAMES": "1024"})
    # A mid-stream device overflow is RECOVERABLE: the block keeps
    # streaming (the buffer is still filled), so the output is unchanged.
    assert "AUDIO-BLOCK-OK" in _run_in_subprocess(
        code, fake_pa_lib, {"FAKE_PA_TOTAL_FRAMES": "1024",
                            "FAKE_PA_OVERFLOW_AT": "512"})


def test_missing_library_raises_clearly():
    from bifrost_tpu_torch import portaudio as pa
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from bifrost_tpu_torch import portaudio
try:
    portaudio.open(mode="r")
except portaudio.PortAudioError as e:
    assert "read_wav" in str(e)
    print("GATED-OK")
"""
    env = dict(os.environ)
    # An explicit-but-bad path must fail LOUDLY (CDLL OSError), never
    # fall back to some other library.
    env["BIFROST_TPU_PORTAUDIO_LIB"] = "/nonexistent/libportaudio.so"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode != 0 and "GATED-OK" not in out.stdout
    # The clear not-found message path only exists where no system
    # portaudio resolves.
    env.pop("BIFROST_TPU_PORTAUDIO_LIB")
    if os.environ.get("BIFROST_TPU_PORTAUDIO_LIB") is None and \
            pa.available():
        pytest.skip("a real PortAudio library is installed")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-1500:]
    assert "GATED-OK" in out.stdout
