"""PortAudio binding: live audio capture and playback streams over
ctypes (counterpart of bifrost_tpu/portaudio.py; reference
python/bifrost/portaudio.py).  Importing the module needs no library: it
is resolved at first use, in order from the `portaudio_lib` flag
(BIFROST_TPU_PORTAUDIO_LIB, also how the tests point the binding at a
fake device library), ctypes.util.find_library("portaudio"), then the
common sonames.  Where none is found, opening a stream raises
PortAudioError.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

__all__ = ["PortAudioError", "PortAudioOverflow", "Stream", "open",
           "available", "get_device_count", "get_version_text"]

# PaSampleFormat constants (portaudio.h)
paFloat32 = 0x00000001
paInt32 = 0x00000002
paInt24 = 0x00000004
paInt16 = 0x00000008
paInt8 = 0x00000010
paClipOff = 0x00000001
paNoError = 0
paInputOverflowed = -9981

_FORMATS = {8: paInt8, 16: paInt16, 24: paInt24, 32: paInt32}


class PortAudioError(RuntimeError):
    pass


class PortAudioOverflow(PortAudioError):
    """Input frames were dropped by the device since the last read (the
    read buffer is still filled) — recoverable, equivalent to dropped
    packets on a network capture."""


class _PaStreamParameters(ctypes.Structure):
    _fields_ = [("device", ctypes.c_int),
                ("channelCount", ctypes.c_int),
                ("sampleFormat", ctypes.c_ulong),
                ("suggestedLatency", ctypes.c_double),
                ("hostApiSpecificStreamInfo", ctypes.c_void_p)]


class _PaDeviceInfo(ctypes.Structure):
    _fields_ = [("structVersion", ctypes.c_int),
                ("name", ctypes.c_char_p),
                ("hostApi", ctypes.c_int),
                ("maxInputChannels", ctypes.c_int),
                ("maxOutputChannels", ctypes.c_int),
                ("defaultLowInputLatency", ctypes.c_double),
                ("defaultLowOutputLatency", ctypes.c_double),
                ("defaultHighInputLatency", ctypes.c_double),
                ("defaultHighOutputLatency", ctypes.c_double),
                ("defaultSampleRate", ctypes.c_double)]


_lib = None
_lib_lock = threading.Lock()


def _find_library():
    from . import config
    explicit = config.get("portaudio_lib")
    if explicit:
        return explicit
    found = ctypes.util.find_library("portaudio")
    if found:
        return found
    for name in ("libportaudio.so.2", "libportaudio.so"):
        try:
            ctypes.CDLL(name)
            return name
        except OSError:
            continue
    return None


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _find_library()
        if path is None:
            raise PortAudioError(
                "PortAudio shared library not found; install portaudio "
                "or set BIFROST_TPU_PORTAUDIO_LIB (file-based input is "
                "available via blocks.read_wav)")
        lib = ctypes.CDLL(path)
        lib.Pa_GetErrorText.restype = ctypes.c_char_p
        lib.Pa_GetVersionText.restype = ctypes.c_char_p
        lib.Pa_GetDeviceInfo.restype = ctypes.POINTER(_PaDeviceInfo)
        lib.Pa_GetStreamTime.restype = ctypes.c_double
        lib.Pa_OpenStream.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(_PaStreamParameters),
            ctypes.POINTER(_PaStreamParameters),
            ctypes.c_double, ctypes.c_ulong, ctypes.c_ulong,
            ctypes.c_void_p, ctypes.c_void_p]
        err = lib.Pa_Initialize()
        if err != paNoError:
            raise PortAudioError(
                f"Pa_Initialize: {lib.Pa_GetErrorText(err).decode()}")
        _lib = lib
        return _lib


def available():
    """True when a PortAudio library can be resolved (does not init)."""
    return _lib is not None or _find_library() is not None


def _check(err):
    if err == paNoError:
        return
    if err == paInputOverflowed:
        raise PortAudioOverflow(_lib.Pa_GetErrorText(err).decode())
    raise PortAudioError(_lib.Pa_GetErrorText(err).decode())


class Stream(object):
    """A capture ('r'), playback ('w'), or duplex ('r+') PCM stream.

    Matches the reference Stream surface (portaudio.py:141-240): rate,
    channels, nbits, frames_per_buffer, input_device/output_device;
    read/readinto/write move interleaved frames; context manager closes.
    """

    def __init__(self, mode="r", rate=44100, channels=2, nbits=16,
                 frames_per_buffer=1024, input_device=None,
                 output_device=None):
        lib = _load()
        if nbits not in _FORMATS:
            raise ValueError(f"invalid nbits {nbits} (8/16/24/32)")
        self.mode = mode
        self.rate = rate
        self.channels = channels
        self.nbits = nbits
        self.frames_per_buffer = frames_per_buffer
        self.frame_nbyte = nbits // 8 * channels
        use_input = "r" in mode or "+" in mode
        use_output = "w" in mode or "+" in mode
        if input_device is None:
            input_device = lib.Pa_GetDefaultInputDevice()
        if output_device is None:
            output_device = lib.Pa_GetDefaultOutputDevice()
        self.input_device = input_device
        self.output_device = output_device
        fmt = _FORMATS[nbits]

        def params(devix, is_input):
            info = lib.Pa_GetDeviceInfo(devix)
            latency = 0.0
            if info:
                latency = (info.contents.defaultLowInputLatency if is_input
                           else info.contents.defaultLowOutputLatency)
            return _PaStreamParameters(devix, channels, fmt, latency, None)

        iparams = params(input_device, True) if use_input else None
        oparams = params(output_device, False) if use_output else None
        self._stream = ctypes.c_void_p()
        self._lock = threading.Lock()
        # Guards _stream/running for cross-thread abort() vs close();
        # never held across a blocking PortAudio call.
        self._state_lock = threading.Lock()
        self.running = False
        _check(lib.Pa_OpenStream(
            ctypes.byref(self._stream),
            ctypes.byref(iparams) if iparams else None,
            ctypes.byref(oparams) if oparams else None,
            float(rate), frames_per_buffer, paClipOff, None, None))
        self.start()

    def start(self):
        with self._lock:
            if not self.running:
                _check(_lib.Pa_StartStream(self._stream))
                self.running = True

    def stop(self):
        with self._lock:
            if self.running:
                _check(_lib.Pa_StopStream(self._stream))
                self.running = False

    def abort(self):
        """Force-stop from another thread: makes a concurrently blocked
        readinto()/write() return immediately.  Deliberately does NOT
        take the stream lock — the blocked reader holds it, and
        PortAudio permits Pa_AbortStream concurrent with a blocking
        read.  The small _state_lock (never held across a blocking
        PortAudio call) guards the stream pointer against a concurrent
        close() freeing it between check and use.  Errors are ignored
        (this is a shutdown path)."""
        with self._state_lock:
            if self._stream and self.running:
                _lib.Pa_AbortStream(self._stream)
                self.running = False

    def close(self):
        self.stop()
        with self._lock:
            with self._state_lock:
                stream, self._stream = self._stream, None
            if stream:
                _check(_lib.Pa_CloseStream(stream))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def readinto(self, buf):
        """Fill a writable buffer (numpy array, memoryview, bytearray)
        with interleaved frames; returns the buffer."""
        with self._lock:
            mv = memoryview(buf).cast("B")
            if len(mv) % self.frame_nbyte:
                raise ValueError("buffer is not a whole number of frames")
            nframe = len(mv) // self.frame_nbyte
            cbuf = (ctypes.c_byte * len(mv)).from_buffer(mv)
            _check(_lib.Pa_ReadStream(self._stream, cbuf, nframe))
            return buf

    def read(self, nframe):
        buf = bytearray(nframe * self.frame_nbyte)
        self.readinto(buf)
        return bytes(buf)

    def write(self, buf):
        with self._lock:
            mv = memoryview(buf).cast("B")
            if len(mv) % self.frame_nbyte:
                raise ValueError("buffer is not a whole number of frames")
            nframe = len(mv) // self.frame_nbyte
            cbuf = (ctypes.c_byte * len(mv)).from_buffer_copy(mv)
            _check(_lib.Pa_WriteStream(self._stream, cbuf, nframe))
            return buf

    def time(self):
        with self._lock:
            return _lib.Pa_GetStreamTime(self._stream)


def open(*args, **kwargs):  # noqa: A001 — reference API name
    return Stream(*args, **kwargs)


def get_device_count():
    return _load().Pa_GetDeviceCount()


def get_version_text():
    return _load().Pa_GetVersionText().decode()
